"""`repro_torch.uvm.api` — the declarative experiment specs (port of
``repro.uvm.api``; only the QoS specs so far)."""
