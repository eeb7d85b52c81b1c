"""PyTorch / CUDA port of :mod:`repro` for an NVIDIA H100.

Module paths mirror ``src/repro/`` so each counterpart is easy to find.
The package imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``.  Its entry points (``uvm.runtime.run_ours``, ``manager_for``,
``OversubscriptionManager``) run on the card unless the caller passes
``device="cpu"``.  The hot paths go through hand-written CUDA kernels under
``csrc/`` (see :mod:`repro_torch.kernels`); a CPU tensor takes each
kernel's plain PyTorch version instead.
"""
