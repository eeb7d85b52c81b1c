"""Port of ``repro.uvm``."""
