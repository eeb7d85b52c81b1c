"""Device selection for the port's entry points.

Float32 matrix products and convolutions run in full float32 (no TF32):
the predictor is held against the JAX package in float32.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; raises for a CUDA device
    on a machine without one (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA device is visible; "
                           f"pass device='cpu' to run on the CPU")
    return dev
