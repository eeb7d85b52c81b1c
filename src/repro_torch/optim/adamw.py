"""AdamW optimizer state (the update itself is queued with the training
slice in ROADMAP.md).

``OptState`` mirrors the parameter dict with float32 first and second
moments, like the JAX package's, so a pretrain memo's optimizer state maps
onto it field for field.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class OptState(NamedTuple):
    m: dict
    v: dict


def init(params: dict) -> OptState:
    """Zero moments shaped like ``params`` (on the params' devices)."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
    return OptState(m=zeros, v={k: z.clone() for k, z in zeros.items()})
