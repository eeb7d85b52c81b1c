"""Parameter specs: one flat dict of path -> Spec per model.

Parameters are a flat ``dict[str, Tensor]`` under the JAX package's key
names (``"reg/attn/wq"``, ``"embed/page"``, ...), so weights carry across
by name with no renaming.  :func:`init_params` draws from a
``torch.Generator``; its numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Spec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    init: str = "lecun"  # lecun | normal | zeros | ones
    scale: float = 1.0

    def check(self, path: str = "?") -> "Spec":
        if len(self.shape) != len(self.axes):
            raise ValueError(f"{path}: shape {self.shape} vs axes {self.axes}")
        return self


ParamSpecs = dict[str, Spec]
Params = dict[str, torch.Tensor]


def _fan_in(spec: Spec) -> int:
    # For stacked layer params the leading "layers" axes are not fan-in.
    dims = [d for d, a in zip(spec.shape, spec.axes) if a not in ("layers", "experts", "groups", "apps")]
    if len(dims) >= 2:
        return int(np.prod(dims[:-1]))
    return max(dims[0] if dims else 1, 1)


def init_one(gen: torch.Generator, spec: Spec, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "lecun"):
        std = spec.scale if spec.init == "normal" else spec.scale / math.sqrt(_fan_in(spec))
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32)
        return (std * x).to(dtype=dtype, device=device)
    raise ValueError(spec.init)


def init_params(seed: int, specs: ParamSpecs, dtype=torch.float32, device="cuda") -> Params:
    """Fresh parameters from ``torch.Generator().manual_seed(seed)``, drawn
    in sorted key order on the CPU (so every device gets the same numbers)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {path: init_one(gen, specs[path].check(path), dtype, device) for path in sorted(specs)}


def prefix(d: ParamSpecs, pre: str) -> ParamSpecs:
    return {f"{pre}/{k}": v for k, v in d.items()}


def subtree(params: Params, pre: str) -> Params:
    pre = pre + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
