"""Parameter specs: one flat dict of path -> Spec per model.

Parameters are a flat ``dict[str, Tensor]`` under the JAX package's key
names (``"reg/attn/wq"``, ``"embed/page"``, ...), so weights carry across
by name with no renaming.  :func:`init_params_jax` draws the JAX package's
own initial weights (``init_params(jax.random.key(seed), specs)``) through
:mod:`repro_torch.random`; :func:`init_params` draws from a
``torch.Generator``, whose numbers differ from ``jax.random``'s.
:func:`numpy_params` draws from ``np.random.default_rng``, so the JAX
package and the port can be handed the same numbers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jrandom
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


def _std(spec: Spec) -> float:
    """Standard deviation of a ``normal`` or ``lecun`` initialiser."""
    if spec.init not in ("normal", "lecun"):
        raise ValueError(spec.init)
    return spec.scale if spec.init == "normal" else spec.scale / math.sqrt(_fan_in(spec))


def init_one(gen: torch.Generator, spec: Spec, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32)
    return (_std(spec) * x).to(dtype=dtype, device=device)


def init_params(seed: int, specs: ParamSpecs, dtype=torch.float32, device="cuda") -> Params:
    """Fresh parameters from ``torch.Generator().manual_seed(seed)``, drawn
    in sorted key order on the CPU (so every device gets the same numbers)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {path: init_one(gen, specs[path].check(path), dtype, device) for path in sorted(specs)}


def init_params_jax(seed: int, specs: ParamSpecs, dtype=torch.float32, device="cuda") -> Params:
    """The JAX package's ``init_params(jax.random.key(seed), specs)``: one
    ``split`` of the key over the specs in sorted-name order, each drawn by
    its initialiser (``normal``/``lecun``: the float32 std times
    ``jax.random.normal``).  Drawn on the host, then moved to ``device``."""
    device = resolve_device(device)
    keys = jrandom.split(jrandom.key(seed), len(specs))
    out = {}
    for k, path in zip(keys, sorted(specs)):
        spec = specs[path].check(path)
        if spec.init == "zeros":
            x = torch.zeros(spec.shape, dtype=torch.float32)
        elif spec.init == "ones":
            x = torch.ones(spec.shape, dtype=torch.float32)
        else:
            x = torch.tensor(_std(spec), dtype=torch.float32) * jrandom.normal(k, spec.shape)
        out[path] = x.to(dtype=dtype, device=device)
    return out


def numpy_params(specs: ParamSpecs, seed: int) -> dict[str, np.ndarray]:
    """Float32 numpy arrays for ``specs``, drawn from
    ``np.random.default_rng(seed)`` in sorted key order (the same
    initialisers as :func:`init_one`).  Feed them to either package."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(specs):
        spec = specs[path].check(path)
        if spec.init == "zeros":
            out[path] = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            out[path] = np.ones(spec.shape, np.float32)
        else:
            out[path] = rng.standard_normal(spec.shape, dtype=np.float32) * np.float32(_std(spec))
    return out


def param_count(specs: ParamSpecs) -> int:
    return int(sum(np.prod(s.shape) for s in specs.values()))


def cast_tree(params: Params, dtype=torch.bfloat16) -> Params:
    """Mixed precision: floating tensors cast to the compute dtype (a tensor
    already of that dtype is returned as it is, uncopied)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def prefix(d: ParamSpecs, pre: str) -> ParamSpecs:
    return {f"{pre}/{k}": v for k, v in d.items()}


def subtree(params: Params, pre: str) -> Params:
    pre = pre + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
