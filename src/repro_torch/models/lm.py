"""The model interface of ``repro.models.lm`` for the families ported so far
(dense, moe, ssm, hybrid).  A family module exposes::

    param_specs(cfg, max_seq) -> {path: Spec}
    forward(params, batch, cfg) -> (logits, aux)         # teacher-forced
    prefill(params, batch, cfg) -> (logits_last, cache)
    decode_step(params, batch, cache, cfg) -> (logits, cache)
    cache_specs(cfg, batch, seq_len) -> {path: Spec}

Params are float32 masters; the steps cast them to the compute dtype.  A
tensor already of that dtype is not copied, so a caller that casts once
(the serving engine does, when it is built) computes the same numbers as
the reference's per-step ``cast_tree`` without a cast per step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, hybrid, mamba2, moe
from repro_torch.models import params as prm

FAMILIES = {"dense": dense, "moe": moe, "ssm": mamba2, "hybrid": hybrid}

# The ROADMAP item that ports each family not ported yet.
_UNPORTED = dict.fromkeys(("encdec", "vlm"), "A6(c)")


def module(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        item = _UNPORTED.get(cfg.family, "A6(c)")
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP {item})")
    return FAMILIES[cfg.family]


def param_specs(cfg: ModelConfig, max_seq: int = 0) -> dict[str, prm.Spec]:
    return module(cfg).param_specs(cfg, max_seq=max_seq)


def init(seed: int, cfg: ModelConfig, max_seq: int = 0, dtype=torch.float32, device="cuda") -> prm.Params:
    """Fresh float32 masters from ``torch.Generator().manual_seed(seed)``
    (other numbers than ``jax.random``'s; :func:`repro_torch.models.params.
    numpy_params` gives numbers both packages can share)."""
    return prm.init_params(seed, param_specs(cfg, max_seq), dtype, device)


def param_count(cfg: ModelConfig, max_seq: int = 0) -> int:
    return prm.param_count(param_specs(cfg, max_seq))


def active_param_count(cfg: ModelConfig, max_seq: int = 0) -> int:
    """Params touched per token (MoE: only top_k of the routed experts; the
    reference divides by the padded expert count, ``shape[1]``)."""
    total = 0
    for path, s in param_specs(cfg, max_seq).items():
        n = int(np.prod(s.shape))
        if cfg.family == "moe" and "/moe/w" in path:
            n = int(n * cfg.top_k / max(s.shape[1], 1))  # (L, E, ...)
        total += n
    return total


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def forward(params, batch, cfg: ModelConfig):
    """Teacher-forced forward with the mixed-precision cast applied."""
    return module(cfg).forward(prm.cast_tree(params, compute_dtype(cfg)), batch, cfg)


def make_prefill(cfg: ModelConfig):
    def prefill(params, batch):
        return module(cfg).prefill(prm.cast_tree(params, compute_dtype(cfg)), batch, cfg)

    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, batch, cache):
        return module(cfg).decode_step(prm.cast_tree(params, compute_dtype(cfg)), batch, cache, cfg)

    return decode_step
