"""Thrashing-aware incremental page predictor (Section IV-B, Fig. 8).

Two Transformer blocks learn complementary views of the access stream:
  * REGULAR block: page-address + page-delta embeddings (strides, reuse)
  * IRREGULAR block: PC + thread-block-ID embeddings (pointer chase, etc.)
Each block's last-position output is scaled by a learnable gate; the concat
goes through a linear layer into a LUCIR cosine classifier over delta
classes.  Parameter names and layouts are the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.predictor_paper import BlockConfig, PredictorConfig
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.params import Spec, init_params, prefix, subtree


def _block_cfg(cfg: PredictorConfig) -> BlockConfig:
    return BlockConfig(
        num_layers=cfg.num_layers,
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_heads,
        d_ff=cfg.d_ff,
        head_dim=cfg.d_model // cfg.num_heads,
    )


def param_specs(cfg: PredictorConfig) -> dict[str, Spec]:
    d = cfg.d_model
    bc = _block_cfg(cfg)
    sp: dict[str, Spec] = {
        "embed/page": Spec((cfg.page_vocab, d), (None, None), "normal", 0.02),
        "embed/delta": Spec((cfg.delta_vocab, d), (None, None), "normal", 0.02),
        "embed/pc": Spec((cfg.pc_vocab, d), (None, None), "normal", 0.02),
        "embed/tb": Spec((cfg.tb_vocab, d), (None, None), "normal", 0.02),
        "pos": Spec((cfg.history, d), (None, None), "normal", 0.01),
        "gate/reg": Spec((), (), "ones"),
        "gate/irr": Spec((), (), "ones"),
        "head/proj": Spec((2 * d, d), (None, None)),
        "head/classes": Spec((cfg.delta_vocab, d), (None, None), "normal", 0.02),
    }
    sp.update(prefix(dense.block_specs(bc, cfg.num_layers), "reg"))
    sp.update(prefix(dense.block_specs(bc, cfg.num_layers), "irr"))
    sp.update(prefix(L.norm_specs(bc), "reg_final"))
    sp.update(prefix(L.norm_specs(bc), "irr_final"))
    return sp


def init(seed: int, cfg: PredictorConfig, device="cuda", dtype=torch.float32):
    return init_params(seed, param_specs(cfg), dtype, device)


def _run_block(params, pre, x, cfg: PredictorConfig):
    bc = _block_cfg(cfg)
    positions = torch.arange(cfg.history, dtype=torch.int32, device=x.device)
    stack = subtree(params, pre)
    for layer in range(cfg.num_layers):
        x, _ = dense.block({k: v[layer] for k, v in stack.items()}, x, bc, positions=positions)
    return L.apply_norm(params, f"{pre}_final", x, bc)


def features(params, batch, cfg: PredictorConfig):
    """batch: {page, delta, pc, tb} each (B, T) int. Returns (B, d) fp32."""
    pos = params["pos"][None]
    reg_x = F.embedding(batch["page"], params["embed/page"]) + F.embedding(batch["delta"], params["embed/delta"]) + pos
    irr_x = F.embedding(batch["pc"], params["embed/pc"]) + F.embedding(batch["tb"], params["embed/tb"]) + pos
    reg_f = _run_block(params, "reg", reg_x, cfg)[:, -1]
    irr_f = _run_block(params, "irr", irr_x, cfg)[:, -1]
    f = torch.cat([params["gate/reg"] * reg_f, params["gate/irr"] * irr_f], dim=-1)
    return (f @ params["head/proj"]).float()


def cosine_logits(params, f, cfg: PredictorConfig):
    """LUCIR cosine classifier: scale * cos(feature, class weight)."""
    fn = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
    w = params["head/classes"].float()
    wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-8)
    return cfg.cosine_scale * (fn @ wn.T)


def forward(params, batch, cfg: PredictorConfig):
    f = features(params, batch, cfg)
    return cosine_logits(params, f, cfg), f


def mask_inactive(logits, n_active: int):
    """Classes at or past ``n_active`` (not yet in the vocabulary) score -1e30."""
    inactive = torch.arange(logits.shape[-1], device=logits.device) >= n_active
    return torch.where(inactive, torch.full_like(logits, -1e30), logits)


def predict_topk(params, batch, cfg: PredictorConfig, k: int = 1, n_active: int | None = None):
    logits, _ = forward(params, batch, cfg)
    if n_active is not None:
        logits = mask_inactive(logits, n_active)
    return torch.topk(logits, k)


def param_count(cfg: PredictorConfig) -> int:
    return int(sum(np.prod(s.shape) for s in param_specs(cfg).values()))
