"""Dense Transformer blocks (the predictor's regular and irregular stacks).

Layers are stacked along a leading "layers" axis of every parameter, as in
the JAX package; :func:`block` runs one layer's slice.
"""
from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models.params import Spec, prefix, subtree


def block_specs(cfg, n_layers) -> dict[str, Spec]:
    st = (n_layers,)
    sp = {}
    sp.update(prefix(L.attn_specs(cfg, stack=st), "attn"))
    sp.update(prefix(L.norm_specs(cfg, stack=st), "norm1"))
    sp.update(prefix(L.norm_specs(cfg, stack=st), "norm2"))
    sp.update(prefix(L.mlp_specs(cfg, stack=st), "mlp"))
    return sp


def block(lp, x, cfg, *, positions, causal=True):
    h, kv = L.self_attention(subtree(lp, "attn"), L.apply_norm(lp, "norm1", x, cfg), cfg,
                             positions=positions, causal=causal)
    x = x + h
    h = L.mlp(subtree(lp, "mlp"), L.apply_norm(lp, "norm2", x, cfg), cfg)
    return x + h, kv
