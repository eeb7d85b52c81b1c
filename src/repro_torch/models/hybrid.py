"""Zamba2-style hybrid (zamba2-7b): a Mamba-2 backbone and ONE shared
attention block whose weights are reused at every application (after every
``attn_every`` Mamba-2 layers).  Port of ``repro.models.hybrid``.

Layer layout for num_layers=81, attn_every=6: 13 groups of (6 Mamba-2
layers, then the shared block) and 3 tail Mamba-2 layers.  Each application
of the shared block keeps its own KV cache (the weights are shared, the
cache is not).  As in the reference, the shared block takes the residual
stream directly (no concatenation with the original embedding, no
per-application LoRA adapters).

The Mamba-2 layers are :mod:`repro_torch.models.mamba2`'s blocks (the SSD
through :mod:`repro_torch.kernels.ssd_scan`, once per layer in prefill);
the shared block's attention goes through the flash-attention kernel in
prefill and the decode-attention kernel in every decode step, once per
application (:mod:`repro_torch.models.layers`).  :func:`backbone` loops over
the groups and layers in Python where the reference scans.  The functions
expect params already cast to the compute dtype (:mod:`repro_torch.models.
lm` casts them).  The cache holds the conv tails in the compute dtype, the
SSM states in float32 and the keys and values in bf16, (n_apps, B, S, K,
HD); :func:`decode_step` updates it in place (the reference returns new
arrays).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.params import Spec, prefix, subtree

STATE_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")


def group_layout(cfg) -> tuple[int, int, int]:
    """(n_groups, group_size, n_tail)."""
    g = cfg.attn_every
    n_groups = cfg.num_layers // g
    return n_groups, g, cfg.num_layers - n_groups * g


def param_specs(cfg, max_seq: int = 0) -> dict[str, Spec]:
    mamba2._check_supported(cfg)
    n_groups, g, tail = group_layout(cfg)
    sp = {}
    sp.update(prefix(L.embed_specs(cfg), "embed"))
    sp.update(prefix(mamba2.block_specs(cfg, n_groups * g), "mamba"))
    if tail:
        sp.update(prefix(mamba2.block_specs(cfg, tail), "mamba_tail"))
    # one shared transformer block (unstacked)
    sp.update(prefix(L.attn_specs(cfg), "shared/attn"))
    sp.update(prefix(L.norm_specs(cfg), "shared/norm1"))
    sp.update(prefix(L.norm_specs(cfg), "shared/norm2"))
    sp.update(prefix(L.mlp_specs(cfg), "shared/mlp"))
    sp.update(prefix(L.norm_specs(cfg), "final_norm"))
    return sp


def _layer(blocks, i: int):
    return {k: v[i] for k, v in blocks.items()}


def _mamba_layers(params, cfg):
    """Every Mamba-2 layer's params in order: the groups' layers, then the tail's."""
    n_groups, g, tail = group_layout(cfg)
    main, rest = subtree(params, "mamba"), subtree(params, "mamba_tail")
    return [_layer(main, i) for i in range(n_groups * g)] + [_layer(rest, i) for i in range(tail)]


def _application(i: int, cfg) -> int | None:
    """The application of the shared block that follows Mamba-2 layer ``i``
    (the last of its group), or None."""
    n_groups, g, _ = group_layout(cfg)
    return i // g if i < n_groups * g and i % g == g - 1 else None


def _shared_mlp(shared, x, cfg):
    return x + L.mlp(subtree(shared, "mlp"), L.apply_norm(shared, "norm2", x, cfg), cfg)


def backbone(params, x, cfg, *, collect=False):
    """x: (B, S, D) embeddings.  Returns the final normed activations and,
    with ``collect``, every Mamba-2 layer's (conv tails, final state) and
    every application's (k, v)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    shared = subtree(params, "shared")
    states, kvs = [], []
    for i, lp in enumerate(_mamba_layers(params, cfg)):
        x, st = mamba2.block(lp, x, cfg, collect_state=collect)
        states.append(st)
        if _application(i, cfg) is not None:
            h, kv = L.self_attention(subtree(shared, "attn"), L.apply_norm(shared, "norm1", x, cfg), cfg,
                                     positions=positions)
            x = _shared_mlp(shared, x + h, cfg)
            kvs.append(kv)
    x = L.apply_norm(params, "final_norm", x, cfg)
    return x, ((states, kvs) if collect else None)


def hidden(params, batch, cfg):
    x = L.embed(subtree(params, "embed"), batch["tokens"], cfg)
    x, _ = backbone(params, x, cfg)
    return x, {}


def forward(params, batch, cfg):
    x, aux = hidden(params, batch, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), aux


def prefill(params, batch, cfg):
    """Returns the last position's logits and the cache: the stacked (L,
    ...) conv tails in the compute dtype, the SSM states in float32 and the
    (n_apps, B, S, K, HD) keys and values in bf16."""
    x = L.embed(subtree(params, "embed"), batch["tokens"], cfg)
    x, (states, kvs) = backbone(params, x, cfg, collect=True)
    logits = L.unembed(subtree(params, "embed"), x[:, -1:], cfg)
    cx, cb, cc, ssm = (torch.stack(s) for s in zip(*states))
    ks, vs = zip(*kvs)
    return logits, {"conv_x": cx, "conv_b": cb, "conv_c": cc, "ssm": ssm.float(),
                    "k": torch.stack(ks).to(torch.bfloat16), "v": torch.stack(vs).to(torch.bfloat16)}


def decode_step(params, batch, cache, cfg):
    """One token. batch: {token: (B,), pos: int}.  Updates every layer's
    conv tails and state and writes each application's K/V into ``cache``
    in place; returns (logits, cache)."""
    token, pos = batch["token"], int(batch["pos"])
    x = L.embed(subtree(params, "embed"), token[:, None], cfg)
    shared = subtree(params, "shared")
    for i, lp in enumerate(_mamba_layers(params, cfg)):
        x = x + mamba2.mixer_decode(subtree(lp, "mixer"), L.apply_norm(lp, "norm", x, cfg), cfg,
                                    conv_x=cache["conv_x"][i], conv_b=cache["conv_b"][i],
                                    conv_c=cache["conv_c"][i], ssm_state=cache["ssm"][i])
        a = _application(i, cfg)
        if a is not None:
            h, _ = L.decode_self_attention(subtree(shared, "attn"), L.apply_norm(shared, "norm1", x, cfg), cfg,
                                           cache_k=cache["k"][a], cache_v=cache["v"][a], pos=pos)
            x = _shared_mlp(shared, x + h, cfg)
    x = L.apply_norm(params, "final_norm", x, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), cache


def cache_specs(cfg, batch: int, seq_len: int) -> dict[str, Spec]:
    n_groups, _, _ = group_layout(cfg)
    sp = mamba2.cache_specs(cfg, batch, seq_len)
    shp = (n_groups, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("apps", "batch", "kv_seq", "kv_heads", None)
    sp["k"] = Spec(shp, axes, "zeros")
    sp["v"] = Spec(shp, axes, "zeros")
    return sp
