"""Dense Transformer blocks (the predictor's regular and irregular stacks)
and the dense decoder-only LM family (qwen2, qwen3 with its ``qk_norm``).

Layers are stacked along a leading "layers" axis of every parameter, as in
the JAX package; :func:`block` runs one layer's slice (:func:`block_many`
runs it for many lanes with one attention core), and the LM's
:func:`backbone` and :func:`decode_step` loop over the layers in Python
where the reference scans.  The LM functions expect params already cast to
the compute dtype (:mod:`repro_torch.models.lm` casts them).  The KV cache
is bf16; its int8 variant is not ported yet and raises.
"""
from __future__ import annotations

import torch

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


def block_many(lps, xs, cfg, *, positions, causal=True):
    """:func:`block` for many lanes, each with its own layer params
    ``lps[i]`` and input ``xs[i]``; the lanes share one attention core
    (:func:`repro_torch.models.layers.self_attention_many`).  Returns one
    ``(x, (k, v))`` per lane."""
    att = L.self_attention_many([subtree(lp, "attn") for lp in lps],
                                [L.apply_norm(lp, "norm1", x, cfg) for lp, x in zip(lps, xs)], cfg,
                                positions=positions, causal=causal)
    out = []
    for lp, x, (h, kv) in zip(lps, xs, att):
        x = x + h
        h = L.mlp(subtree(lp, "mlp"), L.apply_norm(lp, "norm2", x, cfg), cfg)
        out.append((x + h, kv))
    return out


def block(lp, x, cfg, *, positions, causal=True):
    return block_many([lp], [x], cfg, positions=positions, causal=causal)[0]


def _check_supported(cfg) -> None:
    unported = {"norm": (cfg.norm, "rms"), "act": (cfg.act, "swiglu"), "kv_quant": (cfg.kv_quant, "none")}
    for name, (got, ported) in unported.items():
        if got != ported:
            raise NotImplementedError(f"{cfg.name}: {name}={got!r} is not ported yet (the port runs {name}={ported!r})")


def param_specs(cfg, max_seq: int = 0) -> dict[str, Spec]:
    _check_supported(cfg)
    sp = {}
    sp.update(prefix(L.embed_specs(cfg), "embed"))
    sp.update(prefix(block_specs(cfg, cfg.num_layers), "blocks"))
    sp.update(prefix(L.norm_specs(cfg), "final_norm"))
    return sp


def _layer(blocks, i: int):
    return {k: v[i] for k, v in blocks.items()}


def decode_block(lp, x, cfg, *, cache_k, cache_v, pos: int):
    h, kv = L.decode_self_attention(subtree(lp, "attn"), L.apply_norm(lp, "norm1", x, cfg), cfg,
                                    cache_k=cache_k, cache_v=cache_v, pos=pos)
    x = x + h
    h = L.mlp(subtree(lp, "mlp"), L.apply_norm(lp, "norm2", x, cfg), cfg)
    return x + h, kv


def backbone(params, x, cfg, *, positions, causal=True, collect_kv=False):
    """Run the stacked blocks. x: (B, S, D) embeddings.  Returns the final
    normed activations and, with ``collect_kv``, the stacked (L, B, S, K,
    HD) keys and values."""
    _check_supported(cfg)
    blocks = subtree(params, "blocks")
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = block(_layer(blocks, i), x, cfg, positions=positions, causal=causal)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(params, "final_norm", x, cfg)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def hidden(params, batch, cfg):
    tokens = batch["tokens"]
    x = L.embed(subtree(params, "embed"), tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x, _ = backbone(params, x, cfg, positions=positions)
    return x, {}


def forward(params, batch, cfg):
    x, aux = hidden(params, batch, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), aux


def build_cache(kvs, cfg):
    """Stacked (L, B, S, K, HD) K/V -> a bf16 cache dict."""
    return {"k": kvs[0].to(torch.bfloat16), "v": kvs[1].to(torch.bfloat16)}


def prefill(params, batch, cfg):
    tokens = batch["tokens"]
    x = L.embed(subtree(params, "embed"), tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x, kvs = backbone(params, x, cfg, positions=positions, collect_kv=True)
    logits = L.unembed(subtree(params, "embed"), x[:, -1:], cfg)
    return logits, build_cache(kvs, cfg)


def decode_step(params, batch, cache, cfg):
    """One token. batch: {token: (B,), pos: int}.  Writes the token's K/V
    into ``cache`` in place and returns (logits, cache)."""
    _check_supported(cfg)
    token, pos = batch["token"], int(batch["pos"])
    x = L.embed(subtree(params, "embed"), token[:, None], cfg)
    blocks = subtree(params, "blocks")
    for i in range(cfg.num_layers):
        x, _ = decode_block(_layer(blocks, i), x, cfg, cache_k=cache["k"][i], cache_v=cache["v"][i], pos=pos)
    x = L.apply_norm(params, "final_norm", x, cfg)
    return L.unembed(subtree(params, "embed"), x, cfg), cache


def cache_specs(cfg, batch: int, seq_len: int) -> dict[str, Spec]:
    _check_supported(cfg)
    shp = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": Spec(shp, axes, "zeros"), "v": Spec(shp, axes, "zeros")}
