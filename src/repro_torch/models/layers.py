"""Transformer layers of the predictor and the dense LM: rms norm, rotary
embeddings, grouped-query self attention (with optional qkv bias and a
one-token decode step against a cache), the swiglu MLP and tied or untied
embeddings.  Plain functions over flat param dicts, in the JAX package's
layouts (q (B,S,H,D), k/v (B,T,K,D)).

:func:`attention_core` goes through the kernel wrappers, as the JAX
package's ``use_pallas()`` branches do: a query of one token through
:mod:`repro_torch.kernels.decode_attention`, a longer one through
:mod:`repro_torch.kernels.flash_attention`.  Each wrapper launches its CUDA
kernel for CUDA tensors and computes its plain version for CPU tensors.
The JAX package's sharding constraints are no-ops on one card and are left
out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.params import Spec

_attend_chunked = fa.attend_chunked


def rms_norm(x, scale, eps=1e-5):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def apply_norm(params, pre, x, cfg):
    return rms_norm(x, params[f"{pre}/scale"], cfg.norm_eps)


def norm_specs(cfg, d=None, stack=()) -> dict[str, Spec]:
    d = d or cfg.d_model
    stack_axes = tuple("layers" for _ in stack)
    return {"scale": Spec(stack + (d,), stack_axes + (None,), "ones")}


def rope(x, positions, theta):
    """x: (B, S, H, D); positions: (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions[..., None].float() * freqs  # (S, D/2)
    ang = ang[None, :, None, :]  # (1, S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_core(q, k, v, *, causal, q_offset=0, kv_len=None):
    """q: (B,S,H,D); k,v: (B,T,K,D). Grouped-query attention.

    k and v are cast to q's dtype first: a no-op in bf16, and in float32
    the bf16 decode cache widens exactly, as the reference's float32 dot
    promotes it.  One query token ignores ``causal`` and ``q_offset``, as
    the reference's decode paths do (``kv_len`` bounds the keys)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D).contiguous()
    k, v = k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous()
    if S == 1:
        out = da.decode_attention(qg, k, v, kv_len=kv_len)
    else:
        out = fa.flash_attention(qg, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    return out.reshape(B, S, H, D)


def attn_specs(cfg, stack=()) -> dict[str, Spec]:
    st = tuple("layers" for _ in stack)
    D, H, K, HD = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sp = {
        "wq": Spec(stack + (D, H, HD), st + ("embed", "heads", None)),
        "wk": Spec(stack + (D, K, HD), st + ("embed", "kv_heads", None)),
        "wv": Spec(stack + (D, K, HD), st + ("embed", "kv_heads", None)),
        "wo": Spec(stack + (H, HD, D), st + ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = Spec(stack + (H, HD), st + ("heads", None), "zeros")
        sp["bk"] = Spec(stack + (K, HD), st + ("kv_heads", None), "zeros")
        sp["bv"] = Spec(stack + (K, HD), st + ("kv_heads", None), "zeros")
    return sp


def _project_qkv(p, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.pos == "rope" and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention_many(ps, xs, cfg, *, positions, causal=True):
    """:func:`self_attention` for many lanes, each with its own params
    ``ps[i]`` and input ``xs[i]``: every lane's projections are its own calls
    on its own tensors, and one :func:`attention_core` covers all lanes, on
    their q, k and v concatenated along the batch dimension (rows of
    different lanes never mix in it).  One lane is not concatenated.
    Returns one ``(out, (k, v))`` per lane."""
    qkv = [_project_qkv(p, x, cfg, positions) for p, x in zip(ps, xs)]
    if len(qkv) == 1:
        att = [attention_core(*qkv[0], causal=causal)]
    else:
        att = attention_core(*map(torch.cat, zip(*qkv)), causal=causal).split([x.shape[0] for x in xs])
    return [(torch.einsum("bshk,hkd->bsd", a, p["wo"]), (k, v)) for p, a, (_, k, v) in zip(ps, att, qkv)]


def self_attention(p, x, cfg, *, positions, causal=True):
    """Full-sequence self attention. Returns (out, (k, v))."""
    return self_attention_many([p], [x], cfg, positions=positions, causal=causal)[0]


def decode_self_attention(p, x, cfg, *, cache_k, cache_v, pos: int):
    """One-token self attention against a cache. x: (B, 1, D); cache_k,
    cache_v: (B, T, K, HD).  The new token's k and v are written into the
    cache in place at ``pos`` (the reference returns an updated copy,
    ``dynamic_update_slice``); returns (out, (cache_k, cache_v))."""
    q, k, v = _project_qkv(p, x, cfg, torch.full((1,), pos, dtype=torch.int32, device=x.device))
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    out = attention_core(q, cache_k, cache_v, causal=False, kv_len=pos + 1)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, (cache_k, cache_v)


def mlp_specs(cfg, stack=(), d_ff=None) -> dict[str, Spec]:
    st = tuple("layers" for _ in stack)
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": Spec(stack + (D, Fd), st + ("embed", "ff")),
        "wu": Spec(stack + (D, Fd), st + ("embed", "ff")),
        "wd": Spec(stack + (Fd, D), st + ("ff", "embed")),
    }


def mlp(p, x, cfg):
    """The swiglu MLP."""
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def embed_specs(cfg) -> dict[str, Spec]:
    V, D = cfg.padded_vocab, cfg.d_model
    sp = {"embedding": Spec((V, D), ("vocab", "embed"), "normal", 0.02)}
    if not cfg.tie_embeddings:
        sp["unembed"] = Spec((D, V), ("embed", "vocab"))
    return sp


def embed(params, tokens, cfg):
    # params arrive cast to the compute dtype (lm's step builders)
    return F.embedding(tokens, params["embedding"])


def unembed(params, x, cfg):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embedding"].to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, params["unembed"].to(x.dtype))
