"""Transformer layers of the predictor: rms norm, rotary embeddings,
grouped-query self attention and the swiglu MLP.  Plain functions over flat
param dicts, in the JAX package's layouts (q (B,S,H,D), k/v (B,T,K,D)).

:func:`attention_core` goes through the :mod:`repro_torch.kernels.
flash_attention` wrapper: its CUDA kernel for CUDA tensors, whatever the
sequence length, and :func:`_attend_chunked` (the plain version) for CPU
tensors.  The JAX package's sharding constraints are no-ops on one card and
are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    """q: (B,S,H,D); k,v: (B,T,K,D). Grouped-query attention."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D).contiguous()
    out = fa.flash_attention(qg, k.contiguous(), v.contiguous(), causal=causal, q_offset=q_offset, kv_len=kv_len)
    return out.reshape(B, S, H, D)


def attn_specs(cfg, stack=()) -> dict[str, Spec]:
    st = tuple("layers" for _ in stack)
    D, H, K, HD = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": Spec(stack + (D, H, HD), st + ("embed", "heads", None)),
        "wk": Spec(stack + (D, K, HD), st + ("embed", "kv_heads", None)),
        "wv": Spec(stack + (D, K, HD), st + ("embed", "kv_heads", None)),
        "wo": Spec(stack + (H, HD, D), st + ("heads", None, "embed")),
    }


def _project_qkv(p, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(p, x, cfg, *, positions, causal=True):
    """Full-sequence self attention. Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attention_core(q, k, v, causal=causal)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, (k, v)


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
