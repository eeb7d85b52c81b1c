"""One-token (decode) grouped-query attention against a KV cache.

Port of ``repro.kernels.decode_attention`` (TPU kernel
``decode_attention_kernelcall``,
``src/repro/kernels/decode_attention/kernel.py:59``).  CUDA kernel:
``src/repro_torch/csrc/decode_attention.cu`` (bf16 and float32, head widths
16, 32, 64 and 128, at most 16 query heads per kv head and G * D <= 1024).

The plain version repeats the kernel's arithmetic: ``q * scale`` rounded to
q's dtype, float32 scores, keys at or after ``kv_len`` set to -1e30, an
online softmax over blocks of ``DEFAULT_BK`` keys (the last block may be
ragged), ``p`` rounded to v's dtype before the float32 PV product, and the
output in q's dtype.  As in the JAX kernel, ``kv_len`` is one scalar for
the whole batch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, ptr, stream_handle
from repro_torch.kernels.flash_attention import scale_for

DEFAULT_BK = 512
NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 16
_MAX_GD = 1024
_LAUNCHERS = {torch.float32: "repro_decode_attention_f32", torch.bfloat16: "repro_decode_attention_bf16"}


def decode_attention_plain(q, k, v, kv_len: int, *, bk: int = DEFAULT_BK):
    """q: (B, K, G, D); k, v: (B, T, K, D); keys ``t >= kv_len`` masked.
    Returns (B, K, G, D) in q's dtype."""
    B, K, G, D = q.shape
    T = k.shape[1]
    qs = (q * scale_for(D, q.dtype)).float()  # rounded to q's dtype; exact in float32
    m = torch.full((B, K, G), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, D), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, bk):
        kb, vb = k[:, t0:t0 + bk].float(), v[:, t0:t0 + bk]
        s = torch.einsum("bkgd,btkd->bkgt", qs, kb)
        k_pos = t0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.where(k_pos < kv_len, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention takes q (B,K,G,D), k and v (B,T,K,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, K, G, D = q.shape
    if k.shape[0] != B or k.shape[2] != K or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")


def decode_attention_kernelcall(q, k, v, kv_len: int):
    """q: (B, K, G, D); k, v: (B, T, K, D); ``kv_len`` a scalar.  The kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v)
    kv_len = int(kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")
    B, K, G, D = q.shape
    T = k.shape[1]
    if q.dtype not in _LAUNCHERS:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous q, k and v of one dtype; {name} is "
                             f"{t.dtype}{'' if t.is_contiguous() else ', not contiguous'}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads k and v with 16-byte loads; their storage must be 16-byte aligned")
    if D not in _HEAD_DIMS or G > _MAX_GROUP or G * D > _MAX_GD:
        raise ValueError(f"the CUDA kernel takes head widths {_HEAD_DIMS}, groups <= {_MAX_GROUP} and "
                         f"G * D <= {_MAX_GD}; got D={D}, G={G}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    LIBRARY.call(_LAUNCHERS[q.dtype], ptr(q), ptr(k), ptr(v), ptr(out), B, T, K, G, D, kv_len,
                 scale_for(D, q.dtype), stream_handle(q.device))
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q, k, v, *, kv_len: int | None = None):
    """The model layout: q (B, 1, K, G, D) or (B, K, G, D); k, v (B, T, K,
    D); ``kv_len`` defaults to T.  Returns q's layout."""
    squeeze = q.dim() == 5
    q4 = q[:, 0] if squeeze else q
    out = decode_attention_kernelcall(q4.contiguous(), k, v, k.shape[1] if kv_len is None else kv_len)
    return out[:, None] if squeeze else out
