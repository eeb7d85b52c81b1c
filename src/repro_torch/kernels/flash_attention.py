"""Grouped-query attention forward (causal + ``q_offset`` + scalar ``kv_len``).

Port of ``repro.kernels.flash_attention`` (TPU kernel ``_fa_kernel``,
``src/repro/kernels/flash_attention/kernel.py:28``).  CUDA kernel:
``src/repro_torch/csrc/flash_attention.cu`` (float32, head widths 8, 16,
32, 64 and 128).

The plain version is the JAX package's ``_attend_chunked``: an online
softmax over KV chunks of ``ATTN_KV_CHUNK`` keys, in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, ptr, stream_handle

# KV-chunk size of the plain version's online-softmax loop.
ATTN_KV_CHUNK = 1024
_HEAD_DIMS = (8, 16, 32, 64, 128)
_MAX_GROUP = 128


def attend_chunked(q, k, v, *, q_offset=0, causal=True, kv_len=None, kv_chunk=ATTN_KV_CHUNK):
    """Online-softmax attention over KV chunks (the plain version).

    q: (B, S, K, G, D) grouped query; k, v: (B, T, K, D); ``q_offset`` the
    absolute position of q[:, 0]; ``kv_len`` an optional valid KV prefix.
    Returns (B, S, K, G, D).
    """
    B, S, K, G, D = q.shape
    T = k.shape[1]
    qf = q * D ** -0.5
    nchunk = max(T // kv_chunk, 1)
    kv_chunk = T // nchunk
    kc = k.reshape(B, nchunk, kv_chunk, K, D)
    vc = v.reshape(B, nchunk, kv_chunk, K, D)
    q_pos = q_offset + torch.arange(S, device=q.device)
    acc = torch.zeros((B, K, G, S, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, K, G, S), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    for c in range(nchunk):
        s = torch.einsum("bskgd,bckd->bkgsc", qf, kc[:, c]).float()
        k_pos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
        mask = torch.ones((S, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if kv_len is not None:
            mask = mask & (k_pos[None, :] < kv_len)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.to(q.dtype), vc[:, c]).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B,S,K,G,D), k and v (B,T,K,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, K, G, D = q.shape
    if k.shape[0] != B or k.shape[2] != K or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, *, causal=True, q_offset: int = 0, kv_len: int | None = None):
    """q: (B,S,K,G,D); k, v: (B,T,K,D); returns (B,S,K,G,D).  The kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attend_chunked(q, k, v, q_offset=q_offset, causal=causal, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    B, S, K, G, D = q.shape
    T = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous float32 tensors; {name} is {t.dtype}")
    if D not in _HEAD_DIMS or G > _MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes head widths {_HEAD_DIMS} and groups <= {_MAX_GROUP}; "
                         f"got D={D}, G={G}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    LIBRARY.call("repro_flash_attention_f32", ptr(q), ptr(k), ptr(v), ptr(out), B, S, T, K, G, D,
                 int(causal), int(q_offset), T if kv_len is None else int(kv_len), D ** -0.5,
                 stream_handle(q.device))
    LAUNCHES["flash_attention"] += 1
    return out
