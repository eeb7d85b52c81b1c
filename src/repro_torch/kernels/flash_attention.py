"""Grouped-query attention (causal + ``q_offset`` + scalar ``kv_len``),
forward and, in float32, backward.

Port of ``repro.kernels.flash_attention`` (TPU kernel ``_fa_kernel``,
``src/repro/kernels/flash_attention/kernel.py:28``).  CUDA kernels:
``src/repro_torch/csrc/flash_attention.cu`` (the float32 forward, head
widths 8, 16, 32, 64 and 128), ``src/repro_torch/csrc/
flash_attention_bf16.cu`` (the bf16 forward on the tensor cores, head
widths 16, 32, 64 and 128) and ``src/repro_torch/csrc/
flash_attention_bwd.cu`` (the float32 backward: dQ, dK and dV).

The plain version is the JAX package's ``_attend_chunked``: an online
softmax over KV chunks of ``ATTN_KV_CHUNK`` keys with its rounding points:
``q * scale`` in q's dtype, float32 scores, softmax and accumulator, ``p``
cast to q's dtype before the PV product, the output in q's dtype.  Its
gradient is autograd's through it (:func:`attention_grads_plain`), which is
what the JAX trainer differentiates.

On CUDA tensors that need a gradient, :func:`flash_attention` is an
autograd function: the forward kernel, then the backward kernel (float32
only; bf16 with a gradient raises).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, ptr, stream_handle

# KV-chunk size of the plain version's online-softmax loop.
ATTN_KV_CHUNK = 1024
_MAX_GROUP = 128
# head widths the kernels are built for, per element type
_HEAD_WIDTHS = {torch.float32: (8, 16, 32, 64, 128), torch.bfloat16: (16, 32, 64, 128)}
_HEAD_DIMS = _HEAD_WIDTHS[torch.float32]  # the float32 forward's and backward's
# the backward kernel holds a head's whole problem in shared memory: q and
# dO rows (S * G), k and v rows (T) and two (S * G, T) tiles, float32
BWD_SMEM_BYTES = 232448


@functools.lru_cache(maxsize=None)
def scale_for(D: int, dtype: torch.dtype) -> float:
    """``D ** -0.5`` rounded to ``dtype``: the reference multiplies q by the
    Python float, which JAX's weak typing first rounds to q's dtype."""
    return float(torch.tensor(D ** -0.5, dtype=dtype))


def attend_chunked(q, k, v, *, q_offset=0, causal=True, kv_len=None, kv_chunk=ATTN_KV_CHUNK):
    """Online-softmax attention over KV chunks (the plain version).

    q: (B, S, K, G, D) grouped query; k, v: (B, T, K, D); ``q_offset`` the
    absolute position of q[:, 0]; ``kv_len`` an optional valid KV prefix.
    Returns (B, S, K, G, D).
    """
    B, S, K, G, D = q.shape
    T = k.shape[1]
    qf = (q * scale_for(D, q.dtype)).float()  # rounded to q's dtype; exact in float32
    nchunk = max(T // kv_chunk, 1)
    kv_chunk = T // nchunk
    kc = k.reshape(B, nchunk, kv_chunk, K, D)
    vc = v.reshape(B, nchunk, kv_chunk, K, D)
    q_pos = q_offset + torch.arange(S, device=q.device)
    acc = torch.zeros((B, K, G, S, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, K, G, S), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    for c in range(nchunk):
        s = torch.einsum("bskgd,bckd->bkgsc", qf, kc[:, c].float())
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
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.to(q.dtype).float(), vc[:, c].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _check(q, k, v) -> None:
    qs, ks = q.shape, k.shape
    if len(qs) != 5 or len(ks) != 4 or v.shape != ks:
        raise ValueError(f"flash_attention takes q (B,S,K,G,D), k and v (B,T,K,D); got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    if ks[0] != qs[0] or ks[2] != qs[2] or ks[3] != qs[4]:
        raise ValueError(f"q {tuple(qs)} and k {tuple(ks)} disagree")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")


class _ShapeArgs(ctypes.Structure):
    """The float32 kernels' shape arguments (``FaArgs`` in
    ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``)."""

    _fields_ = [(name, ctypes.c_int) for name in ("B", "S", "T", "K", "G", "D", "causal", "q_offset", "kv_len")] + [
        ("scale", ctypes.c_float)]


# (q.shape, T, causal, q_offset, kv_len) -> (_ShapeArgs, its address), for
# float32 shapes whose head width and group the kernels take
_SHAPE_ARGS: dict = {}
_MAX_SHAPES = 4096  # distinct keys kept; past that the cache starts again


def _shape_args(q, T: int, causal, q_offset, kv_len) -> tuple:
    """The float32 kernels' shape arguments for this call and their address,
    built (and the head width and group checked) once per distinct key.  A
    caller that launches later keeps the tuple, and so the arguments, alive."""
    key = (q.shape, T, causal, q_offset, kv_len)
    hit = _SHAPE_ARGS.get(key)
    if hit is None:
        B, S, K, G, D = q.shape
        if D not in _HEAD_DIMS or G > _MAX_GROUP:
            raise ValueError(f"the {q.dtype} CUDA kernel takes head widths {_HEAD_DIMS} and groups <= {_MAX_GROUP}; "
                             f"got D={D}, G={G}")
        args = _ShapeArgs(B, S, T, K, G, D, int(causal), int(q_offset), T if kv_len is None else int(kv_len),
                          scale_for(D, torch.float32))
        if len(_SHAPE_ARGS) >= _MAX_SHAPES:
            _SHAPE_ARGS.clear()
        hit = _SHAPE_ARGS[key] = (args, ctypes.addressof(args))
    return hit


def _launch_f32(q, k, v, shape_args):
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = LIBRARY.function("repro_flash_attention_f32")(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                         shape_args[1], stream_handle(q.device))
    if code:
        LIBRARY.fail("repro_flash_attention_f32", code)
    LAUNCHES["flash_attention"] += 1
    return out


def _launch_bf16(q, k, v, causal, q_offset, kv_len):
    B, S, K, G, D = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    LIBRARY.call("repro_flash_attention_bf16", ptr(q), ptr(k), ptr(v), ptr(out), B, S, T, K, G, D, int(causal),
                 int(q_offset), T if kv_len is None else int(kv_len), scale_for(D, q.dtype), stream_handle(q.device))
    LAUNCHES["flash_attention_bf16"] += 1
    return out


def bwd_smem_bytes(S: int, T: int, G: int, D: int) -> int:
    return 4 * (2 * S * G * D + 2 * T * D + 2 * S * G * T)


def _launch_backward(q, k, v, do, shape_args):
    """The backward kernel on checked inputs: dq, dk and dv carved from one
    allocation."""
    nq, nk = q.numel(), k.numel()
    buf = torch.empty(nq + 2 * nk, dtype=torch.float32, device=q.device)
    dq, dk, dv = (buf.as_strided(q.shape, q.stride()), buf.as_strided(k.shape, k.stride(), nq),
                  buf.as_strided(k.shape, k.stride(), nq + nk))
    if nq == 0 or nk == 0:
        buf.zero_()
        return dq, dk, dv
    code = LIBRARY.function("repro_flash_attention_bwd_f32")(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                                             shape_args[1], stream_handle(q.device))
    if code:
        LIBRARY.fail("repro_flash_attention_bwd_f32", code)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, do, *, causal=True, q_offset: int = 0, kv_len: int | None = None):
    """dQ, dK, dV of :func:`flash_attention` for float32 CUDA tensors (the
    backward kernel), given the output gradient ``do`` (B,S,K,G,D)."""
    _check(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"the attention backward kernel runs on cuda tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype == torch.float32 and q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous() and do.is_contiguous()):
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"the attention backward kernel takes contiguous float32 tensors; {name} is "
                                 f"{t.dtype}{'' if t.is_contiguous() else ', not contiguous'}")
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} must be shaped and placed as q {tuple(q.shape)}")
    B, S, K, G, D = q.shape
    T = k.shape[1]
    if D not in _HEAD_DIMS or bwd_smem_bytes(S, T, G, D) > BWD_SMEM_BYTES:
        raise ValueError(f"the attention backward kernel takes head widths {_HEAD_DIMS} and a head's q, k, v, dO "
                         f"and (S*G, T) tiles within {BWD_SMEM_BYTES} bytes of shared memory; got S={S}, T={T}, "
                         f"G={G}, D={D}")
    return _launch_backward(q, k, v, do, _shape_args(q, T, causal, q_offset, kv_len))


def attention_grads_plain(q, k, v, do, *, causal=True, q_offset: int = 0, kv_len: int | None = None):
    """dQ, dK, dV of the plain version: autograd through :func:`attend_chunked`."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attend_chunked(qq, kk, vv, q_offset=q_offset, causal=causal, kv_len=kv_len)
        return torch.autograd.grad(out, (qq, kk, vv), do)


class _FlashAttentionF32(torch.autograd.Function):
    """The float32 forward kernel with the backward kernel as its gradient
    (q, k and v were checked by :func:`flash_attention`; autograd hands the
    backward a ``do`` of the output's shape, dtype and device)."""

    @staticmethod
    def forward(ctx, q, k, v, shape_args):
        ctx.save_for_backward(q, k, v)
        ctx.shape_args = shape_args
        return _launch_f32(q, k, v, shape_args)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, do.contiguous(), ctx.shape_args)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=True, q_offset: int = 0, kv_len: int | None = None):
    """q: (B,S,K,G,D); k, v: (B,T,K,D); returns (B,S,K,G,D).  The kernels
    for CUDA tensors (with the backward kernel as the gradient when one is
    needed), the plain version for CPU tensors."""
    _check(q, k, v)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return attend_chunked(q, k, v, q_offset=q_offset, causal=causal, kv_len=kv_len)
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    dtype = q.dtype
    if dtype not in _HEAD_WIDTHS:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {dtype}")
    if not (k.dtype == dtype and v.dtype == dtype and q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"the CUDA kernel takes contiguous q, k and v of one dtype; {name} is "
                                 f"{t.dtype}{'' if t.is_contiguous() else ', not contiguous'}")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if dtype == torch.float32:
        shape_args = _shape_args(q, k.shape[1], causal, q_offset, kv_len)  # raises for a width or group not built
        if not grad:
            return _launch_f32(q, k, v, shape_args)
        if bwd_smem_bytes(q.shape[1], k.shape[1], q.shape[3], q.shape[4]) > BWD_SMEM_BYTES:
            raise ValueError(f"the attention backward kernel holds a head's tiles in {BWD_SMEM_BYTES} bytes of "
                             f"shared memory: S={q.shape[1]}, T={k.shape[1]}, G={q.shape[3]}, D={q.shape[4]} do "
                             f"not fit")
        return _FlashAttentionF32.apply(q, k, v, shape_args)
    D, G = q.shape[4], q.shape[3]
    head_dims = _HEAD_WIDTHS[dtype]
    if D not in head_dims or G > _MAX_GROUP:
        raise ValueError(f"the {dtype} CUDA kernel takes head widths {head_dims} and groups <= {_MAX_GROUP}; "
                         f"got D={D}, G={G}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 CUDA kernel reads q, k and v with 16-byte loads; their storage must be 16-byte "
                         "aligned")
    if grad:
        raise ValueError(f"the attention backward kernel is float32 only; {dtype} with a gradient")
    return _launch_bf16(q, k, v, causal, q_offset, kv_len)
