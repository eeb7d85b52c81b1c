"""Thrashing-aware cross-entropy: padded-class masking, logsumexp CE and the
per-sample weight ``1 - mu * in_et``, mean over the batch.

Port of ``repro.kernels.thrash_ce`` (TPU kernels ``_fwd_kernel`` and
``_bwd_kernel`` under a ``custom_vjp``, ``src/repro/kernels/thrash_ce/
kernel.py:88``).  CUDA kernels: ``src/repro_torch/csrc/thrash_ce.cu``
(float32).  On CUDA tensors :func:`thrash_ce` is an autograd function
whose forward kernel writes the per-row losses (averaged here, as the TPU
wrapper does) and whose backward kernel writes
``(softmax - onehot) * w * g / B``; labels, ``in_et`` and ``n_active`` get
no gradient.  On CPU tensors it computes the plain version,
:func:`thrash_ce_plain` (the JAX package's ``thrash_ce_ref``), and autograd
differentiates it.

Scope, as the TPU kernel's: the batch is cut into blocks of
``min(128, B)`` rows, so B > 128 must be a multiple of 128; V <= 4096.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, ptr, stream_handle

NEG = -1e30
BLOCK_ROWS = 128  # the TPU kernel's batch block (DEFAULT_BB)
MAX_CLASSES = 4096


def thrash_ce_plain(logits, labels, in_et, n_active: int, mu: float):
    """The mean over rows of ``nll * (1 - mu * in_et)``, float32, with the
    classes at or past ``n_active`` masked to -1e30 (``thrash_ce_ref``)."""
    lg = logits.float()
    lm = torch.where(torch.arange(lg.shape[-1], device=lg.device) >= n_active, torch.full_like(lg, NEG), lg)
    lse = torch.logsumexp(lm, -1)
    ll = torch.gather(lm, 1, labels.long()[:, None])[:, 0]
    w = 1.0 - mu * in_et.float()
    return ((lse - ll) * w).mean()


def _check(logits, labels, in_et, n_active: int) -> None:
    if logits.dim() != 2 or labels.shape != logits.shape[:1] or in_et.shape != logits.shape[:1]:
        raise ValueError(f"thrash_ce takes logits (B, V), labels (B,) and in_et (B,); got "
                         f"{tuple(logits.shape)}, {tuple(labels.shape)}, {tuple(in_et.shape)}")
    B, V = logits.shape
    if logits.dtype != torch.float32:
        raise ValueError(f"thrash_ce takes float32 logits, not {logits.dtype} (no path feeds it another type)")
    if B > BLOCK_ROWS and B % BLOCK_ROWS:
        raise ValueError(f"thrash_ce cuts the batch into blocks of {BLOCK_ROWS} rows: B={B} is not a multiple")
    if V > MAX_CLASSES or not 0 < n_active:
        raise ValueError(f"thrash_ce takes V <= {MAX_CLASSES} classes and n_active > 0; got V={V}, "
                         f"n_active={n_active}")
    if len({logits.device, labels.device, in_et.device}) != 1:
        raise ValueError("logits, labels and in_et must be on one device")


def _cuda_args(logits, labels, in_et):
    return logits.contiguous(), labels.to(torch.int32).contiguous(), in_et.to(torch.int32).contiguous()


def thrash_ce_bwd(logits, labels, in_et, n_active: int, mu: float, g):
    """dlogits of :func:`thrash_ce` for CUDA tensors (the backward kernel):
    ``((softmax - onehot) * (1 - mu * in_et)) * (g / B)``, with ``g`` the
    loss's upstream gradient, one float32 on the device."""
    _check(logits, labels, in_et, n_active)
    if logits.device.type != "cuda" or g.device != logits.device or g.numel() != 1:
        raise ValueError("thrash_ce_bwd runs on cuda tensors, with g one element on the logits' device")
    logits, labels, in_et = _cuda_args(logits, labels, in_et)
    B, V = logits.shape
    g = g.float().contiguous()
    dlogits = torch.empty_like(logits)
    LIBRARY.call("repro_thrash_ce_bwd_f32", ptr(logits), ptr(labels), ptr(in_et), ptr(g), ptr(dlogits), B, V,
                 int(n_active), float(mu), stream_handle(logits.device))
    LAUNCHES["thrash_ce_bwd"] += 1
    return dlogits


class _ThrashCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, in_et, n_active: int, mu: float):
        B, V = logits.shape
        logits, labels, in_et = _cuda_args(logits, labels, in_et)
        per_row = torch.empty(B, dtype=torch.float32, device=logits.device)
        LIBRARY.call("repro_thrash_ce_fwd_f32", ptr(logits), ptr(labels), ptr(in_et), ptr(per_row), B, V,
                     int(n_active), float(mu), stream_handle(logits.device))
        LAUNCHES["thrash_ce_fwd"] += 1
        ctx.save_for_backward(logits, labels, in_et)
        ctx.n_active, ctx.mu = int(n_active), float(mu)
        return per_row.mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, in_et = ctx.saved_tensors
        return thrash_ce_bwd(logits, labels, in_et, ctx.n_active, ctx.mu, g), None, None, None, None


def thrash_ce(logits, labels, in_et, n_active: int, mu: float = 0.5):
    """Mean over the B rows of the masked CE weighted by ``1 - mu * in_et``.

    logits (B, V) float32; labels (B,) integer; in_et (B,) bool or integer.
    The kernels for CUDA tensors, the plain version for CPU tensors."""
    _check(logits, labels, in_et, n_active)
    if logits.device.type == "cpu":
        return thrash_ce_plain(logits, labels, in_et, n_active, mu)
    if logits.device.type != "cuda":
        raise ValueError(f"thrash_ce runs on cpu or cuda tensors, not {logits.device}")
    return _ThrashCE.apply(logits, labels, in_et, n_active, mu)
