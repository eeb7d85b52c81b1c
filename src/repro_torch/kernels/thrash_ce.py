"""Thrashing-aware cross-entropy: padded-class masking, logsumexp CE and the
per-sample weight ``1 - mu * in_et``, mean over the batch.

Port of ``repro.kernels.thrash_ce`` (TPU kernels ``_fwd_kernel`` and
``_bwd_kernel`` under a ``custom_vjp``, ``src/repro/kernels/thrash_ce/
kernel.py:88``).  CUDA kernels: ``src/repro_torch/csrc/thrash_ce.cu``
(float32).  On CUDA tensors :func:`thrash_ce` launches one forward kernel,
which also takes the mean over the rows; when the logits need a gradient
it is an autograd function that saves each row's max and sum of
exponentials, and its backward kernel writes ``(softmax - onehot) * w * g /
B`` from them in one pass.  Labels, ``in_et`` and ``n_active`` get no
gradient.  On CPU tensors it computes the plain version,
:func:`thrash_ce_plain` (the JAX package's ``thrash_ce_ref``), and autograd
differentiates it.

``in_et=None`` means no thrashing term (every weight 1).  The kernels take
int32 labels and flags, as the trainer makes them; other integer types
(and bool flags) are cast first, one more launch each.

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
    classes at or past ``n_active`` masked to -1e30 (``thrash_ce_ref``);
    ``in_et=None`` weighs every row 1."""
    lg = logits.float()
    lm = torch.where(torch.arange(lg.shape[-1], device=lg.device) >= n_active, torch.full_like(lg, NEG), lg)
    lse = torch.logsumexp(lm, -1)
    ll = torch.gather(lm, 1, labels.long()[:, None])[:, 0]
    w = 1.0 - mu * (torch.zeros_like(lse) if in_et is None else in_et.float())
    return ((lse - ll) * w).mean()


def _check(logits, labels, in_et, n_active: int) -> None:
    shape = logits.shape
    if len(shape) != 2 or labels.shape != shape[:1] or (in_et is not None and in_et.shape != shape[:1]):
        raise ValueError(f"thrash_ce takes logits (B, V), labels (B,) and in_et (B,) or None; got "
                         f"{tuple(shape)}, {tuple(labels.shape)}, {None if in_et is None else tuple(in_et.shape)}")
    B, V = shape
    if logits.dtype != torch.float32:
        raise ValueError(f"thrash_ce takes float32 logits, not {logits.dtype} (no path feeds it another type)")
    if B > BLOCK_ROWS and B % BLOCK_ROWS:
        raise ValueError(f"thrash_ce cuts the batch into blocks of {BLOCK_ROWS} rows: B={B} is not a multiple")
    if V > MAX_CLASSES or not 0 < n_active:
        raise ValueError(f"thrash_ce takes V <= {MAX_CLASSES} classes and n_active > 0; got V={V}, "
                         f"n_active={n_active}")
    dev = logits.device
    if labels.device != dev or (in_et is not None and in_et.device != dev):
        raise ValueError("logits, labels and in_et must be on one device")


def _cuda_args(logits, labels, in_et):
    """The kernels' operands: contiguous, labels and flags int32."""
    if labels.dtype != torch.int32:
        labels = labels.to(torch.int32)
    if in_et is not None and in_et.dtype != torch.int32:
        in_et = in_et.to(torch.int32)
    return logits.contiguous(), labels.contiguous(), None if in_et is None else in_et.contiguous()


# (device index, raw stream) -> (the forward's ticket, one int32 that every
# call leaves at 0; its scratch of row losses).  Calls on one stream run one
# after another, so they can share both; another stream gets its own.
_WORK: dict = {}


def _workspace(device, stream: int, B: int):
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work[1].numel() < B:
        ticket = torch.zeros(1, dtype=torch.int32, device=device) if work is None else work[0]
        work = _WORK[key] = (ticket, torch.empty(max(B, 256), dtype=torch.float32, device=device))
    return work


def _forward(logits, labels, in_et, n_active: int, mu: float, want_stats: bool):
    """One forward launch: the mean loss (a 0-d tensor); with ``want_stats``
    also the arguments the backward kernel needs and the tensors they point
    into: one float32 buffer holds the loss and, after it, the rows' (m, s)
    (one allocation, not two)."""
    logits, labels, in_et = _cuda_args(logits, labels, in_et)
    B, V = logits.shape
    dev = logits.device
    stream = stream_handle(dev)
    ticket, rows = _workspace(dev, stream, B)
    out = torch.empty(1 + 2 * B if want_stats else (), dtype=torch.float32, device=dev)
    stats = out.data_ptr() + 4 if want_stats else None
    LIBRARY.call("repro_thrash_ce_fwd_f32", logits.data_ptr(), labels.data_ptr(), ptr(in_et), rows.data_ptr(), stats,
                 ticket.data_ptr(), out.data_ptr(), B, V, int(n_active), float(mu), stream)
    LAUNCHES["thrash_ce_fwd"] += 1
    if not want_stats:
        return out, None
    return out[0], ((logits, labels, in_et, out), (logits.data_ptr(), labels.data_ptr(), ptr(in_et), stats),
                    (B, V, int(n_active), float(mu)))


def thrash_ce_bwd(logits, labels, in_et, n_active: int, mu: float, g):
    """dlogits of :func:`thrash_ce` for CUDA tensors by the backward kernel
    recomputing each row's max and sum of exponentials from the logits:
    ``((softmax - onehot) * (1 - mu * in_et)) * (g / B)``, with ``g`` the
    loss's upstream gradient, one float32 on the device.  The autograd
    function's backward launches the same kernel with the forward's saved
    (m, s), which are the same bits."""
    _check(logits, labels, in_et, n_active)
    if logits.device.type != "cuda" or g.device != logits.device or g.numel() != 1:
        raise ValueError("thrash_ce_bwd runs on cuda tensors, with g one element on the logits' device")
    logits, labels, in_et = _cuda_args(logits, labels, in_et)
    B, V = logits.shape
    return _backward((logits.data_ptr(), labels.data_ptr(), ptr(in_et), None), g.float().contiguous(), logits,
                     (B, V, int(n_active), float(mu)))


def _backward(args, g, logits, sizes):
    dlogits = torch.empty_like(logits)
    LIBRARY.call("repro_thrash_ce_bwd_f32", *args, g.data_ptr(), dlogits.data_ptr(), *sizes,
                 stream_handle(logits.device))
    LAUNCHES["thrash_ce_bwd"] += 1
    return dlogits


class _ThrashCE(torch.autograd.Function):
    """The forward kernel with (m, s) saved; the backward kernel from them.
    The pointers the backward passes are computed once, in the forward;
    ``saved_tensors`` keeps their tensors alive and raises if one of them
    was modified in place between the two."""

    @staticmethod
    def forward(ctx, logits, labels, in_et, n_active: int, mu: float):
        loss, (saved, ctx.args, ctx.sizes) = _forward(logits, labels, in_et, n_active, mu, want_stats=True)
        ctx.save_for_backward(*saved)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits = ctx.saved_tensors[0]
        return _backward(ctx.args, g, logits, ctx.sizes), None, None, None, None


def thrash_ce(logits, labels, in_et, n_active: int, mu: float = 0.5):
    """Mean over the B rows of the masked CE weighted by ``1 - mu * in_et``.

    logits (B, V) float32; labels (B,) integer; in_et (B,) bool or integer,
    or None (weight 1).  The kernels for CUDA tensors (the autograd function
    only when the logits need a gradient), the plain version for CPU
    tensors."""
    _check(logits, labels, in_et, n_active)
    if logits.device.type == "cpu":
        return thrash_ce_plain(logits, labels, in_et, n_active, mu)
    if logits.device.type != "cuda":
        raise ValueError(f"thrash_ce runs on cpu or cuda tensors, not {logits.device}")
    if logits.requires_grad and torch.is_grad_enabled():
        return _ThrashCE.apply(logits, labels, in_et, n_active, mu)
    return _forward(logits, labels, in_et, n_active, mu, want_stats=False)[0]
