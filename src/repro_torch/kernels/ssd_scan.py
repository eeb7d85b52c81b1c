"""Mamba-2 chunked SSD scan (state-space duality).

Port of ``repro.kernels.ssd_scan`` (TPU kernel ``ssd_pallas``,
``src/repro/kernels/ssd_scan/kernel.py:67``).  CUDA kernel:
``src/repro_torch/csrc/ssd_scan.cu`` (float32 and bf16 inputs, head widths
P a multiple of 16, state widths N of 16, 32, 64 or 128, chunks of at most
``MAX_CHUNK`` tokens): three launches per call, the chunks in parallel
(each chunk's own state, a pass over the chunks for the incoming states,
then y), through a float32 scratch the wrapper allocates.

Per (batch, head) the chunks run in order from a zero state.  For a chunk
with ``cum = cumsum(dt * a)``, ``a = -exp(A_log)``::

    y_i   = exp(cum_i) * C_i . state  +  sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
    state = state * exp(cum_last)     +  sum_q exp(cum_last - cum_q) dt_q  B_q (x) x_q

All of it in float32; only ``y`` is rounded to x's dtype, and the final
state is float32.  The plain version repeats the TPU kernel's arithmetic
chunk by chunk (:func:`ssd_chunk_plain` is one grid step of
``_ssd_kernel``), masking ``exp(cum_i - cum_j)`` with ``torch.where``
before any product, since above the diagonal it overflows to inf.  As in
the JAX kernel only a zero initial state is taken: the JAX kernel falls
back to its reference for another, which the port does not do, so an
``initial_state`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._lib import LIBRARY, ptr, stream_handle

MAX_CHUNK = 1024
_STATE_WIDTHS = (16, 32, 64, 128)
_LAUNCHERS = {torch.float32: "repro_ssd_scan_f32", torch.bfloat16: "repro_ssd_scan_bf16"}


def ssd_chunk_plain(state, xq, dtq, a, bq, cq, mask):
    """One chunk, everything float32.  state: (B, H, P, N); xq: (B, Q, H,
    P); dtq: (B, Q, H); a: (H,); bq, cq: (B, Q, N); mask: (Q, Q) bool, the
    pairs (i, j) whose key j feeds query i.  Returns (state', y)."""
    cum = torch.cumsum(dtq * a, dim=1)  # (B, Q, H)
    y_inter = torch.einsum("bqn,bhpn->bqhp", cq, state) * torch.exp(cum)[..., None]
    scores = torch.einsum("bin,bjn->bij", cq, bq)  # (B, Q, Q)
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, i, j, H)
    att = torch.where(mask[None, :, :, None], torch.exp(diff), 0.0)
    w = att * scores[..., None] * dtq[:, None, :, :]
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
    coef = torch.exp(cum[:, -1:, :] - cum) * dtq  # (B, Q, H)
    contrib = torch.einsum("bqh,bqn,bqhp->bhpn", coef, bq, xq)
    state = state * torch.exp(cum[:, -1])[:, :, None, None] + contrib
    return state, y_inter + y_intra


def ssd_scan_plain(x, dt, A_log, b, c, chunk: int):
    """x: (B, L, H, P); dt: (B, L, H) (after softplus); A_log: (H,); b, c:
    (B, L, N).  Returns (y (B, L, H, P) in x's dtype, final state (B, H, P,
    N) float32)."""
    Bb, L, H, P = x.shape
    N = b.shape[-1]
    a = -torch.exp(A_log.float())
    state = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        state, y = ssd_chunk_plain(state, x[:, sl].float(), dt[:, sl].float(), a, b[:, sl].float(),
                                   c[:, sl].float(), mask)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), state


def _check(x, dt, A_log, b, c, chunk: int, initial_state) -> None:
    if initial_state is not None:
        raise NotImplementedError("ssd_scan takes no initial state (the JAX kernel falls back to its reference "
                                  "for one; the port has no fallback)")
    if x.dim() != 4 or dt.dim() != 3 or A_log.dim() != 1 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes x (B,L,H,P), dt (B,L,H), A_log (H,), b and c (B,L,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A_log.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    Bb, L, H, _ = x.shape
    if tuple(dt.shape) != (Bb, L, H) or A_log.shape[0] != H or tuple(b.shape[:2]) != (Bb, L):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A_log {tuple(A_log.shape)}, b {tuple(b.shape)}")
    if chunk < 1 or L % chunk:
        raise ValueError(f"seq len {L} not divisible by chunk {chunk}")
    if len({t.device for t in (x, dt, A_log, b, c)}) != 1:
        raise ValueError("x, dt, A_log, b and c must be on one device")


def ssd_scan(x, dt, A_log, b, c, *, chunk: int, initial_state=None):
    """The chunked SSD: the kernel for CUDA tensors, the plain version for
    CPU tensors.  Returns (y in x's dtype, final state float32)."""
    _check(x, dt, A_log, b, c, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A_log, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda tensors, not {x.device}")
    Bb, L, H, P = x.shape
    N = b.shape[-1]
    if x.dtype not in _LAUNCHERS:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {x.dtype}")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c)):
        if t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous x, dt, b and c of one dtype; {name} is "
                             f"{t.dtype}{'' if t.is_contiguous() else ', not contiguous'}")
    if not A_log.is_floating_point():
        raise ValueError(f"A_log must be floating point, not {A_log.dtype}")
    if P % 16 or N not in _STATE_WIDTHS or chunk > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes head widths P a multiple of 16, state widths N in "
                         f"{_STATE_WIDTHS} and chunks of at most {MAX_CHUNK}; got P={P}, N={N}, chunk={chunk}")
    a_log = A_log.float().contiguous()  # a widening copy of H numbers (none for float32)
    # the kernels copy x, b and c 16 bytes at a time: a view off that boundary is copied once
    x, b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, b, c))
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    # each chunk's state (its contribution, then its incoming state) and cum
    scratch = torch.empty(Bb * (L // chunk) * H * (P * N + chunk), dtype=torch.float32, device=x.device)
    LIBRARY.call(_LAUNCHERS[x.dtype], ptr(x), ptr(dt), ptr(a_log), ptr(b), ptr(c), ptr(y), ptr(state),
                 ptr(scratch), Bb, L, H, P, N, chunk, stream_handle(x.device))
    LAUNCHES["ssd_scan"] += 1
    return y, state
