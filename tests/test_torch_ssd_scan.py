"""The port's chunked SSD scan (``repro_torch.kernels.ssd_scan``): its
plain version against the JAX package's TPU kernel in interpret mode
(``ssd_pallas(interpret=True)``), its step-by-step reference
(``ssd_sequential``) and its default path (``ssd_ref``), on inputs made
from numpy seeds, and the wrapper's refusals.

Tolerances, each with its reason:

* float32 against ``ssd_pallas``: rtol 1e-5, atol 1e-4 on y, 1e-5 on the
  state.  Both compute the same float32 function with sums in other orders
  (``cumsum``, the einsums); against a float64 evaluation each is off by up
  to 6e-5 on outputs of about +-80 (C . B over N terms of about +-1 summed
  over the chunk), so atol 1e-5 alone would hold the summation order, not
  the function.
* bf16 y against ``ssd_pallas``: one bf16 ulp (rtol 2^-7, the float32 sums
  may round y to either neighbour) plus atol 1e-3 (the float32 error above,
  near zero); the float32 state within rtol 1e-5, atol 1e-4.
* against ``ssd_sequential`` (float32): rtol/atol 1e-4, the JAX suite's own
  limit for its chunked reference.
* bf16 against ``ssd_ref``: 5e-2, the JAX suite's own limit (``ssd_ref``
  rounds the state and its weights to bf16 where the kernel keeps float32).

The CUDA kernel's arithmetic is rehearsed here too (``_rehearse``): each
chunk's own state from zero, the pass over the chunks for the incoming
states, and y from C . B^T computed once per (batch, chunk), with the float32
operand of each bf16 tensor-core product (the state, w, co . x) split into
three bf16 parts as the card does (torch's bf16 rounding), or rounded once
to show why it is split.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as JK
from repro.kernels.ssd_scan import ref as JR
from repro_torch import kernels
from repro_torch.kernels import ssd_scan as S

SWEEP = [
    # B, L, H, P, N, chunk, dtype: the JAX suite's (tests/kernels/test_ssd_scan.py), then the serve widths
    (2, 128, 4, 16, 32, 32, "float32"),
    (1, 64, 2, 32, 16, 16, "float32"),
    (2, 96, 3, 8, 64, 32, "float32"),
    (1, 128, 4, 16, 32, 64, "bfloat16"),
    (1, 256, 4, 64, 128, 64, "bfloat16"),
    # chunks of 100 (ragged 16-row tiles on the card); one chunk (no state carried in)
    (1, 200, 2, 48, 64, 100, "float32"),
    (2, 64, 2, 16, 32, 64, "bfloat16"),
]
F32_TOL = {"y": (1e-5, 1e-4), "state": (1e-5, 1e-5)}
BF16_TOL = {"y": (2.0 ** -7, 1e-3), "state": (1e-5, 1e-4)}
# the kernel against its plain version on a card, at the serve widths (the
# limits of tests/test_torch_kernels_gpu.py and chip_smoke.py, whose
# comments give the reasons)
KERNEL_TOL = {"float32": {"y": (1e-5, 4e-3), "state": (1e-5, 1e-3)},
              "bfloat16": {"y": (2.0 ** -7, 4e-3), "state": (1e-5, 1e-3)}}


def _inputs(B, L, H, P, N, seed=0, dt_shift=0.0):
    """float32 numpy: x, b, c ~ N(0, 1); dt = softplus(N(0, 1)) + dt_shift;
    A_log ~ N(0, 0.25)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, L, H)), 0.0) + dt_shift).astype(np.float32)
    A_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal((B, L, N)).astype(np.float32)
    c = rng.standard_normal((B, L, N)).astype(np.float32)
    return x, dt, A_log, b, c


def _both(arrays, dtype):
    """The same numbers for each package: x, dt, b and c in ``dtype``,
    A_log float32 (both round float32 to bf16 to nearest even)."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    j = [jnp.asarray(a) if i == 2 else jnp.asarray(a).astype(jd) for i, a in enumerate(arrays)]
    t = [torch.tensor(a) if i == 2 else torch.tensor(a).to(td) for i, a in enumerate(arrays)]
    return j, t


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,L,H,P,N,chunk,dtype", SWEEP)
def test_plain_matches_the_tpu_kernel(B, L, H, P, N, chunk, dtype):
    (jx, jdt, ja, jb, jc), targs = _both(_inputs(B, L, H, P, N), dtype)
    jy, js = JK.ssd_pallas(jx, jdt, ja, jb, jc, chunk=chunk, interpret=True)
    before = dict(kernels.LAUNCHES)
    py, ps = S.ssd_scan(*targs, chunk=chunk)
    assert kernels.LAUNCHES == before  # CPU tensors run the plain version
    assert py.dtype == targs[0].dtype and ps.dtype == torch.float32
    assert tuple(py.shape) == (B, L, H, P) and tuple(ps.shape) == (B, H, P, N)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(py), _np(jy), rtol=tol["y"][0], atol=tol["y"][1])
    np.testing.assert_allclose(_np(ps), _np(js), rtol=tol["state"][0], atol=tol["state"][1])


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_plain_matches_sequential(chunk):
    """State-space duality: any chunking equals the step recurrence."""
    arrays = _inputs(2, 64, 3, 8, 16, seed=7)
    (jx, jdt, ja, jb, jc), targs = _both(arrays, "float32")
    jy, js = JR.ssd_sequential(jx, jdt, ja, jb, jc)
    py, ps = S.ssd_scan_plain(*targs, chunk)
    np.testing.assert_allclose(_np(py), _np(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(ps), _np(js), rtol=1e-4, atol=1e-4)


def test_plain_matches_the_default_path_in_bf16():
    (jx, jdt, ja, jb, jc), targs = _both(_inputs(1, 128, 4, 16, 32, seed=3), "bfloat16")
    jy, js = JR.ssd_ref(jx, jdt, ja, jb, jc, 64)
    py, ps = S.ssd_scan(*targs, chunk=64)
    np.testing.assert_allclose(_np(py), _np(jy), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(ps), _np(js), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_dt_stays_finite(dtype):
    """dt about 5: cum falls by about 5 a token, so exp(cum_i - cum_j)
    above the diagonal overflows to inf; the mask must come first.  The
    outputs reach about +-550 (dt scales each term), so float32 y is held
    within atol 5e-4 (each side is off a float64 evaluation by up to
    2.7e-4)."""
    (jx, jdt, ja, jb, jc), targs = _both(_inputs(1, 256, 4, 64, 128, seed=4, dt_shift=4.3), dtype)
    assert float(targs[1].float().mean()) > 4.5
    jy, js = JK.ssd_pallas(jx, jdt, ja, jb, jc, chunk=64, interpret=True)
    py, ps = S.ssd_scan(*targs, chunk=64)
    assert torch.isfinite(py.float()).all() and torch.isfinite(ps).all()
    tol = {**F32_TOL, "y": (1e-5, 5e-4)} if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(py), _np(jy), rtol=tol["y"][0], atol=tol["y"][1])
    np.testing.assert_allclose(_np(ps), _np(js), rtol=tol["state"][0], atol=tol["state"][1])


def test_wrapper_raises_on_what_it_does_not_take():
    x, dt, A_log, b, c = (torch.tensor(a) for a in _inputs(1, 64, 2, 16, 16))
    with pytest.raises(NotImplementedError, match="initial state"):
        S.ssd_scan(x, dt, A_log, b, c, chunk=16, initial_state=torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        S.ssd_scan(x[:, :40], dt[:, :40], A_log, b[:, :40], c[:, :40], chunk=16)
    with pytest.raises(ValueError, match="one device"):
        S.ssd_scan(x, dt, A_log.to("meta"), b, c, chunk=16)
    with pytest.raises(ValueError, match="shapes disagree"):
        S.ssd_scan(x, dt[:, :, :1], A_log, b, c, chunk=16)


def _no_diagonal(x, dt, A_log, b, c, chunk):
    """A defective plain version: key j = i left out of each query's sum."""
    a = -torch.exp(A_log.float())
    state = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]))
    mask = torch.ones((chunk, chunk), dtype=torch.bool).tril(-1)
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        state, y = S.ssd_chunk_plain(state, x[:, sl].float(), dt[:, sl].float(), a, b[:, sl].float(),
                                     c[:, sl].float(), mask)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, 1), state


def _no_carry(x, dt, A_log, b, c, chunk):
    """A defective plain version: no state carried across the boundary
    after the first chunk."""
    y0, _ = S.ssd_scan_plain(x[:, :chunk], dt[:, :chunk], A_log, b[:, :chunk], c[:, :chunk], chunk)
    y1, state = S.ssd_scan_plain(x[:, chunk:], dt[:, chunk:], A_log, b[:, chunk:], c[:, chunk:], chunk)
    return torch.cat([y0, y1], 1), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("defect", [_no_diagonal, _no_carry])
def test_the_kernel_limits_reject_a_defective_plain_version(dtype, defect):
    """The limits that hold the CUDA kernel to its plain version on a card
    (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``) reject a plain
    version that drops the diagonal or the state at one chunk boundary."""
    _, args = _both(_inputs(2, 512, 4, 64, 128, seed=6), dtype)
    tol = KERNEL_TOL[dtype]
    y, state = S.ssd_scan_plain(*args, 256)
    y_bad, state_bad = defect(*args, 256)
    ok_y = torch.allclose(y_bad.float(), y.float(), rtol=tol["y"][0], atol=tol["y"][1])
    ok_s = torch.allclose(state_bad, state, rtol=tol["state"][0], atol=tol["state"][1])
    assert not (ok_y and ok_s)


# --- the CUDA kernel's order of work, rehearsed ---------------------------------


def _split3(v):
    """v (float32) as three bf16 values in float32, hi + mid + lo == v
    exactly: the card's split of a float32 tensor-core operand.  Exact bar
    remainders below float32's normal range (under 1.2e-38), which torch's
    bf16 rounding flushes to zero."""
    h = v.bfloat16().float()
    r = v - h
    m = r.bfloat16().float()
    lo = r - m
    normal = lo.abs() >= torch.finfo(torch.float32).tiny
    assert torch.equal(lo.bfloat16().float()[normal], lo[normal])  # the remainder is a bf16: nothing is lost
    return h, m, lo.bfloat16().float()


def _parts(v, how):
    """The operand as the tensor cores see it: ``three`` parts (exact),
    rounded ``once`` to bf16, or ``float32`` (CUDA cores)."""
    return {"three": _split3, "once": lambda t: (t.bfloat16().float(),), "float32": lambda t: (t,)}[how](v)


def _einsum(eq, a, b, how):
    """float32 einsum with ``a`` (the float32 operand) in ``how`` parts and
    ``b`` as it is; the parts' products summed in float32."""
    out = None
    for part in _parts(a, how):
        r = torch.einsum(eq, part, b)
        out = r if out is None else out + r
    return out


def _rehearse(x, dt, A_log, b, c, chunk, *, state="three", w="three", u="three"):
    """The kernel's algorithm on the CPU: (1) every chunk's own state from
    zero, (u^T . B with u = co * x, co_q = exp(cum_last - cum_q) * dt_q);
    (2) the pass s_c = s_{c-1} * exp(cum_last_c) + contrib_c, keeping each
    chunk's incoming state; (3) y = exp(cum_i) * (C . s_in) + (w . x), w
    from C . B^T computed once per (batch, chunk).  ``state``, ``w`` and
    ``u`` say how each float32 operand meets its bf16 partner."""
    Bb, L, H, P = x.shape
    N, nc, Q = b.shape[-1], L // chunk, chunk
    xq = x.float().reshape(Bb, nc, Q, H, P)
    dtq = dt.float().reshape(Bb, nc, Q, H)
    bq, cq = b.float().reshape(Bb, nc, Q, N), c.float().reshape(Bb, nc, Q, N)
    a = -torch.exp(A_log.float())
    cum = torch.cumsum(dtq * a, dim=2)  # (B, nc, Q, H)
    cum_last = cum[:, :, -1]  # (B, nc, H)
    co = torch.exp(cum_last[:, :, None] - cum) * dtq
    contrib = _einsum("bcqhp,bcqn->bchpn", co[..., None] * xq, bq, u)
    s = torch.zeros((Bb, H, P, N))
    s_in = []
    for k in range(nc):
        s_in.append(s)
        s = s * torch.exp(cum_last[:, k])[:, :, None, None] + contrib[:, k]
    s_in = torch.stack(s_in, 1)  # (B, nc, H, P, N)
    y_inter = _einsum("bchpn,bcin->bcihp", s_in, cq, state) * torch.exp(cum)[..., None]
    scores = torch.einsum("bcin,bcjn->bcij", cq, bq)  # once per (batch, chunk)
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, H)
    ww = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0) * scores[..., None] * dtq[:, :, None]
    y_intra = _einsum("bcijh,bcjhp->bcihp", ww, xq, w)
    y = (y_inter + y_intra).reshape(Bb, L, H, P).to(x.dtype)
    return y, s


def _within(got, want, tol) -> bool:
    return (torch.allclose(got[0].float(), want[0].float(), rtol=tol["y"][0], atol=tol["y"][1])
            and torch.allclose(got[1], want[1], rtol=tol["state"][0], atol=tol["state"][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rehearsal_matches_plain_at_the_kernel_limits(dtype):
    """At the serve widths (H 32, P 64, N 128, chunk 256; two chunks) the
    card's order of work, with the bf16 instance's three-part split (the
    float32 instance multiplies on CUDA cores), is within the limits the
    card is held to."""
    _, args = _both(_inputs(1, 512, 32, 64, 128, seed=12), dtype)
    how = "three" if dtype == "bfloat16" else "float32"
    got = _rehearse(*args, 256, state=how, w=how, u=how)
    assert _within(got, S.ssd_scan_plain(*args, 256), KERNEL_TOL[dtype])


@pytest.mark.parametrize("B,L,H,P,N,chunk,dtype", SWEEP)
def test_rehearsal_matches_the_tpu_kernel(B, L, H, P, N, chunk, dtype):
    (jx, jdt, ja, jb, jc), targs = _both(_inputs(B, L, H, P, N, seed=2), dtype)
    jy, js = JK.ssd_pallas(jx, jdt, ja, jb, jc, chunk=chunk, interpret=True)
    how = "three" if dtype == "bfloat16" else "float32"
    py, ps = _rehearse(*targs, chunk, state=how, w=how, u=how)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(py), _np(jy), rtol=tol["y"][0], atol=tol["y"][1])
    np.testing.assert_allclose(_np(ps), _np(js), rtol=tol["state"][0], atol=tol["state"][1])


@pytest.mark.parametrize("operand", ["w", "state", "u"])
def test_one_bf16_rounding_of_a_float32_operand_fails_the_kernel_limits(operand):
    """Why the card splits: rounding w, the incoming state or co . x once
    to bf16 (as TF32 or a plain bf16 cast would) puts y or the state far
    outside the limits at the serve widths, where the three-part split is
    inside them (the test above)."""
    _, args = _both(_inputs(1, 512, 32, 64, 128, seed=12), "bfloat16")
    got = _rehearse(*args, 256, **{operand: "once"})
    assert not _within(got, S.ssd_scan_plain(*args, 256), KERNEL_TOL["bfloat16"])
