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
