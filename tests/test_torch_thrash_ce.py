"""The port's thrashing-aware CE (``repro_torch.kernels.thrash_ce``): its
plain version against the JAX package's ``thrash_ce_ref`` and its TPU
kernel in interpret mode, loss and gradient, over the JAX suite's sweep
(``tests/kernels/test_thrash_ce.py``) plus the predictor's shapes; the
wrapper's refusals; and the limits the card holds its kernels to, shown to
reject a defective plain version.

Tolerances, each with its reason:

* float32: rtol 1e-5, atol 1e-6 on the loss and on the gradient.  Both
  sides compute the same float32 function (a logsumexp per row, a mean
  over rows) with sums in other orders; the gradient's elements are at most
  about 1/B.
* bf16 logits: both sides compute in float32 from the same bf16 inputs, so
  the loss keeps the float32 limit; the gradient comes back in bf16, one
  bf16 ulp (rtol 2^-7) plus atol 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.thrash_ce import kernel as JK
from repro.kernels.thrash_ce import ref as JR
from repro_torch import kernels
from repro_torch.kernels import thrash_ce as TC

SWEEP = [
    # B, V, n_active, mu, dtype: the JAX suite's, then the predictor's CONFIG and SMOKE shapes
    (128, 64, 40, 0.5, "float32"),
    (256, 128, 128, 0.9, "float32"),
    (128, 256, 200, 0.0, "float32"),
    (128, 64, 64, 0.5, "bfloat16"),
    (256, 1024, 37, 1.6, "float32"),
    (32, 32, 9, 0.5, "float32"),
]
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-6)}
# the CUDA kernels against this plain version on a card (the limits of
# tests/test_torch_kernels_gpu.py and chip_smoke.py): the same float32
# function, expf against torch's exp and sums in other orders
KERNEL_LOSS_TOL = (1e-5, 1e-6)
KERNEL_GRAD_TOL = (1e-5, 1e-9)


def _inputs(B, V, n_active, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    labels = rng.integers(0, n_active, B).astype(np.int32)
    et = rng.random(B) < 0.3
    return logits, labels, et


def _plain(logits, labels, et, n_active, mu, dtype="float32"):
    lg = torch.tensor(logits).to(getattr(torch, dtype)).requires_grad_(True)
    loss = TC.thrash_ce_plain(lg, torch.tensor(labels), torch.tensor(et), n_active, mu)
    (g,) = torch.autograd.grad(loss, lg)
    return float(loss.detach()), g.float().numpy()


@pytest.mark.parametrize("B,V,n_active,mu,dtype", SWEEP)
def test_plain_matches_ref_and_the_tpu_kernel(B, V, n_active, mu, dtype):
    logits, labels, et = _inputs(B, V, n_active, seed=B + V)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    jlab, jet = jnp.asarray(labels), jnp.asarray(et)
    loss, grad = _plain(logits, labels, et, n_active, mu, dtype)
    ref_loss = float(JR.thrash_ce_ref(jl, jlab, jet, mu, n_active))
    ref_grad = np.asarray(JR.thrash_ce_grad_ref(jl, jlab, jet, mu, n_active), np.float32)
    k_loss = float(JK.thrash_ce(jl, jlab, jet, n_active, mu, JK.DEFAULT_BB, True))
    k_grad = np.asarray(jax.grad(lambda x: JK.thrash_ce(x, jlab, jet, n_active, mu, JK.DEFAULT_BB, True))(jl),
                        np.float32)
    rtol, atol = TOL["float32"]
    np.testing.assert_allclose(loss, ref_loss, rtol=rtol, atol=atol)
    np.testing.assert_allclose(loss, k_loss, rtol=rtol, atol=atol)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(grad, ref_grad, rtol=rtol, atol=atol)
    np.testing.assert_allclose(grad, k_grad, rtol=rtol, atol=atol)
    assert np.all(grad[:, n_active:] == 0)  # the masked classes get no gradient


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    logits, labels, et = _inputs(64, 48, 30, seed=3)
    kernels.reset_launches()
    args = (torch.tensor(labels), torch.tensor(et), 30, 0.7)
    lg1 = torch.tensor(logits, requires_grad=True)
    lg2 = torch.tensor(logits, requires_grad=True)
    l1, l2 = TC.thrash_ce(lg1, *args), TC.thrash_ce_plain(lg2, *args)
    assert torch.equal(l1, l2)
    l1.backward()
    l2.backward()
    assert torch.equal(lg1.grad, lg2.grad)
    assert kernels.LAUNCHES["thrash_ce_fwd"] == kernels.LAUNCHES["thrash_ce_bwd"] == 0


def test_mu_lowers_the_pull_toward_a_thrashing_label():
    """mu > 0 weakens the gradient pull toward an E∪T label (Eq. 2), as the
    JAX suite's ``test_thrash_semantics`` checks of the TPU kernel."""
    logits = torch.zeros(64, 32, requires_grad=True)
    labels, et = torch.full((64,), 3), torch.ones(64, dtype=torch.bool)
    (g_mu,) = torch.autograd.grad(TC.thrash_ce(logits, labels, et, 32, 0.8), logits)
    (g_0,) = torch.autograd.grad(TC.thrash_ce(logits, labels, et, 32, 0.0), logits)
    assert float(g_mu[0, 3]) > float(g_0[0, 3])


def test_wrapper_raises_on_what_it_does_not_take():
    logits, labels, et = _inputs(200, 32, 10)
    lab, e = torch.tensor(labels), torch.tensor(et)
    with pytest.raises(ValueError, match="multiple"):  # the TPU kernel's B % min(128, B) == 0
        TC.thrash_ce(torch.tensor(logits), lab, e, 10)
    ok = torch.tensor(logits[:128])
    with pytest.raises(ValueError, match="float32"):
        TC.thrash_ce(ok.bfloat16(), lab[:128], e[:128], 10)
    with pytest.raises(ValueError, match="V <= 4096"):
        TC.thrash_ce(torch.zeros(8, 4097), lab[:8], e[:8], 10)
    with pytest.raises(ValueError, match="takes logits"):
        TC.thrash_ce(ok, lab[:64], e[:128], 10)
    with pytest.raises(ValueError, match="takes logits"):
        TC.thrash_ce(ok[0], lab[:1], e[:1], 10)


def _defects():
    """Two defective plain versions: the padded classes unmasked, the
    thrashing weight dropped."""
    def no_mask(lg, labels, in_et, n_active, mu):
        return TC.thrash_ce_plain(lg, labels, in_et, lg.shape[-1], mu)

    def no_weight(lg, labels, in_et, n_active, mu):
        return TC.thrash_ce_plain(lg, labels, torch.zeros_like(in_et), n_active, mu)

    return {"no_mask": no_mask, "no_weight": no_weight}


@pytest.mark.parametrize("shape", [(256, 1024, 700), (32, 32, 20)])
@pytest.mark.parametrize("defect", ["no_mask", "no_weight"])
def test_the_kernel_limits_reject_a_defective_plain_version(shape, defect):
    B, V, n_active = shape
    logits, labels, et = _inputs(B, V, n_active, seed=V)
    args = (torch.tensor(labels), torch.tensor(et), n_active, 0.5)
    lg = torch.tensor(logits, requires_grad=True)
    bad = torch.tensor(logits, requires_grad=True)
    good, worse = TC.thrash_ce_plain(lg, *args), _defects()[defect](bad, *args)
    (g,), (gb,) = torch.autograd.grad(good, lg), torch.autograd.grad(worse, bad)
    loss_ok = torch.allclose(worse, good, rtol=KERNEL_LOSS_TOL[0], atol=KERNEL_LOSS_TOL[1])
    grad_ok = torch.allclose(gb, g, rtol=KERNEL_GRAD_TOL[0], atol=KERNEL_GRAD_TOL[1])
    assert not (loss_ok and grad_ok)


# --- the CUDA kernels' algorithm, emulated on the CPU ---------------------------
# src/repro_torch/csrc/thrash_ce.cu: a block of THREADS threads per row,
# each thread sums its strided share of the row, warps add by a butterfly of
# shuffles, and the eight warp partials are added in warp order; the
# forward's last block adds the row losses the same way.
THREADS = 256
NEG = TC.NEG


def _block_sum(parts):
    """The kernel's reductions over ``parts`` (..., n) float32, n threads: a
    butterfly within each warp, then the warp partials in warp order."""
    x = parts.reshape(*parts.shape[:-1], parts.shape[-1] // 32, 32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., torch.arange(32) ^ o]
    y = x[..., 0, 0]
    for w in range(1, x.shape[-2]):
        y = y + x[..., w, 0]
    return y


def _strided(x, fill):
    """(B, V) -> (B, THREADS, ceil(V / THREADS)): thread t's elements t, t +
    THREADS, ... in its loop's order, padded with ``fill``."""
    B, V = x.shape
    n = -(-V // THREADS)
    pad = torch.full((B, n * THREADS - V), fill, dtype=x.dtype)
    return torch.cat([x, pad], 1).reshape(B, n, THREADS).transpose(1, 2)


def _row_stats(lm):
    m = _strided(lm, NEG).amax(-1).amax(-1)  # a max is exact in any order
    e = torch.exp(lm - m[:, None])
    per_thread = torch.zeros(lm.shape[0], THREADS)
    for k in range(_strided(e, 0.0).shape[-1]):  # each thread's loop, in order
        per_thread = per_thread + _strided(e, 0.0)[..., k]
    return m, _block_sum(per_thread)


def _masked(logits, n_active):
    lg = torch.tensor(logits)
    return torch.where(torch.arange(lg.shape[1]) >= n_active, torch.full_like(lg, NEG), lg)


def emulated_forward(logits, labels, et, n_active, mu):
    """The forward kernel: row losses, the rows' (m, s), and the mean that
    the last block takes over the row losses in its fixed order."""
    lm = _masked(logits, n_active)
    m, s = _row_stats(lm)
    w = 1.0 - mu * torch.tensor(et).float()
    rows = (torch.log(s) + m - lm[torch.arange(len(labels)), torch.tensor(labels).long()]) * w
    B = rows.shape[0]
    per_thread = torch.zeros(THREADS)
    for r0 in range(0, B, THREADS):  # thread t adds rows t, t + THREADS, ...
        chunk = torch.zeros(THREADS)
        chunk[:min(THREADS, B - r0)] = rows[r0:r0 + THREADS]
        per_thread = per_thread + chunk
    return _block_sum(per_thread) / B, (m, s)


def emulated_backward(logits, labels, et, n_active, mu, g, stats=None):
    """The backward kernel from the forward's (m, s), or recomputing them."""
    lm = _masked(logits, n_active)
    m, s = _row_stats(lm) if stats is None else stats
    B, V = lm.shape
    p = torch.exp(lm - m[:, None]) / torch.clamp(s, min=1e-30)[:, None]
    onehot = (torch.arange(V)[None, :] == torch.tensor(labels).long()[:, None]).float()
    w = 1.0 - mu * torch.tensor(et).float()
    return ((p - onehot) * w[:, None]) * (torch.tensor(g, dtype=torch.float32) / B)


@pytest.mark.parametrize("B,V,n_active,mu", [(256, 1024, 700, 0.5), (128, 64, 40, 0.5), (32, 32, 20, 0.5),
                                             (128, 4096, 4000, 0.9), (1, 64, 64, 0.0), (1280, 300, 299, 1.6)])
def test_kernel_emulation_matches_the_tpu_kernel(B, V, n_active, mu):
    """The fixed-order mean in the forward's last block and the backward
    from the saved (m, s), at the card's limits against the TPU kernel in
    interpret mode; the gradient bit for bit the recomputing backward's."""
    logits, labels, et = _inputs(B, V, n_active, seed=B + V)
    loss, stats = emulated_forward(logits, labels, et, n_active, mu)
    grad = emulated_backward(logits, labels, et, n_active, mu, 1.0, stats)
    assert torch.equal(grad, emulated_backward(logits, labels, et, n_active, mu, 1.0))
    jl, jlab, jet = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(et)
    bb = min(JK.DEFAULT_BB, B)
    k_loss = float(JK.thrash_ce(jl, jlab, jet, n_active, mu, bb, True))
    k_grad = np.asarray(jax.grad(lambda x: JK.thrash_ce(x, jlab, jet, n_active, mu, bb, True))(jl))
    np.testing.assert_allclose(float(loss), k_loss, rtol=KERNEL_LOSS_TOL[0], atol=KERNEL_LOSS_TOL[1])
    np.testing.assert_allclose(grad.numpy(), k_grad, rtol=KERNEL_GRAD_TOL[0], atol=KERNEL_GRAD_TOL[1])
    assert bool((grad[:, n_active:] == 0).all())


def test_kernel_emulation_limits_reject_a_mean_over_the_wrong_rows():
    """A last block that misses the final row (a ticket off by one) is
    outside the loss limit."""
    logits, labels, et = _inputs(256, 1024, 700, seed=1)
    good, _ = emulated_forward(logits, labels, et, 700, 0.5)
    bad, _ = emulated_forward(logits[:-1], labels[:-1], et[:-1], 700, 0.5)
    assert not np.isclose(float(bad), float(good), rtol=KERNEL_LOSS_TOL[0], atol=KERNEL_LOSS_TOL[1])


def test_no_flags_is_a_weight_of_one_and_int64_labels_are_int32s():
    """``in_et=None`` gives the loss and gradient of all-zero flags, bit for
    bit, and int64 labels those of int32 labels (the CPU path)."""
    logits, labels, et = _inputs(128, 64, 40, seed=5)

    def run(lab, flags):
        lg = torch.tensor(logits, requires_grad=True)
        loss = TC.thrash_ce(lg, lab, flags, 40, 0.7)
        (g,) = torch.autograd.grad(loss, lg)
        return loss.detach(), g

    base = run(torch.tensor(labels), torch.zeros(128, dtype=torch.int32))
    for got in (run(torch.tensor(labels), None), run(torch.tensor(labels).long(), torch.zeros(128, dtype=torch.int32))):
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
