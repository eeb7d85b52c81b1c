"""The port's losses (``repro_torch.core.losses``) against the JAX
package's (``repro.core.losses``), and the predictor attention's gradient
(autograd through the plain version, as on the CPU) against ``jax.grad`` of
the JAX ``_attend_chunked``, on inputs made from numpy seeds.

Tolerances, each with its reason:

* the reference functions (``ce``, ``lucir_distill``, ``thrash_term``,
  ``total_loss``): rtol 1e-6, atol 1e-6; the same float32 formulas with
  sums in other orders.
* ``train_loss`` (CE and the thrashing term fused through ``thrash_ce``
  with ``mu' = mu * B / max(|S|, 1)``) against ``total_loss``: rtol 1e-6
  on the loss and on its gradients with respect to the logits and the
  features, plus atol ``GRAD_ATOL`` 1e-7 on gradient elements of at most
  1/B (3.9e-3 at B 256): the identity is exact and only the float32 sums
  differ; PyTorch's CPU ``logsumexp`` over 1,024 classes, its rows split
  over threads, has put some rows' gradients 5.8e-8 from a float64
  evaluation (XLA's: 1.3e-9), depending on how the rows were split.
* the attention gradient: rtol 1e-5, atol 1e-6, the limit of the forward.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as JL
from repro.models import layers as JLay
from repro_torch.core import losses as PL
from repro_torch.kernels import flash_attention as FA

RTOL = 1e-6
GRAD_ATOL = 1e-7
# the attention backward kernel against its plain version on a card (the
# limits of tests/test_torch_kernels_gpu.py and chip_smoke.py): float32
# sums in other orders through the softmax's backward
ATTN_BWD_TOL = (1e-4, 1e-5)


def _batch(B, V, d, n_active, frac_et, seed=0, resize_from=None):
    """logits (B, V), features (B, d) new and old, labels, E∪T flags; with
    ``resize_from`` the batch is a tiny group's ``np.resize`` to B rows."""
    rng = np.random.default_rng(seed)
    n = resize_from or B
    logits = (4 * rng.standard_normal((n, V))).astype(np.float32)
    f_new = rng.standard_normal((n, d)).astype(np.float32)
    f_old = (f_new + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    labels = rng.integers(0, n_active, n).astype(np.int32)
    et = rng.random(n) < frac_et
    if resize_from:
        order = rng.permutation(n)
        take = np.resize(order, B)
        logits, f_new, f_old, labels, et = (a[take] for a in (logits, f_new, f_old, labels, et))
    return logits, f_new, f_old, labels, et


def _jax_total(logits, f_new, f_old, labels, et, n_active, use_old, use_et, lam=0.5, mu=0.5):
    def lf(lg, fn):
        return JL.total_loss(lg, fn, jnp.asarray(labels), n_active=n_active,
                             f_old=jnp.asarray(f_old) if use_old else None,
                             in_et=jnp.asarray(et) if use_et else None, lam=lam, mu=mu)

    (loss, metrics), (g_lg, g_f) = jax.value_and_grad(lf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(f_new))
    return float(loss), np.asarray(g_lg), np.asarray(g_f), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("frac_et", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("use_old", [False, True])
def test_train_loss_equals_total_loss(frac_et, use_old):
    B, V, d, n_active = 256, 1024, 64, 300
    logits, f_new, f_old, labels, et = _batch(B, V, d, n_active, frac_et, seed=int(frac_et * 10) + use_old)
    assert (et.sum() == 0) == (frac_et == 0.0) and (et.all() == (frac_et == 1.0))
    want, want_lg, want_f, _ = _jax_total(logits, f_new, f_old, labels, et, n_active, use_old, True)
    lg = torch.tensor(logits, requires_grad=True)
    fn = torch.tensor(f_new, requires_grad=True)
    loss = PL.train_loss(lg, fn, torch.tensor(labels), n_active=n_active,
                         f_old=torch.tensor(f_old) if use_old else None, in_et=torch.tensor(et),
                         n_et=int(et.sum()), lam=0.5, mu=0.5)
    g_lg, g_f = torch.autograd.grad(loss, (lg, fn), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=RTOL)
    np.testing.assert_allclose(g_lg.numpy(), want_lg, rtol=RTOL, atol=GRAD_ATOL)
    if use_old:
        np.testing.assert_allclose(g_f.numpy(), want_f, rtol=RTOL, atol=GRAD_ATOL)
    else:
        assert g_f is None and not np.any(want_f)


def test_train_loss_without_flags_is_total_loss_without_the_term():
    """JAX's ``train_step`` passes ``in_et=None`` when the thrashing term is
    off; so does the port, and ``thrash_ce`` weighs every row 1."""
    logits, f_new, f_old, labels, et = _batch(128, 64, 16, 40, 0.5, seed=9)
    want, want_lg, _, metrics = _jax_total(logits, f_new, f_old, labels, et, 40, True, False)
    assert "thrash_term" not in metrics
    lg = torch.tensor(logits, requires_grad=True)
    loss = PL.train_loss(lg, torch.tensor(f_new), torch.tensor(labels), n_active=40, f_old=torch.tensor(f_old))
    (g,) = torch.autograd.grad(loss, lg)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), want_lg, rtol=RTOL, atol=GRAD_ATOL)


def test_train_loss_without_flags_is_all_zero_flags_bit_for_bit():
    """``in_et=None`` (no flags allocated) gives the loss and gradient of
    all-zero flags, bit for bit."""
    logits, f_new, f_old, labels, _ = _batch(256, 1024, 64, 300, 0.0, seed=12)

    def run(**kw):
        lg = torch.tensor(logits, requires_grad=True)
        loss = PL.train_loss(lg, torch.tensor(f_new), torch.tensor(labels), n_active=300, f_old=torch.tensor(f_old),
                             **kw)
        (g,) = torch.autograd.grad(loss, lg)
        return loss.detach(), g

    none, zeros = run(), run(in_et=torch.zeros(256, dtype=torch.int32), n_et=0)
    assert torch.equal(none[0], zeros[0]) and torch.equal(none[1], zeros[1])


def test_train_loss_on_a_tiny_group_resized_to_one_batch():
    """A group smaller than the batch is ``np.resize``d to one batch, so rows
    repeat; the identity still holds row for row."""
    logits, f_new, f_old, labels, et = _batch(64, 32, 16, 20, 0.4, seed=4, resize_from=23)
    want, want_lg, _, _ = _jax_total(logits, f_new, f_old, labels, et, 20, True, True)
    lg = torch.tensor(logits, requires_grad=True)
    loss = PL.train_loss(lg, torch.tensor(f_new), torch.tensor(labels), n_active=20, f_old=torch.tensor(f_old),
                         in_et=torch.tensor(et), n_et=int(et.sum()))
    (g,) = torch.autograd.grad(loss, lg)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), want_lg, rtol=RTOL, atol=GRAD_ATOL)


def test_reference_functions_match():
    logits, f_new, f_old, labels, et = _batch(96, 48, 16, 30, 0.3, seed=2)
    t = lambda a: torch.tensor(a)
    j = lambda a: jnp.asarray(a)
    pairs = [
        (PL.ce(t(logits), t(labels), 30), JL.ce(j(logits), j(labels), 30)),
        (PL.lucir_distill(t(f_new), t(f_old)), JL.lucir_distill(j(f_new), j(f_old))),
        (PL.thrash_term(t(logits), t(labels), t(et), 30), JL.thrash_term(j(logits), j(labels), j(et), 30)),
        (PL.top1_accuracy(t(logits), t(labels), 30), JL.top1_accuracy(j(logits), j(labels), 30)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    got, gm = PL.total_loss(t(logits), t(f_new), t(labels), n_active=30, f_old=t(f_old), in_et=t(et))
    want, wm = JL.total_loss(j(logits), j(f_new), j(labels), n_active=30, f_old=j(f_old), in_et=j(et))
    assert sorted(gm) == sorted(wm) == ["ce", "lucir", "thrash_term", "total"]
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=RTOL, atol=1e-6)
    # the distillation target is detached: no gradient reaches f_old
    fn, fo = t(f_new).requires_grad_(True), t(f_old).requires_grad_(True)
    PL.lucir_distill(fn, fo).sum().backward()
    assert fn.grad is not None and fo.grad is None


def _attn_inputs(B, S, T, K, G, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, S, K, G, D), mk(B, T, K, D), mk(B, T, K, D), mk(B, S, K, G, D)


ATTN_CASES = [
    # (B, S, T, K, G, D), mask: the predictor's CONFIG and SMOKE shapes, then GQA, offsets and kv_len
    ((16, 10, 10, 2, 1, 32), {"causal": True}),
    ((16, 10, 10, 2, 1, 8), {"causal": True}),
    ((2, 7, 12, 2, 3, 16), {"causal": True, "q_offset": 5}),
    ((3, 10, 10, 1, 2, 32), {"causal": False, "kv_len": 6}),
    ((2, 9, 9, 2, 1, 64), {"causal": True, "kv_len": 7}),
]


@pytest.mark.parametrize("shape,kw", ATTN_CASES)
def test_attention_gradient_matches_jax(shape, kw):
    q, k, v, do = _attn_inputs(*shape, seed=sum(shape))
    jkw = {"q_offset": kw.get("q_offset", 0), "causal": kw["causal"], "kv_len": kw.get("kv_len")}
    _, vjp = jax.vjp(lambda a, b, c: JLay._attend_chunked(a, b, c, **jkw), jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = FA.attention_grads_plain(*(torch.tensor(a) for a in (q, k, v, do)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the wrapper on CPU tensors is differentiated through the same plain version
    qq, kk, vv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    FA.flash_attention(qq, kk, vv, **kw).backward(torch.tensor(do))
    for t, g in zip((qq, kk, vv), got):
        assert torch.equal(t.grad, g)


def test_attention_backward_limits_reject_a_dropped_causal_mask():
    """A plain version whose backward drops the causal mask (P recomputed
    over every key) is off by more than the limits the card holds the
    backward kernel to."""
    q, k, v, do = (torch.tensor(a) for a in _attn_inputs(256, 10, 10, 2, 1, 32, seed=1))
    good = FA.attention_grads_plain(q, k, v, do)
    with torch.enable_grad():
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = FA.attend_chunked(qq, kk, vv).detach() + FA.attend_chunked(qq, kk, vv, causal=False) \
            - FA.attend_chunked(qq, kk, vv, causal=False).detach()  # the causal forward, a non-causal gradient
        bad = torch.autograd.grad(out, (qq, kk, vv), do)
    assert not all(torch.allclose(b, g, rtol=ATTN_BWD_TOL[0], atol=ATTN_BWD_TOL[1]) for b, g in zip(bad, good))
