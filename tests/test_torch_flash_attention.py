"""The port's float32 attention (``repro_torch.kernels.flash_attention``),
forward and backward: the plain versions against the JAX package, the CUDA
kernels' order of operations emulated on the CPU against the plain
versions, and the wrapper's refusals on CPU tensors.

* The plain forward against the Pallas ``flash_attention`` in interpret
  mode and the plain gradient against ``jax.vjp`` of the JAX
  ``_attend_chunked``, at the predictor's ``CONFIG`` and ``SMOKE`` shapes
  and at the multi-tile shapes of ``chip_smoke.py`` phase 3.
* ``emulated_forward`` and ``emulated_backward`` repeat what
  ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` compute,
  step for step: float32 throughout, each ``fmaf`` as one rounding of the
  exact product and sum (taken in float64, then rounded to float32), the
  forward's keys in tiles of 32 with each key's running max from a prefix
  max, the backward's row sums serial in key order.  They are held to the
  limits the card holds the kernels to, and those limits are shown to
  reject a dropped key and a dropped causal mask.

Tolerances, each with its reason:

* plain against JAX: rtol 1e-5, atol 1e-6 (forward and gradient); both are
  the same float32 function on a CPU with sums in other orders.
* emulation against plain: the card's limits.  Forward ``FA_RTOL``,
  ``FA_ATOL`` = 1e-5, 1e-6 (``chip_smoke.py``, ``tests/test_torch_kernels_
  gpu.py``): the kernel's serial fmaf chains and per-key online softmax
  against the plain version's einsum and chunked softmax, and ``expf``
  against ``torch.exp``.  Backward ``ATTN_BWD_TOL`` = 1e-4, 1e-5: the same
  through the softmax's backward, dS = P * (dP - sum P dP), whose
  difference cancels.  The float64 step of the fmaf emulation can round
  twice where the card rounds once, at most one float32 ulp on rare ties,
  far inside both.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JFA
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA

RTOL, ATOL = 1e-5, 1e-6
FA_RTOL, FA_ATOL = 1e-5, 1e-6
ATTN_BWD_TOL = (1e-4, 1e-5)
NEG = -1e30
KEY_TILE = 32  # keys per shared-memory tile in the forward kernel

# (B, S, T, K, G, D), mask: the predictor's CONFIG (d 64, 2 heads) and SMOKE
# (d 16) shapes, then chip_smoke.py phase 3's multi-tile shapes
PLAIN_CASES = [
    ((16, 10, 10, 2, 1, 32), {}),
    ((16, 10, 10, 2, 1, 8), {}),
    ((3, 37, 37, 2, 3, 64), {}),
    ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
    ((2, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}),
    ((1, 1, 40, 2, 4, 128), {"q_offset": 39}),
]
GRAD_CASES = [
    ((16, 10, 10, 2, 1, 32), {}),
    ((16, 10, 10, 2, 1, 8), {}),
    ((3, 37, 37, 2, 3, 64), {}),
    ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
    ((4, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}),
    ((2, 9, 9, 2, 1, 128), {"kv_len": 6}),
]
# the kernels' emulations: the predictor's shapes at B 256, phase 3's, then
# past one block of rows (64 at D 16) and one tile of keys (32), G > 1,
# q_offset, kv_len < T, fully masked rows (kv_len 0; a negative q_offset),
# D 8 and 128
EMUL_CASES = [
    ((256, 10, 10, 2, 1, 32), {}),
    ((256, 10, 10, 2, 1, 8), {}),
    ((3, 37, 37, 2, 3, 64), {}),
    ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
    ((4, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}),
    ((2, 9, 9, 2, 1, 128), {"kv_len": 6}),
    ((2, 40, 70, 1, 2, 16), {"q_offset": 30}),
    ((2, 10, 10, 2, 1, 32), {"kv_len": 0}),
    ((2, 12, 12, 1, 1, 32), {"q_offset": -3}),
]


def _inputs(B, S, T, K, G, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, S, K, G, D), mk(B, T, K, D), mk(B, T, K, D), mk(B, S, K, G, D)


def _mask_kw(kw):
    return {"q_offset": kw.get("q_offset", 0), "causal": kw.get("causal", True), "kv_len": kw.get("kv_len")}


@pytest.mark.parametrize("shape,kw", PLAIN_CASES)
def test_plain_forward_matches_the_pallas_kernel(shape, kw):
    B, S, T, K, G, D = shape
    q, k, v, _ = _inputs(*shape, seed=sum(shape))
    got = FA.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    assert torch.equal(got, FA.attend_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw))
    want = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=S, bk=T, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,kw", GRAD_CASES)
def test_plain_gradient_matches_jax(shape, kw):
    q, k, v, do = _inputs(*shape, seed=sum(shape) + 1)
    _, vjp = jax.vjp(lambda a, b, c: JL._attend_chunked(a, b, c, **_mask_kw(kw)), jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = FA.attention_grads_plain(*(torch.tensor(a) for a in (q, k, v, do)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


# --- the CUDA kernels' order of operations, emulated on the CPU --------------


def _fma(a, b, c):
    """fmaf on float32 tensors: the exact product and sum, rounded once to
    float32 (through float64, which holds the product exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _heads(q, k, v, do=None):
    """(B, K, R, D) rows (r = s * G + g) and (B, K, T, D) keys."""
    B, S, K, G, D = q.shape
    rows = lambda x: x.permute(0, 2, 1, 3, 4).reshape(B, K, S * G, D)
    keys = lambda x: x.permute(0, 2, 1, 3)
    return rows(q), keys(k), keys(v), None if do is None else rows(do)


def _live(S, G, T, causal, q_offset, kv_len):
    q_pos = q_offset + torch.arange(S * G) // G
    k_pos = torch.arange(T)
    dead = (k_pos[None, :] >= (T if kv_len is None else kv_len)).expand(S * G, T)
    if causal:
        dead = dead | (q_pos[:, None] < k_pos[None, :])
    return ~dead  # (R, T)


def _scores(qs, kk, live):
    """One in-order fmaf chain over d per (row, key); masked scores -1e30."""
    sc = torch.zeros(qs.shape[:3] + (kk.shape[2],))
    for d in range(qs.shape[-1]):
        sc = _fma(qs[..., d, None], kk[:, :, None, :, d], sc)
    return torch.where(live, sc, torch.full_like(sc, NEG))


def _unrows(x, S, G):
    B, K, _, D = x.shape
    return x.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)


def emulated_forward(q, k, v, *, causal=True, q_offset=0, kv_len=None):
    """``csrc/flash_attention.cu``: per row, keys in tiles of 32; key t's
    running max m_t is the prefix max through t (and the tile's start), p_t =
    exp(s_t - m_t), alpha_t = exp(m_{t-1} - m_t); then key by key
    l = l * alpha + p (one fmaf, as nvcc contracts it) and acc = fmaf(p, v,
    acc * alpha); the output acc / max(l, 1e-30)."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    qr, kk, vv, _ = _heads(q * FA.scale_for(D, torch.float32), k, v)
    sc = _scores(qr, kk, _live(S, G, T, causal, q_offset, kv_len))
    m = torch.full(qr.shape[:3], NEG)
    l = torch.zeros(qr.shape[:3])
    acc = torch.zeros(qr.shape)
    for t0 in range(0, T, KEY_TILE):
        st = sc[..., t0:t0 + KEY_TILE]
        mt = torch.maximum(torch.cummax(st, -1).values, m[..., None])
        mprev = torch.cat([m[..., None], mt[..., :-1]], -1)
        p, alpha = torch.exp(st - mt), torch.exp(mprev - mt)
        for j in range(st.shape[-1]):
            l = _fma(l, alpha[..., j], p[..., j])
            acc = _fma(p[..., j, None], vv[:, :, None, t0 + j], acc * alpha[..., j, None])
        m = mt[..., -1]
    return _unrows(acc / torch.clamp(l[..., None], min=1e-30), S, G)


def emulated_backward(q, k, v, do, *, causal=True, q_offset=0, kv_len=None, serial=False):
    """``csrc/flash_attention_bwd.cu``: scores and dP as in-order fmaf
    chains (the kernel leaves out a masked key's dP chain, its dP 0;
    ``serial`` computes it, as the first, serial kernel did); per row m =
    max (exact in any order), e = exp(s - m), l the sum of e in key order,
    inv = 1 / max(l, 1e-30), di = fmaf(e * inv, dP, di) in key order, P =
    e * inv, dS = P * (dP - di) (0 where masked); dQ = scale * (fmaf over
    keys in order), dK and dV fmaf over rows in order."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scale = FA.scale_for(D, torch.float32)
    qs, kk, vv, dos = _heads(q * scale, k, v, do)
    live = _live(S, G, T, causal, q_offset, kv_len)
    sc = _scores(qs, kk, live)
    dp = torch.zeros_like(sc)
    for d in range(D):
        dp = _fma(dos[..., d, None], vv[:, :, None, :, d], dp)
    if not serial:
        dp = torch.where(live, dp, torch.zeros_like(dp))
    m = torch.clamp(sc.amax(-1), min=NEG) if T else torch.full(sc.shape[:3], NEG)
    e = torch.exp(sc - m[..., None])
    l = torch.zeros(sc.shape[:3])
    for t in range(T):
        l = l + e[..., t]
    inv = 1.0 / torch.clamp(l, min=1e-30)
    di = torch.zeros(sc.shape[:3])
    for t in range(T):
        di = _fma(e[..., t] * inv, dp[..., t], di)
    p = e * inv[..., None]
    ds = torch.where(live, p * (dp - di[..., None]), torch.zeros_like(p))
    dq = torch.zeros_like(qs)
    for t in range(T):
        dq = _fma(ds[..., t, None], kk[:, :, None, t], dq)
    dk, dv = torch.zeros_like(kk), torch.zeros_like(vv)
    for r in range(S * G):
        dk = _fma(ds[:, :, r, :, None], qs[:, :, r, None, :], dk)
        dv = _fma(p[:, :, r, :, None], dos[:, :, r, None, :], dv)
    keys = lambda x: x.permute(0, 2, 1, 3)
    return _unrows(dq * scale, S, G), keys(dk), keys(dv)


def _fwd_close(got, want) -> bool:
    return torch.allclose(got, want, rtol=FA_RTOL, atol=FA_ATOL)


def _bwd_close(got, want) -> bool:
    return all(torch.allclose(a, b, rtol=ATTN_BWD_TOL[0], atol=ATTN_BWD_TOL[1]) for a, b in zip(got, want))


@pytest.mark.parametrize("shape,kw", EMUL_CASES)
def test_forward_kernel_emulation_matches_plain(shape, kw):
    q, k, v, _ = (torch.tensor(a) for a in _inputs(*shape, seed=sum(shape) + 2))
    got = emulated_forward(q, k, v, **kw)
    want = FA.attend_chunked(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=FA_RTOL, atol=FA_ATOL)


@pytest.mark.parametrize("shape,kw", EMUL_CASES)
def test_backward_kernel_emulation_matches_plain(shape, kw):
    q, k, v, do = (torch.tensor(a) for a in _inputs(*shape, seed=sum(shape) + 3))
    got = emulated_backward(q, k, v, do, **kw)
    want = FA.attention_grads_plain(q, k, v, do, **kw)
    assert all(torch.isfinite(g).all() for g in got)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=ATTN_BWD_TOL[0], atol=ATTN_BWD_TOL[1])


@pytest.mark.parametrize("shape,kw", [EMUL_CASES[0], EMUL_CASES[4], EMUL_CASES[6], EMUL_CASES[7], EMUL_CASES[8]])
def test_backward_masked_dp_never_reaches_an_output(shape, kw):
    """The backward kernel leaves out a masked key's dP chain: its P is 0,
    or its row has no live key and every dS of the row is 0, so on finite
    inputs the gradients are the same bit for bit as with every chain
    (causal, kv_len < T, G 2 with an offset, kv_len 0, rows with no key)."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(*shape, seed=sum(shape) + 4))
    got = emulated_backward(q, k, v, do, **kw)
    for a, b in zip(got, emulated_backward(q, k, v, do, serial=True, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("defect", ["dropped key", "dropped causal mask"])
def test_emulation_limits_reject_a_dropped_key_and_a_dropped_causal_mask(defect):
    """At the predictor's shape, a kernel that dropped the last key (kv_len
    one short) or the causal mask would land outside the card's limits."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(256, 10, 10, 2, 1, 32, seed=7))
    bad = {"kv_len": 9} if defect == "dropped key" else {"causal": False}
    assert _fwd_close(emulated_forward(q, k, v), FA.attend_chunked(q, k, v))
    assert not _fwd_close(emulated_forward(q, k, v, **bad), FA.attend_chunked(q, k, v))
    want = FA.attention_grads_plain(q, k, v, do)
    assert _bwd_close(emulated_backward(q, k, v, do), want)
    assert not _bwd_close(emulated_backward(q, k, v, do, **bad), want)


def test_forward_emulation_tiles_keys_as_one_online_softmax():
    """Keys past one tile: the running max carried from tile to tile gives
    the one-pass softmax (a row of 70 keys whose largest score comes late)."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1, 3, 70, 1, 1, 16, seed=11))
    k[0, 66] = 4 * q[0, 2, 0, 0] / q[0, 2, 0, 0].norm()
    got = emulated_forward(q, k, v, causal=False)
    torch.testing.assert_close(got, FA.attend_chunked(q, k, v, causal=False), rtol=FA_RTOL, atol=FA_ATOL)


# --- the wrapper's refusals on CPU tensors -------------------------------------


def test_wrapper_refusals_raise_on_cpu_tensors():
    q, k, v, do = (torch.tensor(a) for a in _inputs(2, 5, 7, 2, 1, 8, seed=0))
    with pytest.raises(ValueError, match=r"takes q \(B,S,K,G,D\)"):
        FA.flash_attention(q[:, :, :, 0], k, v)  # q without its group axis
    with pytest.raises(ValueError, match=r"takes q \(B,S,K,G,D\)"):
        FA.flash_attention(q, k, v[:, :6])  # v shaped unlike k
    with pytest.raises(ValueError, match="disagree"):
        FA.flash_attention(q, k[:1], v[:1])  # another batch
    with pytest.raises(ValueError, match="disagree"):
        FA.flash_attention(q, k[..., :4], v[..., :4])  # another head width
    with pytest.raises(ValueError, match="one device"):
        FA.flash_attention(q, k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="runs on cuda tensors"):
        FA.flash_attention_bwd(q, k, v, do)
    with pytest.raises(ValueError, match="disagree"):
        FA.flash_attention_bwd(q, k[:1], v[:1], do)
    # a CPU tensor always takes the plain version, with or without a gradient
    assert torch.equal(FA.flash_attention(q, k, v, q_offset=2), FA.attend_chunked(q, k, v, q_offset=2))
