"""The plain version of the port's decode-attention kernel against the JAX
package's Pallas kernel (``decode_attention_kernelcall`` in interpret mode)
and its oracle ``decode_ref``, and the bf16 plain flash attention against
the Pallas flash kernel (interpret mode) and the JAX package's
``_attend_chunked``.  (The CUDA kernels are held against these plain
versions on the card: tests/test_torch_kernels_gpu.py and chip_smoke.py.)

Tolerances: float32 rtol/atol 1e-5 (summation order only).  bf16 atol 2e-2:
the outputs lie within about ±3, where one bf16 rounding of ``p`` (before
the PV product) and one of the output are each worth up to 2^-7 of the
value, and the compared versions round ``p`` against different running
maxima (per 512-key block here, the whole row in ``decode_ref``, which
rounds nothing before the output)."""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as JDK
from repro.kernels.decode_attention import ops as JDO
from repro.kernels.decode_attention.ref import decode_ref
from repro.kernels.flash_attention import kernel as JFA
from repro.models import layers as JL
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, dtype, *shapes):
    arrs = [rng.standard_normal(s).astype(np.float32).astype(_NP[dtype]) for s in shapes]
    return arrs, [torch.tensor(a.astype(np.float32)).to(_TORCH[dtype]) for a in arrs]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (B, K, G, D, T, kv_len): kv_len at 1, at a block edge (512), past it, and T;
# G > 1; T = 1024 is two of the TPU kernel's 512-key blocks
CASES = [
    (2, 2, 1, 64, 1024, 1),
    (2, 2, 7, 64, 1024, 512),
    (2, 2, 7, 64, 1024, 513),
    (1, 2, 4, 32, 1024, 1024),
    (2, 1, 3, 16, 512, 300),
    (2, 4, 1, 112, 1024, 513),  # zamba2-7b's head width, past one block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,D,T,kv_len", CASES)
def test_decode_plain_matches_pallas_and_ref(B, K, G, D, T, kv_len, dtype):
    rng = np.random.default_rng(B * 1000 + G * 100 + kv_len)
    (q, k, v), (tq, tk, tv) = _inputs(rng, dtype, (B, K, G, D), (B, T, K, D), (B, T, K, D))
    before = dict(LAUNCHES)
    got = DA.decode_attention_kernelcall(tq, tk, tv, kv_len)
    assert LAUNCHES == before  # a CPU tensor never counts as a kernel launch
    assert got.dtype == _TORCH[dtype] and got.shape == (B, K, G, D)
    tol = TOL[dtype]
    pallas = JDK.decode_attention_kernelcall(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=tol, atol=tol)
    ref = decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_len)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)


def test_decode_model_layout_and_default_kv_len():
    rng = np.random.default_rng(7)
    (q, k, v), (tq, tk, tv) = _inputs(rng, "float32", (2, 1, 2, 3, 32), (2, 256, 2, 32), (2, 256, 2, 32))
    got = DA.decode_attention(tq, tk, tv)
    assert got.shape == (2, 1, 2, 3, 32)
    want = JDO.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


# (B, S, T, K, G, D, kw)
FLASH = [
    (2, 64, 64, 2, 7, 64, {}),
    (1, 128, 128, 2, 3, 32, {"kv_len": 100}),
    (2, 32, 96, 1, 2, 16, {"q_offset": 64}),
    (1, 64, 64, 2, 1, 112, {}),
]


@pytest.mark.parametrize("B,S,T,K,G,D,kw", FLASH)
def test_flash_plain_bf16_matches_pallas_and_chunked(B, S, T, K, G, D, kw):
    rng = np.random.default_rng(S * T + G)
    (q, k, v), (tq, tk, tv) = _inputs(rng, "bfloat16", (B, S, K, G, D), (B, T, K, D), (B, T, K, D))
    got = FA.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    pallas = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=2e-2, atol=2e-2)
    chunked = JL._attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                 q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"))
    np.testing.assert_allclose(_f32(got), _f32(chunked), rtol=2e-2, atol=2e-2)
    # the same rounding points as _attend_chunked: nearly every output is the same bf16 number
    assert np.mean(_f32(got) == _f32(chunked)) > 0.95


# --- the CUDA kernels' algorithms, emulated in PyTorch on the CPU --------------
#
# Each emulation repeats what its kernel computes, step for step and with its
# rounding points, and is held against the plain version at the limits that
# chip_smoke.py and tests/test_torch_kernels_gpu.py hold the kernel to:
# one bf16 ulp (rtol 2^-7) plus atol 1e-5 (decode) or 2e-3 (flash; the
# tile emulation needs up to 0.0010, the card's kernel 0.0009-0.0011).
DECODE_RTOL, DECODE_ATOL = 2.0 ** -7, 1e-5
FLASH_RTOL, FLASH_ATOL = 2.0 ** -7, 2e-3


def _fmaf_scores(qs, k):
    """Pass 1's scores as the kernel computes them: one fmaf chain over the
    head dims in order per (row, key) (each step the exact product and sum,
    rounded once to float32, through float64)."""
    kk = k.double().permute(0, 2, 1, 3)  # (B, K, T, D)
    s = torch.zeros(qs.shape[:3] + (k.shape[1],))
    for d in range(qs.shape[-1]):
        s = (qs[..., d, None].double() * kk[:, :, None, :, d] + s.double()).float()
    return s


def _split_k_decode(q, k, v, kv_len, chunk=64, bk=DA.DEFAULT_BK, fmaf=False):
    """csrc/decode_attention.cu: pass 1 writes each key's scores (``fmaf``:
    in the kernel's order of sums, else the plain version's) and each
    chunk's max; pass 2 rounds p against the reference's running max M_j
    (the prefix max up to the chunk's own 512-key block), sums l from p
    unrounded and P.V from p in v's dtype; the combine scales each chunk by
    exp(M_j - M_final) and adds the chunks in order."""
    B, K, G, D = q.shape
    T = k.shape[1]
    qs = (q * FA.scale_for(D, q.dtype)).float()
    s = _fmaf_scores(qs, k) if fmaf else torch.einsum("bkgd,btkd->bkgt", qs, k.float())
    s = torch.where(torch.arange(T) < kv_len, s, torch.full_like(s, DA.NEG))
    n_chunks = -(-T // chunk)
    n_act = n_chunks if kv_len <= 0 else -(-min(kv_len, T) // chunk)  # chunks past kv_len: p = 0, alpha = 1
    cmax = torch.stack([s[..., c * chunk:(c + 1) * chunk].amax(-1) for c in range(n_act)], -1)
    per_block = bk // chunk
    neg = torch.full((B, K, G), DA.NEG)
    m_final = torch.maximum(neg, cmax.amax(-1))
    l = torch.zeros((B, K, G))
    acc = torch.zeros((B, K, G, D))
    for c in range(n_act):
        m_j = torch.maximum(neg, cmax[..., :min(n_act, (c // per_block + 1) * per_block)].amax(-1))
        p = torch.exp(s[..., c * chunk:(c + 1) * chunk] - m_j[..., None])
        pv = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v[:, c * chunk:(c + 1) * chunk].float())
        f = torch.exp(m_j - m_final)
        l = l + p.sum(-1) * f
        acc = acc + pv * f[..., None]
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("kv_len", [0, 1, 511, 512, 513, 1800, 2048])
def test_split_k_decode_emulation_matches_plain(kv_len):
    B, K, G, D, T = 2, 2, 7, 64, 2048
    rng = np.random.default_rng(kv_len + 3)
    _, (q, k, v) = _inputs(rng, "bfloat16", (B, K, G, D), (B, T, K, D), (B, T, K, D))
    got = _split_k_decode(q, k, v, kv_len)
    want = DA.decode_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=DECODE_RTOL, atol=DECODE_ATOL)


# chip_smoke.DECODE_ATOL_SHORT: at zamba2-7b's decode shape (K 32, G 1, D 112,
# rows of about 540 keys) the kernel's score order flips the bf16 rounding of
# some p against the plain version's, which moves an output by more than one
# ulp of it (atol needed at rtol 2^-7 up to 5.7e-5 over four seeds; on an
# H100 2.9e-5)
DECODE_ATOL_SHORT = 1.5e-4


@pytest.mark.parametrize("kv_len", [512, 513, 544])
def test_split_k_decode_in_the_kernels_order_at_head_width_112(kv_len):
    rng = np.random.default_rng(kv_len)
    _, (q, k, v) = _inputs(rng, "bfloat16", (2, 32, 1, 112), (2, 544, 32, 112), (2, 544, 32, 112))
    want = DA.decode_attention_plain(q, k, v, kv_len).float()
    got = _split_k_decode(q, k, v, kv_len, fmaf=True).float()
    torch.testing.assert_close(got, want, rtol=DECODE_RTOL, atol=DECODE_ATOL_SHORT)
    dropped = _split_k_decode(q, k, v, kv_len - 1, fmaf=True).float()
    assert not torch.allclose(dropped, want, rtol=DECODE_RTOL, atol=DECODE_ATOL_SHORT)


def test_split_k_decode_limits_reject_a_dropped_key():
    rng = np.random.default_rng(4)
    _, (q, k, v) = _inputs(rng, "bfloat16", (2, 2, 7, 64), (2, 2048, 2, 64), (2, 2048, 2, 64))
    got, want = _split_k_decode(q, k, v, 512), DA.decode_attention_plain(q, k, v, 513)
    assert not torch.allclose(got.float(), want.float(), rtol=DECODE_RTOL, atol=DECODE_ATOL)


def _tile_flash(q, k, v, *, causal=True, q_offset=0, kv_len=None, bm=128, bn=64):
    """csrc/flash_attention_bf16.cu: the (s, g) rows of one (batch, kv head)
    in q's order, cut into tiles of ``bm`` rows; key tiles of ``bn`` keys;
    per row and key tile an online-softmax step with the tile's max; p
    rounded to bf16 for P.V; keys past T take no part (-inf, V rows of
    zeros).  A row tile whose rows all see a key skips the key tiles wholly
    above its last row's diagonal or at or past kv_len; otherwise it walks
    all of T."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    kv_len = T if kv_len is None else kv_len
    R, n_kt = S * G, -(-T // bn)
    qs = (q * FA.scale_for(D, q.dtype)).float().permute(0, 2, 1, 3, 4).reshape(B, K, R, D)
    pad = n_kt * bn - T
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    rows = torch.arange(R)
    q_pos = q_offset + rows // G
    # key tiles each row tile walks
    tile = rows // bm
    s_first = q_offset + (tile * bm) // G
    s_last = q_offset + torch.clamp((tile * bm + bm - 1) // G, max=S - 1)
    all_see = (s_first >= 0 if causal else torch.ones(R, dtype=torch.bool)) & (kv_len > 0)
    end = torch.full((R,), min(T, kv_len) if kv_len > 0 else T)
    if causal:
        end = torch.minimum(end, s_last + 1)
    n_used = torch.where(all_see, -(-end // bn), torch.full((R,), n_kt))
    m = torch.full((B, K, R), DA.NEG)
    l = torch.zeros((B, K, R))
    acc = torch.zeros((B, K, R, D))
    for j in range(n_kt):
        k_pos = j * bn + torch.arange(bn)
        s = torch.einsum("bkrd,bktd->bkrt", qs, kf[:, :, j * bn:(j + 1) * bn])
        mask = k_pos[None, :] < kv_len
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(mask, s, torch.full_like(s, DA.NEG))
        s = torch.where(k_pos < T, s, torch.full_like(s, float("-inf")))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        pv = torch.einsum("bkrt,bktd->bkrd", p.to(q.dtype).float(), vf[:, :, j * bn:(j + 1) * bn])
        live = j < n_used
        l = torch.where(live, l * alpha + p.sum(-1), l)
        acc = torch.where(live[:, None], acc * alpha[..., None] + pv, acc)
        m = torch.where(live, m_new, m)
    out = (acc / torch.clamp(l[..., None], min=1e-30)).reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)
    return out.to(q.dtype)


# chip_smoke.py's phase-3 shapes, then the cases the tiles can break: S and T
# one off a tile multiple, q_offset > 0 with S < T, kv_len 0 and 1, G 128,
# a causal offset that leaves the first rows no key
TILE_FLASH = [
    ((2, 1792, 1792, 2, 7, 64), {}),
    ((2, 100, 130, 2, 7, 64), {"q_offset": 30}),
    ((1, 33, 33, 1, 4, 32), {"kv_len": 20, "causal": False}),
    ((1, 65, 63, 2, 3, 64), {}),
    ((1, 63, 129, 1, 5, 16), {"q_offset": 66}),
    ((1, 40, 40, 1, 2, 128), {"kv_len": 0}),
    ((1, 40, 40, 1, 2, 32), {"kv_len": 1}),
    ((1, 3, 70, 1, 128, 64), {"q_offset": 67}),
    ((1, 30, 30, 1, 3, 64), {"q_offset": -5}),
    ((1, 130, 130, 2, 1, 112), {}),
]


@pytest.mark.parametrize("shape,kw", TILE_FLASH)
def test_tile_flash_emulation_matches_chunked(shape, kw):
    B, S, T, K, G, D = shape
    rng = np.random.default_rng(S * 7 + T + G)
    _, (q, k, v) = _inputs(rng, "bfloat16", (B, S, K, G, D), (B, T, K, D), (B, T, K, D))
    got = _tile_flash(q, k, v, **kw)
    want = FA.attend_chunked(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=FLASH_RTOL, atol=FLASH_ATOL)


def test_tile_flash_limits_reject_a_key_dropped_from_long_rows():
    # rows of 1700 keys, whose outputs are a few hundredths: one key moves them by about 0.04
    rng = np.random.default_rng(5)
    _, (q, k, v) = _inputs(rng, "bfloat16", (2, 1792, 2, 7, 64), (2, 1792, 2, 64), (2, 1792, 2, 64))
    got = _tile_flash(q, k, v, causal=False, kv_len=1700)
    torch.testing.assert_close(got.float(), FA.attend_chunked(q, k, v, causal=False, kv_len=1700).float(),
                               rtol=FLASH_RTOL, atol=FLASH_ATOL)
    want = FA.attend_chunked(q, k, v, causal=False, kv_len=1701)
    assert not torch.allclose(got.float(), want.float(), rtol=FLASH_RTOL, atol=FLASH_ATOL)


def test_tile_flash_limits_reject_a_causal_mask_one_key_off():
    rng = np.random.default_rng(5)
    _, (q, k, v) = _inputs(rng, "bfloat16", (2, 100, 2, 7, 64), (2, 130, 2, 64), (2, 130, 2, 64))
    got, want = _tile_flash(q, k, v, q_offset=30), FA.attend_chunked(q, k, v, q_offset=31)
    assert not torch.allclose(got.float(), want.float(), rtol=FLASH_RTOL, atol=FLASH_ATOL)
