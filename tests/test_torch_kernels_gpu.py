"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips where no CUDA device is
visible (the CPU tests hold the plain versions against the JAX package).
On a machine with a card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import evict_select as ES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import freq_table as FT
from repro_torch.kernels import ssd_scan as SS

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("nb", [1, 33, 37, 256, 512, 600, 3000])
@pytest.mark.parametrize("n_keys", [1, 3, 4])
def test_evict_select_matches_plain(dev, nb, n_keys):
    rng = np.random.default_rng(nb * 10 + n_keys)
    for _ in range(4):
        cand = torch.tensor(rng.random(nb) < 0.5, device=dev)
        keys = tuple(torch.tensor(rng.integers(-2, 2, nb, dtype=np.int32), device=dev) for _ in range(n_keys))
        n_cand = int(cand.sum())
        for n in sorted({0, 1, 64, n_cand // 2, n_cand, n_cand + 3, n_cand + 7}):
            ne = torch.tensor(n, dtype=torch.int32, device=dev)
            before = kernels.LAUNCHES["evict_select"]
            got = ES.evict_select(cand, keys, ne)
            assert kernels.LAUNCHES["evict_select"] == before + 1
            assert torch.equal(got, ES.evict_select_plain(cand, keys, ne))
            assert int(got.sum()) == min(n, n_cand)


def _freq_stream(kind, rng, n_sets):
    """The streams of tests/test_torch_freq_table.py (which emulates the
    kernel's order of work on them on the CPU)."""
    if kind == "long_runs":  # runs of 33-100 entries, and one of 5,000 across two tile boundaries
        runs = [np.full(rng.integers(33, 101), rng.integers(0, 4 * n_sets)) for _ in range(40)]
        runs.insert(7, np.full(5000, 3 * n_sets + 5))
        return np.concatenate(runs)
    if kind == "distinct":  # one set hit by 300 distinct blocks, interleaved with others
        hot = 3 * n_sets // 4 + n_sets * rng.permutation(300)
        return np.where(rng.random(3000) < 0.6, hot[rng.integers(0, 300, 3000)], rng.integers(0, 8 * n_sets, 3000))
    b = rng.integers(-3 * n_sets, 2 * n_sets, 4500)  # saturating blocks, -1 padding, other negative no-ops
    b[rng.random(4500) < 0.35] = 7
    b[rng.random(4500) < 0.1] = -1
    b[-300:] = -1
    return b


@pytest.mark.parametrize("n_sets", [1024, 24])
@pytest.mark.parametrize("kind", ["long_runs", "distinct", "saturate_pad"])
def test_freq_update_runs_and_distinct_blocks_match_plain(dev, kind, n_sets):
    rng = np.random.default_rng(len(kind) * 31 + n_sets)
    tags = torch.full((n_sets, 16), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((n_sets, 16), dtype=torch.int32, device=dev)
    for _ in range(2):
        blocks = torch.tensor(_freq_stream(kind, rng, n_sets).astype(np.int32), device=dev)
        want_t, want_c = FT.freq_update_plain(tags, cnt, blocks)
        FT.freq_update(tags, cnt, blocks)
        assert torch.equal(tags, want_t) and torch.equal(cnt, want_c)
    if kind != "distinct":
        assert int(cnt.max()) == FT.COUNTER_MAX


def test_freq_update_takes_a_stream_off_a_16_byte_boundary(dev):
    """Each lane reads eight entries, 16 bytes at a time where it can: a
    view into a larger buffer reads them one by one, with the same bits."""
    rng = np.random.default_rng(8)
    b = _freq_stream("distinct", rng, 1024).astype(np.int32)
    buf = torch.empty(b.size + 1, dtype=torch.int32, device=dev)
    view = buf[1:]
    view.copy_(torch.tensor(b, device=dev))
    tags = torch.full((1024, 16), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((1024, 16), dtype=torch.int32, device=dev)
    want_t, want_c = FT.freq_update_plain(tags, cnt, view)
    FT.freq_update(tags, cnt, view)
    assert torch.equal(tags, want_t) and torch.equal(cnt, want_c)


@pytest.mark.parametrize("n", [1, 64, 2048, 5000])
def test_freq_table_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    tags = torch.full((1024, 16), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((1024, 16), dtype=torch.int32, device=dev)
    for _ in range(4):
        b = np.where(rng.random(n) < 0.5, rng.integers(0, 4, n) * 1024 * 3 + rng.integers(0, 30, n) * 1024,
                     rng.integers(0, 200, n))
        b[rng.random(n) < 0.3] = 5
        b[rng.random(n) < 0.1] = -1
        blocks = torch.tensor(b.astype(np.int32), device=dev)
        want_t, want_c = FT.freq_update_plain(tags, cnt, blocks)
        FT.freq_update(tags, cnt, blocks)
        assert torch.equal(tags, want_t) and torch.equal(cnt, want_c)
        q = torch.tensor(np.concatenate([b, [-1, 0, 5]]).astype(np.int32), device=dev)
        assert torch.equal(FT.freq_lookup(tags, cnt, q), FT.freq_lookup_plain(tags, cnt, q))


@pytest.mark.parametrize("shape,kw", [
    ((256, 10, 10, 2, 1, 32), {}),
    ((3, 37, 37, 2, 3, 64), {}),
    ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
    ((2, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}),
    ((1, 1, 40, 2, 4, 128), {"q_offset": 39}),
    ((2, 200, 200, 1, 1, 8), {}),
])
def test_flash_attention_matches_plain(dev, shape, kw):
    B, S, T, K, G, D = shape
    rng = np.random.default_rng(B * S + D)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    q, k, v = mk(B, S, K, G, D), mk(B, T, K, D), mk(B, T, K, D)
    got = FA.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, FA.attend_chunked(q, k, v, **kw), rtol=1e-5, atol=1e-6)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (rtol, atol) per kernel and dtype.  bf16 decode: the plain version has the
# kernel's rounding points and differs only in the order of its float32
# sums, which can flip the bf16 output by one ulp (at most 2^-7 of it).
# bf16 flash: the output may also flip one ulp, and p is rounded against
# other running maxima (per 64-key tile in the kernel, per chunk in the
# plain version), each p off by up to 2^-9 of itself on either side (on an
# H100 the tile kernel needs atol 0.0009-0.0011 at rtol 2^-7; a first kernel
# with a per-key max needed 0.0027, when the limit was 4e-3)
_TOL = {("flash", "float32"): (1e-5, 1e-6), ("flash", "bfloat16"): (2.0 ** -7, 2e-3),
        ("decode", "float32"): (1e-5, 1e-6), ("decode", "bfloat16"): (2.0 ** -7, 1e-5)}


def _mk(rng, dtype, dev):
    return lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).to(_DTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", [
    ((2, 1792, 1792, 2, 7, 64), {}),
    ((2, 100, 130, 2, 7, 64), {"q_offset": 30}),
    ((1, 33, 33, 1, 4, 32), {"kv_len": 20}),
])
def test_flash_attention_bf16_and_f32_match_plain(dev, dtype, shape, kw):
    B, S, T, K, G, D = shape
    mk = _mk(np.random.default_rng(S + G), dtype, dev)
    q, k, v = mk(B, S, K, G, D), mk(B, T, K, D), mk(B, T, K, D)
    name = "flash_attention" if dtype == "float32" else "flash_attention_bf16"
    before = kernels.LAUNCHES[name]
    got = FA.flash_attention(q, k, v, **kw)
    assert kernels.LAUNCHES[name] == before + 1 and got.dtype == q.dtype
    rtol, atol = _TOL["flash", dtype]
    torch.testing.assert_close(got.float(), FA.attend_chunked(q, k, v, **kw).float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,D,T,kv_len", [
    (2, 2, 7, 64, 2048, 1), (2, 2, 7, 64, 2048, 511), (2, 2, 7, 64, 2048, 512),
    (2, 2, 7, 64, 2048, 513), (2, 2, 7, 64, 2048, 1800), (2, 2, 7, 64, 2048, 2048),
    (1, 2, 1, 128, 520, 520), (3, 1, 4, 32, 64, 40), (2, 2, 16, 64, 700, 650),
])
def test_decode_attention_matches_plain(dev, dtype, B, K, G, D, T, kv_len):
    mk = _mk(np.random.default_rng(T + kv_len + G), dtype, dev)
    q, k, v = mk(B, K, G, D), mk(B, T, K, D), mk(B, T, K, D)
    before = kernels.LAUNCHES["decode_attention"]
    got = DA.decode_attention_kernelcall(q, k, v, kv_len)
    assert kernels.LAUNCHES["decode_attention"] == before + 1 and got.dtype == q.dtype
    rtol, atol = _TOL["decode", dtype]
    torch.testing.assert_close(got.float(), DA.decode_attention_plain(q, k, v, kv_len).float(), rtol=rtol, atol=atol)


# the bf16 flash kernel's tiles (64 (s, g) rows, 64 keys) and its causal
# tile skipping: S and T one off a tile multiple, q_offset > 0 with S < T,
# kv_len 0 and 1, G 128, D 16 and 128, and a causal offset that leaves the
# first rows no key (the full walk)
@pytest.mark.parametrize("shape,kw", [
    ((1, 65, 63, 2, 3, 64), {}),
    ((1, 129, 129, 1, 1, 64), {}),
    ((2, 63, 129, 2, 7, 64), {"q_offset": 66}),
    ((1, 63, 129, 1, 5, 16), {"q_offset": 66}),
    ((1, 40, 40, 1, 2, 128), {"kv_len": 0}),
    ((1, 40, 40, 1, 2, 32), {"kv_len": 1}),
    ((1, 3, 70, 1, 128, 64), {"q_offset": 67}),
    ((1, 30, 30, 1, 3, 64), {"q_offset": -5}),
    ((1, 100, 200, 2, 4, 64), {"causal": False, "kv_len": 130}),
])
def test_flash_attention_bf16_tiles_match_plain(dev, shape, kw):
    B, S, T, K, G, D = shape
    mk = _mk(np.random.default_rng(S * 7 + T + G), "bfloat16", dev)
    q, k, v = mk(B, S, K, G, D), mk(B, T, K, D), mk(B, T, K, D)
    before = kernels.LAUNCHES["flash_attention_bf16"]
    got = FA.flash_attention(q, k, v, **kw)
    assert kernels.LAUNCHES["flash_attention_bf16"] == before + 1 and got.dtype == q.dtype
    rtol, atol = _TOL["flash", "bfloat16"]
    torch.testing.assert_close(got.float(), FA.attend_chunked(q, k, v, **kw).float(), rtol=rtol, atol=atol)


# the split-K decode kernel's chunks (64 keys) and 512-key blocks: kv_len 0
# (every chunk runs, V averaged) and 1, T one off a chunk, G 16 and G * D 1024
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,D,T,kv_len", [
    (2, 2, 7, 64, 2048, 0), (1, 2, 3, 32, 65, 65), (1, 1, 2, 16, 63, 0), (2, 1, 5, 128, 1025, 1),
    (2, 2, 16, 64, 2048, 2048), (1, 2, 16, 64, 577, 520), (1, 2, 8, 128, 1000, 999),
])
def test_decode_attention_chunks_match_plain(dev, dtype, B, K, G, D, T, kv_len):
    mk = _mk(np.random.default_rng(T + kv_len + G + D), dtype, dev)
    q, k, v = mk(B, K, G, D), mk(B, T, K, D), mk(B, T, K, D)
    before = kernels.LAUNCHES["decode_attention"]
    got = DA.decode_attention_kernelcall(q, k, v, kv_len)
    assert kernels.LAUNCHES["decode_attention"] == before + 1 and got.dtype == q.dtype
    rtol, atol = _TOL["decode", dtype]
    torch.testing.assert_close(got.float(), DA.decode_attention_plain(q, k, v, kv_len).float(), rtol=rtol, atol=atol)


def test_flash_attention_bf16_limits_reject_a_key_dropped_from_long_rows(dev):
    mk = _mk(np.random.default_rng(13), "bfloat16", dev)
    q, k, v = mk(2, 1792, 2, 7, 64), mk(2, 1792, 2, 64), mk(2, 1792, 2, 64)
    got = FA.flash_attention(q, k, v, causal=False, kv_len=1700).float()
    rtol, atol = _TOL["flash", "bfloat16"]
    torch.testing.assert_close(got, FA.attend_chunked(q, k, v, causal=False, kv_len=1700).float(),
                               rtol=rtol, atol=atol)
    want = FA.attend_chunked(q, k, v, causal=False, kv_len=1701).float()
    assert not torch.allclose(got, want, rtol=rtol, atol=atol)


def test_decode_attention_rejects_an_empty_cache(dev):
    q, kv = torch.zeros(1, 1, 2, 64, device=dev), torch.zeros(1, 0, 1, 64, device=dev)
    with pytest.raises(ValueError, match="at least one key"):
        DA.decode_attention_kernelcall(q, kv, kv, 0)


@pytest.mark.parametrize("kernel", ["flash_bf16", "decode_bf16", "decode_f32", "flash_f32", "flash_bwd_f32"])
def test_attention_kernels_repeat_bit_for_bit(dev, kernel):
    if kernel == "flash_bf16":
        mk = _mk(np.random.default_rng(11), "bfloat16", dev)
        q, k, v = mk(2, 1792, 2, 7, 64), mk(2, 1792, 2, 64), mk(2, 1792, 2, 64)
        run = lambda: FA.flash_attention(q, k, v)
    elif kernel.startswith("flash"):  # the predictor's shape
        mk = _mk(np.random.default_rng(13), "float32", dev)
        q, k, v, do = mk(256, 10, 2, 1, 32), mk(256, 10, 2, 32), mk(256, 10, 2, 32), mk(256, 10, 2, 1, 32)
        run = (lambda: FA.flash_attention(q, k, v)) if kernel == "flash_f32" else \
            (lambda: torch.cat([g.flatten() for g in FA.flash_attention_bwd(q, k, v, do)]))
    else:
        mk = _mk(np.random.default_rng(12), "bfloat16" if kernel == "decode_bf16" else "float32", dev)
        q, k, v = mk(2, 2, 7, 64), mk(2, 2048, 2, 64), mk(2, 2048, 2, 64)
        run = lambda: DA.decode_attention_kernelcall(q, k, v, 1800)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


def test_flash_attention_bf16_rejects_the_widths_it_does_not_take(dev):
    for D in (8, 24):  # 8: the float32 kernel's only; 24: neither
        q, kv = torch.zeros(1, 4, 1, 1, D, device=dev), torch.zeros(1, 4, 1, D, device=dev)
        with pytest.raises(ValueError, match="head widths"):
            FA.flash_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
    FA.flash_attention(torch.zeros(1, 4, 1, 1, 8, device=dev), torch.zeros(1, 4, 1, 8, device=dev),
                       torch.zeros(1, 4, 1, 8, device=dev))  # float32 keeps D 8
    with pytest.raises(ValueError, match="16-byte"):  # bf16 storage off a 16-byte boundary
        kv = torch.zeros(4 * 64 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 4, 1, 64)
        FA.flash_attention(torch.zeros(1, 4, 1, 1, 64, device=dev, dtype=torch.bfloat16), kv, kv)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    cand = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        ES.evict_select(cand, (torch.zeros(8, dtype=torch.int64, device=dev),), torch.tensor(1, device=dev))
    q = torch.zeros(1, 4, 1, 1, 24, device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention(q, torch.zeros(1, 4, 1, 24, device=dev), torch.zeros(1, 4, 1, 24, device=dev))
    q = torch.zeros(1, 4, 1, 1, 64, device=dev)
    with pytest.raises(ValueError):  # mixed dtypes
        FA.flash_attention(q, torch.zeros(1, 4, 1, 64, device=dev, dtype=torch.bfloat16),
                           torch.zeros(1, 4, 1, 64, device=dev, dtype=torch.bfloat16))
    kv = torch.zeros(1, 8, 1, 64, device=dev)
    with pytest.raises(ValueError):  # more than 16 query heads per kv head
        DA.decode_attention_kernelcall(torch.zeros(1, 1, 17, 64, device=dev), kv, kv, 8)
    with pytest.raises(ValueError):  # k and v must be 16-byte aligned
        kv2 = torch.zeros(8 * 64 + 1, device=dev)[1:].view(1, 8, 1, 64)
        DA.decode_attention_kernelcall(torch.zeros(1, 1, 2, 64, device=dev), kv2, kv2, 8)
    with pytest.raises(ValueError):  # float16 is not built
        DA.decode_attention_kernelcall(torch.zeros(1, 1, 2, 64, device=dev, dtype=torch.float16), kv.half(),
                                       kv.half(), 8)


# ssd_scan against its plain version: the same float32 function with sums in
# other orders (at the serve widths outputs reach about +-400 and the plain
# version is off a float64 evaluation by up to 2e-3, the state, of up to
# about 18, by 1.4e-4, and an H100's kernel was 3.1e-4 from the plain
# state), plus in bf16 one ulp of y (the float32 sums may round it to either
# neighbour).  A dropped diagonal or an unread state moves y by about 1 or more
_SSD_TOL = {"float32": {"y": (1e-5, 4e-3), "state": (1e-5, 1e-3)},
            "bfloat16": {"y": (2.0 ** -7, 4e-3), "state": (1e-5, 1e-3)}}


def _ssd_inputs(dev, dtype, B, L, H, P, N, seed, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, L, H)), 0.0) + dt_shift).astype(np.float32)
    A_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    b, c = (rng.standard_normal((B, L, N)).astype(np.float32) for _ in range(2))
    td = _DTYPES[dtype]
    return (torch.tensor(x, device=dev).to(td), torch.tensor(dt, device=dev).to(td), torch.tensor(A_log, device=dev),
            torch.tensor(b, device=dev).to(td), torch.tensor(c, device=dev).to(td))


def _ssd_close(got, want, dtype) -> None:
    tol = _SSD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol["y"][0], atol=tol["y"][1])
    torch.testing.assert_close(got[1], want[1], rtol=tol["state"][0], atol=tol["state"][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,N,chunk,dt_shift", [
    (2, 2048, 32, 64, 128, 256, 0.0),  # one layer of the mamba2-370m serve prefill
    (1, 512, 4, 64, 128, 256, 0.0),
    (1, 256, 4, 64, 128, 64, 4.3),  # dt about 5: the masked exp overflows
    (2, 128, 4, 16, 32, 32, 0.0),
    (1, 64, 2, 32, 16, 16, 0.0),
    (1, 200, 2, 48, 64, 100, 0.0),  # chunks of 100: ragged tiles; P 48: slices of 16
    (1, 256, 2, 64, 128, 256, 0.0),  # one chunk (L = Q), B * H = 2
    (2, 64, 1, 32, 64, 64, 0.0),  # one chunk, B * H = 2, P 32
    (1, 1024, 2, 64, 128, 1024, 0.0),  # the longest chunk: 16 row tiles
    (1, 512, 2, 128, 32, 128, 0.0),  # P 128: two slices of 64
])
def test_ssd_scan_matches_plain(dev, dtype, B, L, H, P, N, chunk, dt_shift):
    args = _ssd_inputs(dev, dtype, B, L, H, P, N, seed=L + P + N, dt_shift=dt_shift)
    before = kernels.LAUNCHES["ssd_scan"]
    got = SS.ssd_scan(*args, chunk=chunk)
    assert kernels.LAUNCHES["ssd_scan"] == before + 1
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    assert torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()
    _ssd_close(got, SS.ssd_scan_plain(*args, chunk), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_repeats_bit_for_bit_and_takes_unaligned_views(dev, dtype):
    """No atomics: a call repeats bit for bit.  x, b and c off a 16-byte
    boundary (views into a larger buffer) give the same bits."""
    args = _ssd_inputs(dev, dtype, 2, 512, 4, 64, 128, seed=3)
    y, st = SS.ssd_scan(*args, chunk=256)
    for _ in range(3):
        y2, st2 = SS.ssd_scan(*args, chunk=256)
        assert torch.equal(y, y2) and torch.equal(st, st2)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    x, dt, A_log, b, c = args
    y3, st3 = SS.ssd_scan(shifted(x), dt, A_log, shifted(b), shifted(c), chunk=256)
    assert torch.equal(y, y3) and torch.equal(st, st3)


def _ssd_no_carry(x, dt, A_log, b, c, chunk):
    """A defective plain version: no state carried into the second chunk."""
    y0, _ = SS.ssd_scan_plain(x[:, :chunk], dt[:, :chunk], A_log, b[:, :chunk], c[:, :chunk], chunk)
    y1, state = SS.ssd_scan_plain(x[:, chunk:], dt[:, chunk:], A_log, b[:, chunk:], c[:, chunk:], chunk)
    return torch.cat([y0, y1], 1), state


def _ssd_no_diagonal(x, dt, A_log, b, c, chunk):
    """A defective plain version: key j = i left out of query i's sum."""
    a = -torch.exp(A_log.float())
    state = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]), device=x.device)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril(-1)
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        state, y = SS.ssd_chunk_plain(state, x[:, sl].float(), dt[:, sl].float(), a, b[:, sl].float(),
                                      c[:, sl].float(), mask)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, 1), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("defect", [_ssd_no_diagonal, _ssd_no_carry])
def test_ssd_scan_limits_reject_a_defective_plain_version(dev, dtype, defect):
    args = _ssd_inputs(dev, dtype, 2, 512, 8, 64, 128, seed=9)
    with pytest.raises(AssertionError):
        _ssd_close(SS.ssd_scan(*args, chunk=256), defect(*args, 256), dtype)


def test_ssd_scan_rejects_what_the_kernel_does_not_take(dev):
    x, dt, A_log, b, c = _ssd_inputs(dev, "bfloat16", 1, 64, 2, 16, 16, seed=1)
    with pytest.raises(NotImplementedError):
        SS.ssd_scan(x, dt, A_log, b, c, chunk=16, initial_state=torch.zeros(1, 2, 16, 16, device=dev))
    with pytest.raises(ValueError):  # ragged sequence
        SS.ssd_scan(x[:, :40].contiguous(), dt[:, :40].contiguous(), A_log, b[:, :40].contiguous(),
                    c[:, :40].contiguous(), chunk=16)
    with pytest.raises(ValueError):  # mixed dtypes
        SS.ssd_scan(x, dt.float(), A_log, b, c, chunk=16)
    with pytest.raises(ValueError):  # not contiguous
        SS.ssd_scan(torch.zeros(1, 64, 2, 32, device=dev, dtype=torch.bfloat16)[..., :16], dt, A_log, b, c, chunk=16)
    with pytest.raises(ValueError):  # mixed devices
        SS.ssd_scan(x, dt, A_log.cpu(), b, c, chunk=16)
    x8 = torch.zeros(1, 64, 2, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head width not a multiple of 16
        SS.ssd_scan(x8, dt, A_log, b, c, chunk=16)
    b48 = torch.zeros(1, 64, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # state width not built
        SS.ssd_scan(x, dt, A_log, b48, b48, chunk=16)


# the limits of chip_smoke.py (THRASH_LOSS_TOL, THRASH_GRAD_TOL, ATTN_BWD_TOL), whose comments give the reasons
THRASH_LOSS_TOL, THRASH_GRAD_TOL = (1e-5, 1e-6), (1e-5, 1e-9)
ATTN_BWD_TOL = (1e-4, 1e-5)


def _thrash_inputs(dev, B, V, n_active, seed):
    rng = np.random.default_rng(seed)
    logits = torch.tensor((3 * rng.standard_normal((B, V))).astype(np.float32), device=dev)
    labels = torch.tensor(rng.integers(0, n_active, B).astype(np.int32), device=dev)
    et = torch.tensor(rng.random(B) < 0.3, device=dev)
    return logits, labels, et


def _thrash_loss_and_grad(fn, logits, *args):
    lg = logits.clone().requires_grad_(True)
    loss = fn(lg, *args)
    (g,) = torch.autograd.grad(loss, lg)
    return loss.detach(), g


def _thrash_close(got, want) -> bool:
    return (torch.allclose(got[0], want[0], rtol=THRASH_LOSS_TOL[0], atol=THRASH_LOSS_TOL[1])
            and torch.allclose(got[1], want[1], rtol=THRASH_GRAD_TOL[0], atol=THRASH_GRAD_TOL[1]))


@pytest.mark.parametrize("B,V,n_active,mu", [(256, 1024, 700, 0.5), (256, 1024, 8, 1.6), (32, 32, 20, 0.5),
                                             (128, 4096, 4000, 0.9), (1, 64, 64, 0.0)])
def test_thrash_ce_forward_and_backward_match_plain(dev, B, V, n_active, mu):
    from repro_torch.kernels import thrash_ce as TC

    logits, labels, et = _thrash_inputs(dev, B, V, n_active, seed=B + V)
    before = (kernels.LAUNCHES["thrash_ce_fwd"], kernels.LAUNCHES["thrash_ce_bwd"])
    got = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, et, n_active, mu)
    assert (kernels.LAUNCHES["thrash_ce_fwd"], kernels.LAUNCHES["thrash_ce_bwd"]) == (before[0] + 1, before[1] + 1)
    want = _thrash_loss_and_grad(TC.thrash_ce_plain, logits, labels, et, n_active, mu)
    assert _thrash_close(got, want), (float(got[0]), float(want[0]), float((got[1] - want[1]).abs().max()))
    assert bool((got[1][:, n_active:] == 0).all())


@pytest.mark.parametrize("defect", ["no_mask", "no_weight"])
@pytest.mark.parametrize("B,V,n_active", [(256, 1024, 700), (32, 32, 20)])
def test_thrash_ce_limits_reject_a_defective_plain_version(dev, defect, B, V, n_active):
    from repro_torch.kernels import thrash_ce as TC

    logits, labels, et = _thrash_inputs(dev, B, V, n_active, seed=V)
    bad = {"no_mask": lambda lg, lab, e, na, mu: TC.thrash_ce_plain(lg, lab, e, lg.shape[-1], mu),
           "no_weight": lambda lg, lab, e, na, mu: TC.thrash_ce_plain(lg, lab, torch.zeros_like(e), na, mu)}[defect]
    got = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, et, n_active, 0.5)
    assert not _thrash_close(got, _thrash_loss_and_grad(bad, logits, labels, et, n_active, 0.5))


def _device_ops(fn, iters=5) -> float:
    """Operations (kernels, copies, fills) the device ran per call of fn.
    The profiled window is padded with 20 ms of idle host time at each end:
    the profiler keeps only the device events whose time, on the host's
    clock, falls inside its window, and a window of a few short launches can
    lose some or all of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        time.sleep(0.02)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    n = sum(1 for ev in prof.profiler.kineto_results.events() if ev.device_type() == torch.autograd.DeviceType.CUDA)
    return n / iters


def test_thrash_ce_launches_one_device_kernel_per_forward_and_backward(dev):
    """The mean is taken in the forward kernel (no second launch) and the
    backward is one kernel, with the trainer's int32 flags (bool flags cost
    a cast)."""
    from repro_torch.kernels import thrash_ce as TC

    logits, labels, et = _thrash_inputs(dev, 256, 1024, 700, seed=1)
    et = et.to(torch.int32)
    g = torch.ones((), device=dev)
    lg = logits.clone().requires_grad_(True)
    assert _device_ops(lambda: TC.thrash_ce(logits, labels, et, 700)) == 1
    assert _device_ops(lambda: TC.thrash_ce(lg, labels, et, 700)) == 1
    loss = TC.thrash_ce(lg, labels, et, 700)
    assert _device_ops(lambda: torch.autograd.grad(loss, lg, g, retain_graph=True)) == 1


@pytest.mark.parametrize("B,V,n_active", [(256, 1024, 700), (32, 32, 20), (1, 64, 64), (1280, 300, 299)])
def test_thrash_ce_gradient_is_the_recomputing_kernels_bit_for_bit(dev, B, V, n_active):
    """The backward from the forward's saved (m, s) equals, bit for bit, the
    backward kernel recomputing them from the logits (the first version's
    formula), and both the loss and the gradient repeat bit for bit."""
    from repro_torch.kernels import thrash_ce as TC

    logits, labels, et = _thrash_inputs(dev, B, V, n_active, seed=1)
    loss, grad = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, et, n_active, 0.5)
    recomputed = TC.thrash_ce_bwd(logits, labels, et, n_active, 0.5, torch.ones((), device=dev))
    assert torch.equal(grad, recomputed)
    for _ in range(3):
        again = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, et, n_active, 0.5)
        assert torch.equal(again[0], loss) and torch.equal(again[1], grad)
    assert torch.equal(TC.thrash_ce(logits, labels, et, n_active, 0.5), loss)  # no-grad path: the same kernel


def test_thrash_ce_flags_none_and_int64_labels(dev):
    """``in_et=None`` is all-zero flags and int64 labels are int32 labels,
    bit for bit; bool flags are int32 flags."""
    from repro_torch.kernels import thrash_ce as TC

    logits, labels, et = _thrash_inputs(dev, 256, 1024, 700, seed=2)
    base = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, torch.zeros_like(et), 700, 0.5)
    for lab, flags in ((labels, None), (labels.long(), torch.zeros_like(et)), (labels.long(), None)):
        got = _thrash_loss_and_grad(TC.thrash_ce, logits, lab, flags, 700, 0.5)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    want = _thrash_loss_and_grad(TC.thrash_ce_plain, logits, labels, None, 700, 0.5)
    assert _thrash_close(base, want)
    flagged = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, et, 700, 0.5)
    as_int = _thrash_loss_and_grad(TC.thrash_ce, logits, labels, et.to(torch.int32), 700, 0.5)
    assert torch.equal(flagged[0], as_int[0]) and torch.equal(flagged[1], as_int[1])


def _attn_bwd_inputs(dev, B, S, T, K, G, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    return mk(B, S, K, G, D), mk(B, T, K, D), mk(B, T, K, D), mk(B, S, K, G, D)


def _attn_close(got, want) -> bool:
    return all(torch.allclose(a, b, rtol=ATTN_BWD_TOL[0], atol=ATTN_BWD_TOL[1]) for a, b in zip(got, want))


@pytest.mark.parametrize("shape,kw", [
    ((256, 10, 10, 2, 1, 32), {}),
    ((256, 10, 10, 2, 1, 8), {}),
    ((32, 10, 10, 2, 1, 8), {"kv_len": 6}),
    ((4, 10, 10, 2, 1, 32), {"causal": False, "kv_len": 7}),
    ((3, 37, 37, 2, 3, 64), {}),
    ((2, 5, 70, 1, 2, 16), {"q_offset": 65}),
    ((1, 64, 64, 1, 1, 128), {}),
])
def test_flash_attention_backward_matches_plain(dev, shape, kw):
    q, k, v, do = _attn_bwd_inputs(dev, *shape, seed=sum(shape))
    before = kernels.LAUNCHES["flash_attention_bwd"]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention(*leaves, **kw).backward(do)
    assert kernels.LAUNCHES["flash_attention_bwd"] == before + 1
    got = [t.grad for t in leaves]
    assert _attn_close(got, FA.attention_grads_plain(q, k, v, do, **kw))


def test_flash_attention_backward_limits_reject_a_dropped_causal_mask(dev):
    q, k, v, do = _attn_bwd_inputs(dev, 256, 10, 10, 2, 1, 32, seed=1)
    got = FA.flash_attention_bwd(q, k, v, do)
    with torch.enable_grad():
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = (FA.attend_chunked(qq, kk, vv).detach() + FA.attend_chunked(qq, kk, vv, causal=False)
               - FA.attend_chunked(qq, kk, vv, causal=False).detach())
        bad = torch.autograd.grad(out, (qq, kk, vv), do)
    assert not _attn_close(got, bad)


def test_backward_wrappers_reject_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels import thrash_ce as TC

    q, k, v, _ = _attn_bwd_inputs(dev, 1, 600, 600, 1, 1, 32, seed=0)
    with pytest.raises(ValueError, match="shared memory"):  # a head's tiles do not fit
        FA.flash_attention(q.requires_grad_(True), k, v)
    qb, kb, vb = (t.detach().bfloat16().requires_grad_(True) for t in _attn_bwd_inputs(dev, 1, 8, 8, 1, 1, 32, 0)[:3])
    with pytest.raises(ValueError, match="float32 only"):
        FA.flash_attention(qb, kb, vb)
    logits, labels, et = _thrash_inputs(dev, 64, 32, 10, seed=0)
    with pytest.raises(ValueError, match="float32"):
        TC.thrash_ce(logits.bfloat16(), labels, et, 10)
    with pytest.raises(ValueError, match="multiple"):
        TC.thrash_ce(torch.zeros(200, 32, device=dev), torch.zeros(200, dtype=torch.int32, device=dev),
                     torch.zeros(200, dtype=torch.bool, device=dev), 10)


# the float32 forward's tiles (a block takes 64 query rows at D <= 16, 32 at
# D 32, 16 at 64 and 8 at 128; keys in tiles of 32) and the backward's whole
# head per block: rows and keys past one tile, G > 1 up to 128, q_offset,
# kv_len < T, fully masked rows (kv_len 0; a negative q_offset), D 8 and 128
F32_TILE_CASES = [
    ((2, 40, 70, 1, 2, 16), {"q_offset": 30}),
    ((1, 2, 70, 1, 128, 16), {"q_offset": 67}),
    ((2, 10, 10, 2, 1, 32), {"kv_len": 0}),
    ((2, 12, 12, 1, 1, 32), {"q_offset": -3}),
    ((256, 10, 10, 2, 1, 8), {"causal": False, "kv_len": 6}),
    ((2, 17, 65, 1, 1, 128), {"causal": False}),
    ((2, 33, 33, 2, 1, 64), {"kv_len": 31}),
]


@pytest.mark.parametrize("shape,kw", F32_TILE_CASES)
def test_flash_attention_f32_tiles_match_plain(dev, shape, kw):
    q, k, v, do = _attn_bwd_inputs(dev, *shape, seed=sum(shape) + 5)
    before = dict(kernels.LAUNCHES)
    got = FA.flash_attention(q, k, v, **kw)
    grads = FA.flash_attention_bwd(q, k, v, do, **kw)
    assert kernels.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    torch.testing.assert_close(got, FA.attend_chunked(q, k, v, **kw), rtol=1e-5, atol=1e-6)
    assert _attn_close(grads, FA.attention_grads_plain(q, k, v, do, **kw))


def test_flash_attention_f32_takes_inputs_off_a_16_byte_boundary(dev):
    """Contiguous q, k, v and dO that start 4 bytes past a 16-byte boundary
    take the kernels' scalar loads, with the same bits as aligned copies."""
    shape = (4, 10, 10, 2, 1, 32)
    q, k, v, do = _attn_bwd_inputs(dev, *shape, seed=7)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    qs, ks, vs, dos = (shifted(t) for t in (q, k, v, do))
    assert torch.equal(FA.flash_attention(qs, ks, vs), FA.flash_attention(q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(FA.flash_attention_bwd(qs, ks, vs, dos),
                                                 FA.flash_attention_bwd(q, k, v, do)))


def test_flash_attention_f32_launches_one_device_operation_per_call(dev):
    """The forward and the backward are one kernel each, with nothing
    launched beside them (the backward's three gradients share one
    allocation, which launches nothing)."""
    q, k, v, do = _attn_bwd_inputs(dev, 256, 10, 10, 2, 1, 32, seed=3)
    assert _device_ops(lambda: FA.flash_attention(q, k, v)) == 1
    assert _device_ops(lambda: FA.flash_attention_bwd(q, k, v, do)) == 1


def test_flash_attention_f32_kernels_do_not_spill_at_head_widths_up_to_64(dev, tmp_path):
    """``ptxas -v`` reports no spill stores or loads for the float32 forward
    and backward at D 8, 16, 32 and 64 (the log ``chip_smoke.py`` prints)."""
    import re
    import subprocess

    from repro_torch.kernels._lib import CSRC, LIBRARY, NVCC_FLAGS

    seen = {}
    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        out = subprocess.run([LIBRARY.nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src), "-o",
                              str(tmp_path / (src + ".o"))], capture_output=True, text=True)
        assert out.returncode == 0, out.stderr
        entry = None
        for line in (out.stdout + out.stderr).splitlines():
            m = re.search(r"Compiling entry function '.*(fa_(?:fwd|bwd)_kernel)ILi(\d+)E", line)
            if m:
                entry = (m[1], int(m[2]))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and entry:  # every instantiation at this width (aligned or not)
                seen[entry] = seen.get(entry, 0) + int(m[1]) + int(m[2])
                entry = None
    for name in ("fa_fwd_kernel", "fa_bwd_kernel"):
        for D in (8, 16, 32, 64):
            assert seen[(name, D)] == 0, f"{name}<{D}> spills {seen[(name, D)]} bytes"


def test_tree_cell_and_uvmsmart_on_the_card_equal_the_cpu(dev):
    """Table VI's baseline cell (``lru`` + ``tree``) and UVMSmart on Srad-v2
    (periodic windows, tree epochs) on the card equal the port's CPU runs:
    counters, per-access outputs and every state array."""
    import dataclasses

    from repro_torch.uvm import simulator as S
    from repro_torch.uvm import trace as T
    from repro_torch.uvm.uvmsmart import run_uvmsmart

    tr = T.get_trace("Srad-v2", 0.25)
    before = kernels.LAUNCHES["evict_select"]
    got = S.run(tr, policy="lru", prefetch="tree", device=dev)
    assert kernels.LAUNCHES["evict_select"] > before
    want = S.run(tr, policy="lru", prefetch="tree", device="cpu")
    assert got.stats == want.stats and got.stats["migrated_blocks"] > got.stats["faults"]
    for f in dataclasses.fields(S.SimState):
        assert torch.equal(getattr(got.state, f.name).cpu(), getattr(want.state, f.name)), f.name
    for k in ("fault", "thrash", "was_evicted"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    before = kernels.LAUNCHES["evict_select"]
    assert run_uvmsmart(tr, device=dev) == run_uvmsmart(tr, device="cpu")
    assert kernels.LAUNCHES["evict_select"] > before


@pytest.mark.parametrize("kw", [{}, {"shared_freq_table": True}, {"multi_tenant": False}],
                         ids=["mux", "mux-shared", "merged"])
def test_tagged_run_ours_on_the_card_equals_the_cpu(dev, kw):
    """The tenant path of ``run_ours`` (frozen, from the SMOKE pretrain memo)
    on a two-tenant merge: the card's run equals the port's CPU run in every
    counter and accuracy, with each frozen-path kernel launched (the
    frequency table's update in five or six rounds on the CPU)."""
    from pathlib import Path

    from repro_torch.configs.predictor_paper import SMOKE
    from repro_torch.core.incremental import TrainConfig
    from repro_torch.uvm import runtime as R
    from repro_torch.uvm import trace as T

    memo = Path(__file__).resolve().parent.parent / "experiments" / "cache" / "pretrain_e8919be312ea6abc.pkl"
    tr = T.concurrent([T.get_trace(n, 0.4).slice(0, 3000) for n in ("StreamTriad", "Hotspot")], seed=0,
                      slice_len=512)
    tc = TrainConfig(group_size=512, epochs=0, batch_size=64)
    before = dict(kernels.LAUNCHES)
    got = R.run_ours(tr, SMOKE, tc, table=R.load_pretrain_memo(memo, SMOKE, dev), device=dev, **kw)
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("evict_select", "freq_update", "flash_attention")}
    want = R.run_ours(tr, SMOKE, tc, table=R.load_pretrain_memo(memo, SMOKE, "cpu"), device="cpu", **kw)
    fields = ("stats", "top1", "warm_top1", "per_group_acc", "n_predictions", "per_tenant_top1", "per_tenant_stats")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert min(launched.values()) > 0, launched
