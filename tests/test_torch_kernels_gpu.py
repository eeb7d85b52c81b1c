"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips where no CUDA device is
visible (the CPU tests hold the plain versions against the JAX package).
On a machine with a card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
from __future__ import annotations

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


@pytest.mark.parametrize("nb", [1, 37, 256, 512, 3000])
@pytest.mark.parametrize("n_keys", [1, 3, 4])
def test_evict_select_matches_plain(dev, nb, n_keys):
    rng = np.random.default_rng(nb * 10 + n_keys)
    for _ in range(4):
        cand = torch.tensor(rng.random(nb) < 0.5, device=dev)
        keys = tuple(torch.tensor(rng.integers(-2, 2, nb, dtype=np.int32), device=dev) for _ in range(n_keys))
        n_cand = int(cand.sum())
        for n in sorted({0, 1, n_cand // 2, n_cand, n_cand + 3}):
            ne = torch.tensor(n, dtype=torch.int32, device=dev)
            before = kernels.LAUNCHES["evict_select"]
            got = ES.evict_select(cand, keys, ne)
            assert kernels.LAUNCHES["evict_select"] == before + 1
            assert torch.equal(got, ES.evict_select_plain(cand, keys, ne))
            assert int(got.sum()) == min(n, n_cand)


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
# other running maxima (per key in the kernel, per chunk in the plain
# version), each p off by up to 2^-9 of itself on either side (an H100
# needed atol 0.0027 at rtol 2^-7 on the 1792-token case)
_TOL = {("flash", "float32"): (1e-5, 1e-6), ("flash", "bfloat16"): (2.0 ** -7, 4e-3),
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
])
def test_ssd_scan_matches_plain(dev, dtype, B, L, H, P, N, chunk, dt_shift):
    args = _ssd_inputs(dev, dtype, B, L, H, P, N, seed=L + P + N, dt_shift=dt_shift)
    before = kernels.LAUNCHES["ssd_scan"]
    got = SS.ssd_scan(*args, chunk=chunk)
    assert kernels.LAUNCHES["ssd_scan"] == before + 1
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    assert torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()
    _ssd_close(got, SS.ssd_scan_plain(*args, chunk), dtype)


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
