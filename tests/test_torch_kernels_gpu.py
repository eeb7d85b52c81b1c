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
from repro_torch.kernels import evict_select as ES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import freq_table as FT

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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    cand = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        ES.evict_select(cand, (torch.zeros(8, dtype=torch.int64, device=dev),), torch.tensor(1, device=dev))
    q = torch.zeros(1, 4, 1, 1, 24, device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention(q, torch.zeros(1, 4, 1, 24, device=dev), torch.zeros(1, 4, 1, 24, device=dev))
