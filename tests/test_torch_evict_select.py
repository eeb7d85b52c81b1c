"""The algorithm of the port's ``evict_select`` CUDA kernel
(``src/repro_torch/csrc/evict_select.cu``), emulated in PyTorch on the CPU:
rank every candidate by counting the candidates that come before it in
(k0, k1, k2, k3, index) order, with the kernel's packing of the keys into
two 64-bit words, its thread blocks of ``PER_BLOCK`` candidates, its warps
of ``LANES`` threads that split one count, and its tiles of ``TILE`` staged
tuples; a candidate is a victim when its rank is below ``n_evict``.

Held bit-exact, as every integer result of the port is, against the JAX
package's TPU kernel in interpret mode and against the port's plain
version, on seeded keys with heavy ties; a defective emulation that breaks
ties by a key instead of by index is shown to fail.  (The CUDA kernel is
held against the plain version on a card: tests/test_torch_kernels_gpu.py
and chip_smoke.py.)
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.evict_select import kernel as JEK
from repro_torch.kernels import evict_select as ES

# the kernel's constants (kPerBlock = kThreads / 32, a warp's lanes, kTile)
PER_BLOCK, LANES, TILE = 8, 32, 2048


def _packed(keys, nb):
    """The kernel's two words per block: (k0, k1) and (k2, k3), each key
    biased by 2^31.  The kernel compares them as unsigned 64-bit integers;
    flipping the top bit, as here, gives int64 words in the same order."""
    ks = [k.long() for k in keys] + [torch.zeros(nb, dtype=torch.long)] * (4 - len(keys))
    return ks[0] * 2 ** 32 + (ks[1] + 2 ** 31), ks[2] * 2 ** 32 + (ks[3] + 2 ** 31)


def rank_by_count(cand, keys, n_evict: int, tie: str = "index"):
    """Victim mask by the kernel's algorithm; ``tie="key"`` is a defect:
    tied tuples are ordered by the leading key (so never) instead of by
    index."""
    nb = cand.shape[0]
    hi, lo = _packed(keys, nb)
    k0 = keys[0].long()
    vict = torch.zeros(nb, dtype=torch.bool)
    for blk in range(max(1, -(-nb // PER_BLOCK))):
        i = torch.arange(blk * PER_BLOCK, min((blk + 1) * PER_BLOCK, nb))
        parts = torch.zeros(len(i), LANES, dtype=torch.long)  # each lane's count
        for t0 in range(0, nb, TILE):
            j = torch.arange(t0, min(t0 + TILE, nb))
            tied = k0[j][None, :] < k0[i][:, None] if tie == "key" else j[None, :] < i[:, None]
            eq_hi = hi[j][None, :] == hi[i][:, None]
            eq_lo = lo[j][None, :] == lo[i][:, None]
            before = (hi[j][None, :] < hi[i][:, None]) | eq_hi & ((lo[j][None, :] < lo[i][:, None]) | eq_lo & tied)
            counted = (before & cand[j][None, :] & cand[i][:, None]).long()
            for lane in range(LANES):  # lane `lane` counts the tile's j = lane, lane + LANES, ...
                parts[:, lane] += counted[:, lane::LANES].sum(1)
        rank = parts.sum(1)  # the warp's shuffle sum
        vict[i] = cand[i] & (rank < n_evict)
    return vict


def _case(nb, n_keys, seed):
    """Candidates and heavily tied keys: each key takes 3 values, so at NB
    600 four keys leave about seven blocks per distinct tuple."""
    rng = np.random.default_rng(seed)
    cand = rng.random(nb) < 0.6
    keys = tuple(rng.integers(-1, 2, nb).astype(np.int32) for _ in range(n_keys))
    if nb > 2:
        keys[0][:2] = np.iinfo(np.int32).min, np.iinfo(np.int32).max  # the bias's edges
    return cand, keys


def _n_evicts(cand):
    n = int(cand.sum())
    return sorted({0, 1, n // 2, n, n + 7})


@pytest.mark.parametrize("nb", [1, 31, 256, 300, 600])
@pytest.mark.parametrize("n_keys", [1, 2, 3, 4])
def test_rank_by_count_matches_the_tpu_kernel_and_plain(nb, n_keys):
    cand, keys = _case(nb, n_keys, seed=nb * 5 + n_keys)
    tc, tk = torch.tensor(cand), tuple(torch.tensor(k) for k in keys)
    for n in _n_evicts(cand):
        got = rank_by_count(tc, tk, n)
        want_plain = ES.evict_select_plain(tc, tk, torch.tensor(n, dtype=torch.int32))
        want_tpu = np.asarray(JEK.evict_select(cand, keys, n, interpret=True))
        assert torch.equal(got, want_plain), (nb, n_keys, n)
        np.testing.assert_array_equal(got.numpy(), want_tpu)
        assert int(got.sum()) == min(n, int(cand.sum()))


def test_rank_by_count_tiles_past_the_staged_tuples():
    """Above ``TILE`` blocks the kernel stages the tuples in tiles."""
    cand, keys = _case(TILE + 300, 3, seed=7)
    tc, tk = torch.tensor(cand), tuple(torch.tensor(k) for k in keys)
    for n in (1, 700, int(cand.sum()) + 7):
        want = ES.evict_select_plain(tc, tk, torch.tensor(n, dtype=torch.int32))
        assert torch.equal(rank_by_count(tc, tk, n), want)


@pytest.mark.parametrize("nb,n_keys", [(31, 1), (256, 3), (600, 4)])
def test_a_tie_broken_by_a_key_instead_of_by_index_fails(nb, n_keys):
    cand, keys = _case(nb, n_keys, seed=nb * 5 + n_keys)
    tc, tk = torch.tensor(cand), tuple(torch.tensor(k) for k in keys)
    wrong = 0
    for n in _n_evicts(cand):
        want = ES.evict_select_plain(tc, tk, torch.tensor(n, dtype=torch.int32))
        wrong += not torch.equal(rank_by_count(tc, tk, n, tie="key"), want)
    assert wrong > 0
