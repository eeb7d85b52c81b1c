"""The plain versions of the port's integer kernels against the JAX package:
``evict_select``, ``freq_update`` and ``freq_lookup`` bit-equal to
``repro/kernels/*/ref.py`` and to the Pallas kernels in interpret mode, on
seeded streams with ties, conflicts, saturation and ``-1`` padding; the
port's frequency-table class and prefetch gate against the JAX host ones.
(The CUDA kernels are held against these plain versions on the card:
tests/test_torch_kernels_gpu.py and chip_smoke.py.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import policy as JPol
from repro.kernels.evict_select import kernel as JEK
from repro.kernels.evict_select import ref as JER
from repro.kernels.freq_table import kernel as JFK
from repro.kernels.freq_table import ref as JFR
from repro.uvm.manager import core as JM
from repro_torch.core import policy as PPol
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import evict_select as ES
from repro_torch.kernels import freq_table as FT
from repro_torch.uvm.manager import core as PM

# (n_blocks, n_keys, key_lo, key_hi, n_evict)
EVICT = [
    (128, 3, 0, 8, 17),
    (128, 4, -4, 4, 31),
    (256, 1, 0, 2, 64),
    (512, 3, -1000, 1000, 5),
    (96, 2, 0, 3, 200),
    (256, 3, 0, 3, 0),
    (1500, 4, -2, 2, 700),
]


@pytest.mark.parametrize("nb,nk,lo,hi,ne", EVICT)
def test_evict_select_plain_matches_ref_and_pallas(nb, nk, lo, hi, ne):
    rng = np.random.default_rng(nb * 7 + nk + ne)
    cand = rng.random(nb) < 0.6
    keys = tuple(rng.integers(lo, hi + 1, nb).astype(np.int32) for _ in range(nk))
    before = dict(LAUNCHES)
    got = ES.evict_select(torch.tensor(cand), tuple(torch.tensor(k) for k in keys),
                          torch.tensor(ne, dtype=torch.int32)).numpy()
    assert LAUNCHES == before  # a CPU tensor never counts as a kernel launch
    np.testing.assert_array_equal(got, np.asarray(JER.evict_select_ref(cand, keys, ne)))
    np.testing.assert_array_equal(got, np.asarray(JEK.evict_select(cand, keys, ne, interpret=True)))
    assert got.sum() == min(ne, cand.sum())


def _stream(rng, n, n_sets, *, pad):
    """Conflict-heavy: hot sets get many distinct blocks; a hot block saturates."""
    hot = rng.integers(0, n_sets, 4)
    b = np.where(rng.random(n) < 0.5, hot[rng.integers(0, 4, n)] + n_sets * rng.integers(0, 30, n),
                 rng.integers(0, 3 * n_sets, n))
    b[rng.random(n) < 0.3] = 5
    if pad:
        b[rng.random(n) < 0.05] = -1
        b = np.concatenate([b, -np.ones(pad, np.int64)])
    return b.astype(np.int32)


@pytest.mark.parametrize("n_sets,n,rounds", [(1024, 2048, 2), (16, 300, 3)])
def test_freq_update_lookup_plain_match_ref_and_pallas(n_sets, n, rounds):
    rng = np.random.default_rng(n_sets + n)
    tags = np.full((n_sets, 16), -1, np.int32)
    cnt = np.zeros((n_sets, 16), np.int32)
    pt, pc = torch.tensor(tags), torch.tensor(cnt)
    for _ in range(rounds):
        blocks = _stream(rng, n, n_sets, pad=37)
        rt, rc = (np.asarray(a) for a in JFR.freq_update_ref(tags, cnt, blocks))
        kt, kc = (np.asarray(a) for a in JFK.freq_update(tags, cnt, blocks, interpret=True))
        FT.freq_update(pt, pc, torch.tensor(blocks))
        for want_t, want_c in ((rt, rc), (kt, kc)):
            np.testing.assert_array_equal(pt.numpy(), want_t)
            np.testing.assert_array_equal(pc.numpy(), want_c)
        tags, cnt = rt, rc
        q = np.concatenate([_stream(rng, n // 2, n_sets, pad=0), [-1, 5, 0]]).astype(np.int32)
        got = FT.freq_lookup(pt, pc, torch.tensor(q)).numpy()
        np.testing.assert_array_equal(got, np.asarray(JFR.freq_lookup_ref(tags, cnt, q)))
        np.testing.assert_array_equal(got, np.asarray(JFK.freq_lookup(tags, cnt, q, interpret=True)))
    assert cnt.max() == FT.COUNTER_MAX  # the streams saturated a counter


def test_freq_update_plain_empty_and_all_padding():
    t = torch.full((8, 16), -1, dtype=torch.int32)
    c = torch.zeros((8, 16), dtype=torch.int32)
    FT.freq_update(t, c, torch.zeros(0, dtype=torch.int32))
    FT.freq_update(t, c, torch.full((64,), -1, dtype=torch.int32))
    assert (t == -1).all() and (c == 0).all()


def test_wrappers_check_their_inputs():
    t = torch.full((8, 16), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        FT.freq_update(t, t.clone(), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        FT.freq_lookup(t[:, :8].contiguous(), t[:, :8].contiguous(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ES.evict_select(torch.ones(4, dtype=torch.bool), (), torch.tensor(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        ES.evict_select(torch.ones(4, dtype=torch.bool), (torch.zeros(4, dtype=torch.int32),) * 5,
                        torch.tensor(1, dtype=torch.int32))


def test_frequency_table_class_matches_host_table():
    rng = np.random.default_rng(11)
    j, p = JPol.PredictionFrequencyTable(), PPol.PredictionFrequencyTable(device="cpu")
    loop = JPol.LoopPredictionFrequencyTable()
    for step in range(6):
        blocks = _stream(rng, 1500, 1024, pad=0).astype(np.int64)
        for t in (j, p, loop):
            t.update(blocks)
        np.testing.assert_array_equal(p.tags.numpy(), j.tags)
        np.testing.assert_array_equal(p.counters.numpy(), j.counters)
        np.testing.assert_array_equal(j.tags, loop.tags)
        q = np.concatenate([blocks[:300], rng.integers(0, 5000, 50)])
        np.testing.assert_array_equal(p.lookup_many(q).numpy(), j.lookup_many(q))
        assert p.lookup(5) == j.lookup(5)
        for nb in (256, 4096):
            np.testing.assert_array_equal(p.dense(nb).numpy(), j.dense(nb))
        np.testing.assert_array_equal(PPol.rank_prefetches(p, q[:40], 10), JPol.rank_prefetches(j, q[:40], 10))
        for t in (j, p, loop):
            t.on_intervals(step % 2 + 1)
        assert (p.flushes, p.intervals_since_flush) == (j.flushes, j.intervals_since_flush)
    assert p.storage_bits() == j.storage_bits()
    with pytest.raises(ValueError):
        p.update(np.array([2**31]))


@pytest.mark.parametrize("last_acc", [0.95, 0.65, 0.3])
@pytest.mark.parametrize("cap", [3, 40, 500])
def test_prefetch_mask_matches(last_acc, cap):
    rng = np.random.default_rng(int(last_acc * 100) + cap)
    nb = 256
    dense = rng.integers(-1, 8, nb).astype(np.int32)
    pred_pages = rng.integers(0, nb * 16 + 200, 900)  # some predicted blocks lie past nb
    want = JM.prefetch_mask(dense, pred_pages, last_acc, nb, cap)
    got = PM.prefetch_mask(torch.tensor(dense), pred_pages, last_acc, nb, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not PM.prefetch_mask(torch.tensor(dense), np.zeros(0, np.int64), last_acc, nb, cap).any()
