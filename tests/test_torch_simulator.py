"""The port's simulator against the JAX package, bit for bit: event
compression, ``run_segment`` (including the rerun on plain run-length
events when a periodic aggregate faults) and ``apply_prefetch`` — counters,
per-access outputs and every state array — for the lru, hpe, belady and
learned policies with demand migration, over several traces and
capacities.  The ``tree`` prefetcher, ``run`` and ``run_batch`` are held in
``tests/test_torch_tables.py``."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.uvm import simulator as JS
from repro.uvm import trace as JT
from repro_torch.kernels import evict_select as ES
from repro_torch.uvm import simulator as PS
from repro_torch.uvm import trace as PT

FIELDS = [f.name for f in dataclasses.fields(PS.SimState)]


def _assert_state_equal(j, p):
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name,scale", [("Hotspot", 0.25), ("StreamTriad", 0.25), ("ATAX", 0.25), ("NW", 0.5)])
def test_compress_events_equal(name, scale):
    t = JT.get_trace(name, scale)
    b = t.block.astype(np.int32)
    nxt_j, nxt_p = JS.next_use_for(t), PS.next_use_for(PT.get_trace(name, scale))
    np.testing.assert_array_equal(nxt_j, nxt_p)
    for lo, hi in ((0, len(b)), (len(b) // 3, len(b) // 3 + 700)):
        for periodic in (False, True):
            ej = JS.compress_events(b[lo:hi], nxt_j[lo:hi], periodic=periodic)
            ep = PS.compress_events(b[lo:hi], nxt_p[lo:hi], periodic=periodic)
            assert ej.n_access == ep.n_access
            for f in ("blk", "nxt", "dt", "rl", "stride"):
                np.testing.assert_array_equal(getattr(ej, f), getattr(ep, f), err_msg=f)
    assert JS._periodic_windows(b) == PS._periodic_windows(b)
    for n in (1, 40, 100, 1000):
        assert (JS.bucket_blocks(n), JS.pad_blocks(n)) == (PS.bucket_blocks(n), PS.pad_blocks(n))
        assert JS.capacity_for(n, 1.5) == PS.capacity_for(n, 1.5)


# (trace, scale, oversubscription, segments)
CELLS = [
    ("Hotspot", 0.25, 1.5, 3),
    ("StreamTriad", 0.25, 40.0, 2),  # periodic aggregates fault (capacity 2 < period 3): rerun on plain RLE
    ("StreamTriad", 0.25, 1.25, 2),  # periodic windows that stay fault-free
    ("ATAX", 0.25, 1.25, 2),
    ("Backprop", 0.25, 1.5, 1),
]


@pytest.mark.parametrize("policy", ["lru", "hpe", "belady", "learned"])
@pytest.mark.parametrize("name,scale,oversub,n_seg", CELLS)
def test_run_segment_and_apply_prefetch_equal(name, scale, oversub, n_seg, policy):
    tj, tp = JT.get_trace(name, scale), PT.get_trace(name, scale)
    rng = np.random.default_rng(len(tj) + int(oversub * 100))
    nb = PS.bucket_blocks(tp.n_blocks)
    cap = PS.capacity_for(tp.n_blocks, oversub)
    blocks = tp.block.astype(np.int32)
    nxt = PS.next_use_for(tp)
    ps = PS.init_state(nb, "cpu")
    js = JS.init_state(nb)
    _assert_state_equal(js, ps)
    bounds = np.linspace(0, len(tp), n_seg + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if policy == "learned":  # the manager's dense counter export
            freq = rng.integers(-1, 64, nb).astype(np.int32)
            ps = dataclasses.replace(ps, freq=torch.tensor(freq))
            js = js._replace(freq=np.asarray(freq))
        if lo > 0:  # staged prefetches between segments, then evict to fit
            mask = rng.random(nb) < 0.2
            mask[tp.n_blocks:] = False
            js = JS.apply_prefetch(js, mask, capacity=cap, policy=policy)
            ps = PS.apply_prefetch(ps, torch.tensor(mask), capacity=cap, policy=policy)
            _assert_state_equal(js, ps)
        js, jo = JS.run_segment(js, blocks[lo:hi], nxt[lo:hi], capacity=cap, policy=policy,
                                prefetch="demand", n_valid=tj.n_blocks)
        ps, po = PS.run_segment(ps, blocks[lo:hi], nxt[lo:hi], capacity=cap, policy=policy,
                                prefetch="demand", n_valid=tp.n_blocks)
        _assert_state_equal(js, ps)
        for k in ("fault", "thrash", "was_evicted"):
            assert jo[k].dtype == po[k].dtype, k
            np.testing.assert_array_equal(jo[k], po[k], err_msg=k)
    assert int(ps.occupancy) <= cap


def test_periodic_rerun_is_exercised():
    """The cells above include one whose periodic aggregates fault (so
    run_segment must rerun on plain RLE events) and one where they do not."""
    seen = set()
    for oversub in (40.0, 1.25):
        t = PT.get_trace("StreamTriad", 0.25)
        nb, cap = PS.bucket_blocks(t.n_blocks), PS.capacity_for(t.n_blocks, oversub)
        lo, hi = 0, len(t) // 2
        ev = PS.compress_events(t.block[lo:hi].astype(np.int32), PS.next_use_for(t)[lo:hi], periodic=True)
        assert (ev.stride > 1).any()
        out = PS._scan_events(PS.init_state(nb, "cpu"), ev, cap, "lru")
        seen.add(bool(out["pfault"]))
    assert seen == {True, False}


def test_evict_fit_takes_the_lexicographic_minimum():
    """One eviction step = the first n_evict candidates in key order (the
    property that lets one victim-selection call replace the loop)."""
    rng = np.random.default_rng(5)
    st = PS.init_state(128, "cpu")
    st.resident[:100] = True
    st.occupancy.fill_(100)
    st.last_access.copy_(torch.tensor(rng.integers(0, 10, 128), dtype=torch.int32))
    cand = st.resident.clone()
    cand[7] = False
    keys = PS.POLICY_KEYS["lru"](st, torch.tensor(0, dtype=torch.int32))
    want = ES.evict_select_plain(cand, keys, torch.tensor(100 - 60, dtype=torch.int32))
    PS._evict_fit(st, 60, "lru", 7, torch.tensor(0, dtype=torch.int32))
    assert int(st.occupancy) == 60
    np.testing.assert_array_equal(st.evicted_once.numpy(), want.numpy())


def test_unported_cells_raise():
    st = PS.init_state(128, "cpu")
    for pol, pf in (("random", "demand"), ("random", "tree"), ("lru", "stride")):
        with pytest.raises(NotImplementedError):
            PS.run_segment(st, np.zeros(4, np.int32), np.zeros(4, np.int32), capacity=4, policy=pol,
                           prefetch=pf, n_valid=1)
