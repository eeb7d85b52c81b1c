"""The CUDA ``freq_update`` kernel's order of work, emulated on the CPU and
held bit for bit against the port's plain version and the JAX package's
Pallas kernel in interpret mode.

The kernel (``src/repro_torch/csrc/freq_table.cu``) gives each block of
eight warps eight sets, one warp per set.  Per tile of 2,048 entries a
block sorts the entries of its own sets by set with a counting sort that
keeps arrival order (each lane counts its eight consecutive entries per
set, a warp scan places them among the warp's, the warps' totals place
the warp's among the block's; each entry is written at its set's start
plus those offsets), then each warp walks its set's segment 32 entries a
window: a head is an entry whose block differs from the one before it in
the set (the carried block for lane 0), the entries before a window's
first head extend the carried run, each head applies the run before it
(one way choice, one saturating ``+k``) and starts its own, and the last
run of the stream is applied at the end.  ``_emulate`` does exactly that with numpy,
window by window, and records where runs crossed a window or a tile, so the
streams below are shown to exercise the carries.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.freq_table import kernel as JFK
from repro_torch.kernels import freq_table as FT

WAYS, COUNTER_MAX = 16, 63
SETS_PER_BLOCK, TILE, WARP = 8, 2048, 32


def _apply_run(tags, cnt, s, b, k):
    row_t, row_c = tags[s], cnt[s]
    hit = np.nonzero(row_t == b)[0]
    empty = np.nonzero(row_t == -1)[0]
    if hit.size:
        way, base = hit[0], row_c[hit[0]]
    else:
        way, base = (empty[0] if empty.size else int(np.argmin(row_c))), 0
    row_t[way] = b
    row_c[way] = min(base + min(k, COUNTER_MAX), COUNTER_MAX)


def _sorted_tile(tile, set0, n_sets):
    """The block's counting sort of one tile: (list, segment starts).  Lane
    ``l`` of warp ``w`` holds entries ``8 (32 w + l)`` to ``+ 7``; its place
    for each set is the set's segment start, plus the entries of that set
    in the warps before, plus those in the lanes before it in its warp."""
    ls = np.where(tile >= 0, tile % n_sets - set0, -1)
    ls = np.where((ls >= 0) & (ls < SETS_PER_BLOCK), ls, -1)
    per = TILE // (SETS_PER_BLOCK * WARP)  # 8 consecutive entries per lane
    padded = np.full(TILE, -1)
    padded[:tile.size] = ls
    lanes = padded.reshape(SETS_PER_BLOCK, WARP, per)  # [warp, lane, k]
    counts = np.stack([(lanes == q).sum(axis=2) for q in range(SETS_PER_BLOCK)], axis=-1)  # [warp, lane, set]
    lane_before = np.cumsum(counts, axis=1) - counts  # the warp's scan over lanes, exclusive
    warp_tot = counts.sum(axis=1)  # [warp, set]
    warp_before = np.cumsum(warp_tot, axis=0) - warp_tot
    totals = warp_tot.sum(axis=0)
    seg = np.concatenate([[0], np.cumsum(totals)])
    out = np.full(seg[-1], -3)
    for w in range(SETS_PER_BLOCK):
        for lane in range(WARP):
            slot = seg[:-1] + warp_before[w] + lane_before[w, lane]
            for k in range(per):
                q = lanes[w, lane, k]
                if q >= 0:
                    out[slot[q]] = tile[(w * WARP + lane) * per + k]
                    slot[q] += 1
    assert (out != -3).all()
    return out, seg


def _emulate(tags, cnt, blocks):
    """The kernel's update, block by block and window by window; returns
    the new table and the carries seen ({"window": n, "tile": n}: runs that
    went on across a window or a tile boundary)."""
    tags, cnt = tags.copy(), cnt.copy()
    n_sets = tags.shape[0]
    carries = {"window": 0, "tile": 0}
    for set0 in range(0, n_sets, SETS_PER_BLOCK):
        state = {s: (-1, 0) for s in range(SETS_PER_BLOCK)}  # per warp: (carried block, run)
        for base in range(0, blocks.size, TILE):
            lst, seg = _sorted_tile(blocks[base:base + TILE], set0, n_sets)
            for s in range(SETS_PER_BLOCK):
                if set0 + s >= n_sets:
                    continue
                last_b, run = state[s]
                seq = lst[seg[s]:seg[s + 1]]
                for j0 in range(0, seq.size, WARP):
                    win = seq[j0:j0 + WARP]
                    prev = np.concatenate([[last_b], win[:-1]])
                    heads = np.nonzero(win != prev)[0]
                    first = heads[0] if heads.size else win.size
                    if first > 0 and run > 0:
                        carries["tile" if j0 == 0 else "window"] += 1
                    run += first  # the window's entries before its first head extend the run
                    for i, h in enumerate(heads):
                        if run > 0:
                            _apply_run(tags, cnt, set0 + s, last_b, run)
                        nxt = heads[i + 1] if i + 1 < heads.size else win.size
                        last_b, run = int(win[h]), int(nxt - h)
                state[s] = (last_b, run)
        for s, (last_b, run) in state.items():
            if run > 0:
                _apply_run(tags, cnt, set0 + s, last_b, run)
    return tags, cnt, carries


def _stream(kind, rng, n_sets):
    """Streams that exercise the kernel's order of work."""
    if kind == "long_runs":  # runs of 33-100 entries, and one of 5,000 across two tile boundaries
        runs = [np.full(rng.integers(33, 101), rng.integers(0, 4 * n_sets)) for _ in range(40)]
        runs.insert(7, np.full(5000, 3 * n_sets + 5))
        return np.concatenate(runs)
    if kind == "distinct":  # one set hit by 300 distinct blocks (way evictions), interleaved with others
        hot = 3 * n_sets // 4 + n_sets * rng.permutation(300)
        b = np.where(rng.random(3000) < 0.6, hot[rng.integers(0, 300, 3000)], rng.integers(0, 8 * n_sets, 3000))
        return b
    if kind == "saturate_pad":  # saturating blocks, -1 padding and other negative (no-op) blocks
        b = rng.integers(-3 * n_sets, 2 * n_sets, 4500)
        b[rng.random(4500) < 0.35] = 7
        b[rng.random(4500) < 0.1] = -1
        b[-300:] = -1
        return b
    if kind == "hotspot":  # one Hotspot group, the blocks the serving table streams
        from repro_torch.uvm import trace as T

        return T.get_trace("Hotspot", 1.0).page[4 * 2048:5 * 2048] // 16
    raise ValueError(kind)


@pytest.mark.parametrize("n_sets", [1024, 24])
@pytest.mark.parametrize("kind", ["long_runs", "distinct", "saturate_pad", "hotspot"])
def test_kernel_order_of_work_is_bit_exact(kind, n_sets):
    rng = np.random.default_rng(len(kind) * 31 + n_sets)
    tags = np.full((n_sets, WAYS), -1, np.int32)
    cnt = np.zeros((n_sets, WAYS), np.int32)
    seen = {"window": 0, "tile": 0}
    for _ in range(2):  # the second stream starts from the first's table (hits, conflicts)
        blocks = _stream(kind, rng, n_sets).astype(np.int32)
        got_t, got_c, carries = _emulate(tags, cnt, blocks)
        want_t, want_c = FT.freq_update_plain(torch.tensor(tags), torch.tensor(cnt), torch.tensor(blocks))
        np.testing.assert_array_equal(got_t, want_t.numpy())
        np.testing.assert_array_equal(got_c, want_c.numpy())
        jt, jc = (np.asarray(a) for a in JFK.freq_update(tags, cnt, blocks, interpret=True))
        np.testing.assert_array_equal(got_t, jt)
        np.testing.assert_array_equal(got_c, jc)
        tags, cnt = got_t, got_c
        seen = {k: seen[k] + carries[k] for k in seen}
    if kind == "long_runs":
        assert seen["window"] > 0 and seen["tile"] > 0  # runs went on across windows and tiles
    if kind in ("long_runs", "saturate_pad"):
        assert cnt.max() == COUNTER_MAX


def test_lookup_takes_the_floor_modulo_of_negative_blocks():
    """-1 and other negative blocks look up set ``b % sets`` (Python's
    floor modulo), as the JAX kernel does."""
    rng = np.random.default_rng(4)
    n_sets = 1024
    tags = np.full((n_sets, WAYS), -1, np.int32)
    cnt = np.zeros((n_sets, WAYS), np.int32)
    tags, cnt, _ = _emulate(tags, cnt, _stream("saturate_pad", rng, n_sets).astype(np.int32))
    tags[n_sets - 1, 3], tags[n_sets - 5, 0] = -1025, -5  # negative tags the lookups can hit
    cnt[n_sets - 1, 3], cnt[n_sets - 5, 0] = 9, 11
    q = np.array([-1, -5, -1025, -2049, 7, 0, 5 * n_sets - 1], np.int32)
    got = FT.freq_lookup(torch.tensor(tags), torch.tensor(cnt), torch.tensor(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JFK.freq_lookup(tags, cnt, q, interpret=True)))
    assert got[1] == 11 and got[2] == 9
