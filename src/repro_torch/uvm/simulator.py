"""Trace-driven UVM device-memory simulator, on the device.

Port of the single-lane parts of ``repro.uvm.simulator``: per-block state
arrays (residency, LRU clocks, chain intervals, Belady next-use, learned
prediction frequency) live as tensors on the simulator's device, and the
event-compressed access stream is walked by a Python loop.  On a CUDA
device two of its stores synchronise with the host once per event each:
``cand[protect] = False`` (line 339, :func:`_evict_fit`) and
``state.next_use[b] = nx`` (line 513, :func:`_scan_events`) write a Python
number into one element of a device tensor, which torch does as a copy
from pageable host memory.
Migration and eviction are at 64KB basic-block granularity; "pages
thrashed" are blocks x 16 pages.

Eviction policies (Section II-C / IV-D): ``lru``, ``belady`` (MIN oracle
from the precomputed next-use stream), ``hpe`` (page-set chain + LRU) and
``learned`` (page-set chain + prediction-frequency table) and ``random``
(uniform random resident block: the JAX package's ``randint(fold_in(key,
t), (NB,), 0, 1 << 30)`` per step, drawn on the host by
:mod:`repro_torch.random` for every event of a segment at once and staged
on the device in one copy).  Prefetchers:
``demand`` (``none`` is its alias; the learned runtime stages its own
prefetches through :func:`apply_prefetch`) and ``tree``, NVIDIA's
tree-based neighbourhood prefetcher: on a fault, every [2, 4, 8, 16,
32]-block node around the faulted block that is more than half resident
(the faulted block counted) migrates its remaining valid blocks.  Every
node lies inside the faulted block's 2MB chunk, so the builtin tree step
works on that 32-block slice of the state.  As in the reference, the
tree's mask does not exclude pinned blocks (``apply_prefetch``'s does).

Every policy and prefetcher, builtins included, is an entry of
:mod:`repro_torch.uvm.registry` (registered at the end of this module in
the reference's order, so the ids match): a policy is its key builder
``key_fn(state, interval_now, t_now)``, a prefetcher its mask builder
``mask_fn(resident, blk, valid, n_blocks)``.  A registered prefetcher's
mask migrates on every faulting event exactly what the reference's scan
migrates; the builtin ``tree`` keeps its chunk-sliced step
(:func:`_tree_migrate`), which :func:`_tree_mask` (the reference's
whole-state mask) reproduces bit for bit.

:func:`run` and :func:`run_batch` drive a whole trace, and
:func:`run_segments_many` one segment of many traces (both run their cells
or lanes one after another; the reference's batched lanes are
bit-identical to its per-lane runs).

Counters, per-access outputs and state arrays are bit-identical to the JAX
package for every ported policy:

* **event compression** is the same host numpy (plain run-length events,
  and period-p windows whose merged occurrences are verified fault-free at
  run time, with a rerun on plain RLE events when one faulted);
* **victim selection** is one :func:`repro_torch.kernels.evict_select.
  evict_select` call per step: the keys are constant for the step, so the
  victims of the JAX chained masked argmin are the first ``n_evict``
  candidates in lexicographic key order.  ``n_evict`` stays a device
  scalar; on a CUDA state the call launches the CUDA kernel every step.

The JAX scan pads its event stream with no-op events; the loop here has no
padding to skip.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.device import resolve_device
from repro_torch.kernels.evict_select import evict_select
from repro_torch.util import pow2_bucket
from repro_torch.uvm import registry as _registry
from repro_torch.uvm.registry import POLICY_IDS, PREFETCH_IDS
from repro_torch.uvm.trace import PAGES_PER_BLOCK, Trace

CHUNK_BLOCKS = 32  # 2MB chunk = 32 x 64KB blocks
INTERVAL = 64  # page-set-chain interval, in faults (same as HPE)
NO_USE = np.int32(2**31 - 1)

# The builtin strategy set (the paper's matrix).  The live set, builtins
# plus registrations, is registry.policy_names()/prefetcher_names();
# POLICY_IDS/PREFETCH_IDS always reflect it.
POLICIES = ("lru", "random", "belady", "hpe", "learned")
PREFETCHERS = ("demand", "tree", "none")
TREE_SIZES = (2, 4, 8, 16, CHUNK_BLOCKS)

_I32 = torch.int32


@dataclasses.dataclass
class SimState:
    resident: torch.Tensor  # bool (NB,)
    pinned: torch.Tensor  # bool (NB,) zero-copy blocks (never migrated)
    evicted_once: torch.Tensor  # bool (NB,)
    last_access: torch.Tensor  # int32 (NB,)
    last_interval: torch.Tensor  # int32 (NB,)
    next_use: torch.Tensor  # int32 (NB,)
    freq: torch.Tensor  # int32 (NB,) prediction frequency (-1 = never predicted)
    occupancy: torch.Tensor  # int32 scalar
    fault_count: torch.Tensor  # int32 scalar
    thrash_events: torch.Tensor  # int32 scalar (block-granular)
    migrations: torch.Tensor  # int32 scalar, blocks migrated
    faults: torch.Tensor  # int32 scalar, far-fault events
    zero_copy: torch.Tensor  # int32 scalar, remote accesses to pinned blocks
    time: torch.Tensor  # int32 scalar
    key: torch.Tensor  # int64 (2,) on the host: the random policy's PRNG key data

    def clone(self) -> "SimState":
        return SimState(*(getattr(self, f.name).clone() for f in dataclasses.fields(self)))

    @property
    def device(self) -> torch.device:
        return self.resident.device


def init_state(n_blocks: int, device: str | torch.device = "cuda", seed: int = 0) -> SimState:
    device = resolve_device(device)
    z = lambda: torch.zeros((), dtype=_I32, device=device)
    full = lambda v: torch.full((n_blocks,), int(v), dtype=_I32, device=device)
    return SimState(
        resident=torch.zeros(n_blocks, dtype=torch.bool, device=device),
        pinned=torch.zeros(n_blocks, dtype=torch.bool, device=device),
        evicted_once=torch.zeros(n_blocks, dtype=torch.bool, device=device),
        last_access=full(-1),
        last_interval=full(-1),
        next_use=full(NO_USE),
        freq=full(-1),
        occupancy=z(), fault_count=z(), thrash_events=z(), migrations=z(), faults=z(), zero_copy=z(),
        time=z(), key=jrandom.key(seed),
    )


def precompute_next_use(blocks: np.ndarray, n_blocks: int) -> np.ndarray:
    """next_use[t] = index of the next access to blocks[t] after t (else INF)."""
    b = np.asarray(blocks, np.int64)
    nxt = np.full(len(b), NO_USE, np.int64)
    if len(b):
        idx = np.arange(len(b))
        perm = np.lexsort((idx, b))  # positions grouped by block, time ascending
        same = b[perm][1:] == b[perm][:-1]
        nxt[perm[:-1][same]] = perm[1:][same]
    return np.minimum(nxt, NO_USE).astype(np.int32)


def next_use_for(trace: Trace) -> np.ndarray:
    """Per-trace cached :func:`precompute_next_use`."""
    cached = getattr(trace, "_next_use_cache", None)
    if cached is None or len(cached) != len(trace):
        cached = precompute_next_use(trace.block.astype(np.int32), trace.n_blocks)
        trace._next_use_cache = cached
    return cached


class Events(NamedTuple):
    """Compressed access stream (host side).

    One event covers ``rl`` accesses to block ``blk`` at segment offsets
    ``dt, dt + stride, ..., dt + (rl-1)*stride``.  ``nxt`` is the next-use
    index of the event's LAST covered access.  ``stride == 1`` events are
    maximal same-block runs (unconditionally exact); ``stride == p > 1``
    events merge one position of a period-p window, exact only if none of
    their covered accesses faults (checked at run time).
    """

    blk: np.ndarray  # int32 (E,)
    nxt: np.ndarray  # int32 (E,)
    dt: np.ndarray  # int32 (E,)
    rl: np.ndarray  # int32 (E,)
    stride: np.ndarray  # int32 (E,) access-index gap between covered accesses
    n_access: int  # original segment length


P_MAX = 8  # largest interleave period the host-side detector looks for
MIN_REPS = 4  # shortest window worth compressing (2p events vs ~r*p raw)


def _rle_parts(b: np.ndarray, nxt: np.ndarray, lo: int, hi: int):
    """Plain run-length events for the slice ``b[lo:hi]`` (stride == 1)."""
    n = hi - lo
    seg = b[lo:hi]
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(seg[1:], seg[:-1], out=change[1:])
    starts = (lo + np.nonzero(change)[0]).astype(np.int32)
    run_len = np.diff(np.append(starts, hi)).astype(np.int32)
    ends = starts + run_len - 1
    return seg[change], nxt[ends], starts, run_len, np.ones(len(starts), np.int32)


def _periodic_windows(b: np.ndarray) -> list[tuple[int, int, int]]:
    """Detect non-overlapping fixed-period windows: ``(start, p, reps)``.

    A window matches when ``b[t] == b[t-p]`` over its whole span.  Smaller
    periods claim coverage first; a window is kept only when its 2p events
    beat the run count plain RLE would emit for the same span.
    """
    n = len(b)
    covered = np.zeros(n, bool)
    boundary = np.empty(n, bool)  # boundary[i]: run starts at i (for the RLE-win check)
    boundary[0] = True
    np.not_equal(b[1:], b[:-1], out=boundary[1:])
    run_count = np.concatenate([[0], np.cumsum(boundary)])  # runs in b[:i] = run_count[i]
    wins = []
    for p in range(2, P_MAX + 1):
        if n < MIN_REPS * p:
            break
        m = b[p:] == b[:-p]
        edges = np.flatnonzero(np.diff(np.concatenate([[False], m, [False]]).astype(np.int8)))
        for s, e_m in zip(edges[0::2], edges[1::2]):
            length = (e_m - s) + p  # accesses b[s : s+length] are period-p
            if covered[s : s + length].any():
                bad = np.flatnonzero(covered[s : s + length])
                length = int(bad[0])
            r = length // p
            if r < MIN_REPS:
                continue
            length = r * p
            if run_count[s + length] - run_count[s] <= 2 * p:
                continue
            covered[s : s + length] = True
            wins.append((int(s), p, r))
    wins.sort()
    return wins


def compress_events(blocks: np.ndarray, next_use: np.ndarray, *, periodic: bool = False) -> Events:
    b = np.asarray(blocks, np.int32)
    nxt_arr = np.asarray(next_use, np.int32)
    n = len(b)
    if n == 0:
        e = np.zeros(0, np.int32)
        return Events(e, e, e, e, e, 0)
    wins = _periodic_windows(b) if periodic else []
    if not wins:
        return Events(*_rle_parts(b, nxt_arr, 0, n), n)
    parts = []
    pos = 0
    for s, p, r in wins:
        if pos < s:
            parts.append(_rle_parts(b, nxt_arr, pos, s))
        j = np.arange(p, dtype=np.int32)
        ones = np.ones(p, np.int32)
        # first period: ordinary events (these may fault and evict)
        parts.append((b[s + j], nxt_arr[s + j], (s + j).astype(np.int32), ones, ones))
        # aggregates: position j's occurrences 2..r, spaced p apart
        parts.append((
            b[s + j],
            nxt_arr[s + (r - 1) * p + j],  # next use after the LAST occurrence
            (s + p + j).astype(np.int32),
            np.full(p, r - 1, np.int32),
            np.full(p, p, np.int32),
        ))
        pos = s + r * p
    if pos < n:
        parts.append(_rle_parts(b, nxt_arr, pos, n))
    cat = [np.concatenate([pt[i] for pt in parts]) for i in range(5)]
    return Events(*cat, n)


def bucket_blocks(n_valid: int) -> int:
    """Power-of-two state size >= pad_blocks(n_valid), floor 128.  Padding
    blocks are never valid, never resident, and never migrated."""
    return pow2_bucket(pad_blocks(n_valid), 128)


def pad_blocks(n_valid: int) -> int:
    return int(np.ceil(n_valid / CHUNK_BLOCKS) * CHUNK_BLOCKS)


def capacity_for(n_blocks: int, oversubscription: float) -> int:
    """125% oversubscription => device memory = working set / 1.25."""
    return max(int(np.floor(n_blocks / oversubscription)), 1)


# --- victim keys (lexicographic, smallest evicted first) ---------------------


def _age(state: SimState, interval_now):
    return torch.clamp(interval_now - state.last_interval, 0, 2)  # 0=new..2=old


def _lru_keys(state: SimState, interval_now, t_now):
    return (state.last_access,)


def _belady_keys(state: SimState, interval_now, t_now):
    return (-state.next_use,)  # farthest next use evicted first


def _hpe_keys(state: SimState, interval_now, t_now):
    return (-_age(state, interval_now), state.last_access)


def _learned_keys(state: SimState, interval_now, t_now):
    return (-_age(state, interval_now), state.freq, state.last_access)


#: events per host batch of the random policy's draws
_RANDOM_CHUNK = 2048


def _random_draws(state: SimState, t_now: np.ndarray) -> torch.Tensor:
    """The random policy's victim key of each step at times ``t_now``
    (host ints): ``randint(fold_in(key, t), (NB,), 0, 1 << 30)`` per step,
    drawn on the host in batches and staged on the state's device, int32
    ``(len(t_now), NB)``."""
    nb = state.resident.shape[0]
    t = torch.as_tensor(np.asarray(t_now, np.int64))
    rows = [jrandom.randint(jrandom.fold_in(state.key, t[i : i + _RANDOM_CHUNK]), (nb,), 0, 1 << 30)
            for i in range(0, len(t), _RANDOM_CHUNK)]
    return torch.cat(rows).to(state.device) if rows else torch.zeros((0, nb), dtype=_I32, device=state.device)


def _random_keys(state: SimState, interval_now, t_now):
    """The ``random`` policy's key builder for one step (one host read of
    ``t_now``).  The event loop does not call it: it draws a whole
    segment's keys at once (:func:`_random_draws`)."""
    return (_random_draws(state, [int(t_now)])[0],)


def _policy_fn(policy: str):
    """The registered key builder of ``policy`` (``KeyError`` if it is not
    registered, as the reference's id lookup raises)."""
    return _registry.policy_branches()[POLICY_IDS[policy]]


def _evict_fit(state: SimState, capacity: int, key_fn, protect: int | None, interval_now, t_now,
               evict_pref=None, rand: torch.Tensor | None = None) -> None:
    """Evict lowest-priority resident blocks until occupancy <= capacity, in
    place.  One victim-selection call takes all
    ``min(max(occ - capacity, 0), |candidates|)`` victims of the keys
    ``key_fn(state, interval_now, t_now)`` returns; ``evict_pref`` (int32
    per block, optional) is the leading key; ``rand`` is the random
    policy's key for this step (:func:`_random_draws`), used in place of
    ``key_fn``'s."""
    cand = state.resident & ~state.pinned
    if protect is not None:
        cand[protect] = False
    if rand is not None:
        keys = (rand,)
    else:
        keys = tuple(key_fn(state, interval_now, t_now))
        if not 1 <= len(keys) <= 3:
            raise ValueError(f"policy key_fn must return 1-3 keys, got {len(keys)}")
        keys = tuple(torch.as_tensor(k, device=state.device).to(_I32) for k in keys)
    if evict_pref is not None:
        keys = (evict_pref,) + keys
    n_evict = torch.minimum(torch.clamp(state.occupancy - capacity, min=0), cand.sum(dtype=_I32))
    vict = evict_select(cand, keys, n_evict)
    state.resident &= ~vict
    state.evicted_once |= vict
    state.occupancy -= vict.sum(dtype=_I32)


def _tree_mask(resident, blk, valid, n_blocks: int):
    """Blocks to prefetch per the tree-based neighbourhood prefetcher, over
    the whole state (the reference's mask builder; the builtin ``tree``
    runs the chunk-sliced :func:`_tree_migrate` instead)."""
    iota = torch.arange(n_blocks, device=resident.device)
    mask = torch.zeros(n_blocks, dtype=torch.bool, device=resident.device)
    for size in TREE_SIZES:
        node = blk // size
        occ = resident.reshape(-1, size).sum(dim=1)[node]
        mask |= ((iota // size) == node) & (occ * 2 > size)  # >50% of the node valid
    return mask & valid & ~resident


class _Tree(NamedTuple):
    """Device constants of the tree prefetcher's step, per block offset
    ``o`` within a chunk: ``node[o, k, j]`` says whether chunk block ``j``
    shares ``o``'s node of size ``TREE_SIZES[k]``; ``onehot[o]`` is ``o``
    alone."""

    node: torch.Tensor  # bool (32, 5, 32)
    onehot: torch.Tensor  # bool (32, 32)
    sizes: torch.Tensor  # int32 (5,)
    valid: torch.Tensor  # bool (NB,) block < n_valid
    n_valid: int
    learned: bool  # the learned policy's chain also sees prefetched blocks


class _Mask(NamedTuple):
    """A registered prefetcher's mask builder and its device constants."""

    fn: object  # mask_fn(resident, blk, valid, n_blocks) -> bool (NB,)
    valid: torch.Tensor  # bool (NB,) block < n_valid
    learned: bool


def _tree(n_blocks: int, n_valid: int, learned: bool, dev) -> _Tree:
    j = np.arange(CHUNK_BLOCKS)
    node = np.stack([j[None, :] // s == j[:, None] // s for s in TREE_SIZES], axis=1)
    return _Tree(torch.tensor(node, device=dev), torch.eye(CHUNK_BLOCKS, dtype=torch.bool, device=dev),
                 torch.tensor(TREE_SIZES, dtype=_I32, device=dev),
                 torch.arange(n_blocks, device=dev) < n_valid, n_valid, learned)


def _prefetcher(policy: str, prefetch: str, n_blocks: int, n_valid: int, dev) -> _Tree | _Mask | None:
    """The segment's prefetch step: ``None`` (demand only), the builtin
    tree's chunk constants, or a registered mask builder.  Only the
    ``learned`` policy's page-set chain sees prefetched blocks, as in the
    reference (its id 4)."""
    pid = PREFETCH_IDS[prefetch]
    fn = _registry.prefetch_branches()[pid]
    if fn is None:
        return None
    learned = POLICY_IDS[policy] == POLICY_IDS["learned"]
    if pid == PREFETCH_IDS["tree"]:
        return _tree(n_blocks, n_valid, learned, dev)
    return _Mask(fn, torch.arange(n_blocks, device=dev) < n_valid, learned)


def _mask_migrate(state: SimState, pfx: _Mask, b: int, fault, t_first, interval_now):
    """A registered prefetcher's migration for one event on block ``b``, in
    place, as the reference's scan does it: the faulted block and, if it
    faulted, the mask builder's blocks (given the residency with the
    faulted block in).  Returns the number of migrated blocks that had been
    evicted before."""
    nb = state.resident.shape[0]
    demand = torch.zeros(nb, dtype=torch.bool, device=state.device)
    demand[b] = fault
    pf = pfx.fn(state.resident | demand, b, pfx.valid, nb) & fault
    newly = (demand | pf) & ~state.resident
    n_new = newly.sum(dtype=_I32)
    thrash = (newly & state.evicted_once).sum(dtype=_I32)
    state.resident |= newly
    state.occupancy += n_new
    state.migrations += n_new
    state.last_access.copy_(torch.where(newly, t_first, state.last_access))
    if pfx.learned:
        state.last_interval.copy_(torch.where(newly, interval_now, state.last_interval))
    return thrash


def _tree_migrate(state: SimState, tree: _Tree, b: int, fault, t_first, interval_now):
    """The tree prefetcher's migration for one event on block ``b``, in
    place: the faulted block and, if it faulted, the valid non-resident
    blocks of every node around it that is more than half resident.
    Returns the number of migrated blocks that had been evicted before."""
    lo = b - b % CHUNK_BLOCKS
    chunk = slice(lo, lo + CHUNK_BLOCKS)
    res = state.resident[chunk]
    node = tree.node[b - lo]
    demand = tree.onehot[b - lo] & fault
    res1 = res | demand
    trig = (node & res1).sum(1, dtype=_I32) * 2 > tree.sizes
    pf = (node & trig[:, None]).any(0) & ~res1 & fault
    if lo + CHUNK_BLOCKS > tree.n_valid:
        pf &= tree.valid[chunk]
    newly = demand | pf  # the faulted block is never resident; pf excludes every resident block
    n_new = newly.sum(dtype=_I32)
    thrash = (newly & state.evicted_once[chunk]).sum(dtype=_I32)
    res |= newly
    state.occupancy += n_new
    state.migrations += n_new
    # prefetched blocks count as freshly used by LRU (CUDA treats migrated
    # pages as recently touched); only the learned policy's page-set chain
    # sees them (HPE's sees demand touches)
    la = state.last_access[chunk]
    la.copy_(torch.where(newly, t_first, la))
    if tree.learned:
        li = state.last_interval[chunk]
        li.copy_(torch.where(newly, interval_now, li))
    return thrash


def _scan_events(state: SimState, ev: Events, capacity: int, policy: str, evict_pref=None,
                 pfx: _Tree | _Mask | None = None) -> dict:
    """Walk the compressed event stream, updating ``state`` in place, with
    demand migration, the builtin tree's (``pfx`` a :class:`_Tree`) or a
    registered prefetcher's (``pfx`` a :class:`_Mask`).

    Returns per-event device tensors (``fault``, ``thrash``,
    ``was_evicted``) and ``pfault`` (a scalar: did any periodic aggregate
    fault?).  Every value stays on the device; the caller syncs once."""
    dev = state.device
    t0 = state.time.clone()
    key_fn = _policy_fn(policy)
    # the random policy's keys depend on each event's time: one host read
    rand = _random_draws(state, int(t0) + ev.dt) if key_fn is _random_keys else None
    faults, thrashes, was_ev = [], [], []
    pfault = torch.zeros((), dtype=torch.bool, device=dev)
    for i, (b, nx, d, r, sd) in enumerate(zip(ev.blk.tolist(), ev.nxt.tolist(), ev.dt.tolist(), ev.rl.tolist(),
                                              ev.stride.tolist())):
        t_first = t0 + d
        t_last = t_first + (r - 1) * sd
        is_pinned = state.pinned[b].clone()
        evicted_before = state.evicted_once[b].clone()
        fault = ~state.resident[b] & ~is_pinned
        fault_i = fault.to(_I32)
        interval_now = torch.div(state.fault_count, INTERVAL, rounding_mode="floor")
        fc_after = state.fault_count + fault_i
        if pfx is None:
            thrash = fault_i * evicted_before.to(_I32)
            # demand migration: the faulted block comes in; it ends the run
            # at its last touch and is protected during its own step
            state.resident[b] |= fault
            state.occupancy += fault_i
            state.migrations += fault_i
        elif isinstance(pfx, _Tree):
            thrash = _tree_migrate(state, pfx, b, fault, t_first, interval_now)
        else:
            thrash = _mask_migrate(state, pfx, b, fault, t_first, interval_now)
        state.fault_count.copy_(fc_after)
        state.thrash_events += thrash
        state.faults += fault_i
        state.zero_copy += is_pinned.to(_I32) * r
        state.last_access[b] = t_last
        # repeat touches after a fault that crosses an interval boundary
        # land in the NEXT interval (the reference updates per access)
        state.last_interval[b] = torch.div(fc_after, INTERVAL, rounding_mode="floor") if r > 1 else interval_now
        state.next_use[b] = nx
        _evict_fit(state, capacity, key_fn, b, interval_now, t_first, evict_pref,
                   None if rand is None else rand[i])
        state.time.copy_(t_last + 1)
        faults.append(fault)
        thrashes.append(thrash)
        was_ev.append(evicted_before)
        if sd > 1:  # a faulting periodic aggregate breaks the no-fault merge
            pfault |= fault
    return {"fault": faults, "thrash": thrashes, "was_evicted": was_ev, "pfault": pfault}


def _decompress_outs(outs: dict, ev: Events) -> dict:
    """Expand per-event outputs (host arrays) back to per-access arrays.
    Periodic aggregates cover interleaved access indices, so per-access
    values are scattered to ``dt + k*stride``."""
    fault = np.zeros(ev.n_access, bool)
    thrash = np.zeros(ev.n_access, np.int32)
    fault[ev.dt] = outs["fault"]
    thrash[ev.dt] = outs["thrash"]
    was_evicted = np.zeros(ev.n_access, bool)
    intra = np.arange(int(ev.rl.sum())) - np.repeat(np.cumsum(ev.rl) - ev.rl, ev.rl)
    pos = np.repeat(ev.dt, ev.rl) + intra * np.repeat(ev.stride, ev.rl)
    was_evicted[pos] = np.repeat(outs["was_evicted"], ev.rl)
    return {"fault": fault, "thrash": thrash, "was_evicted": was_evicted}


def _empty_outs() -> dict:
    z = np.zeros(0)
    return {"fault": z.astype(bool), "thrash": z.astype(np.int32), "was_evicted": z.astype(bool)}


def run_segment(
    state: SimState,
    blocks: np.ndarray,
    next_use: np.ndarray,
    *,
    capacity: int,
    policy: str,
    prefetch: str,
    n_valid: int,
    want_outs: bool = True,
    evict_pref: torch.Tensor | None = None,
):
    """Run one trace segment (compress -> event loop -> decompress) and
    return ``(new_state, outs)``; ``state`` itself is left unchanged.

    Period-p compression is tried first; if any periodic aggregate faulted,
    the segment reruns on plain run-length events, so the counters always
    equal the per-access reference.  ``n_valid`` (the real block count)
    only matters to the ``tree`` prefetcher, which never fetches a block
    past it.  ``evict_pref`` (int32 per block on the state's device, or
    ``None``) is the leading victim key for the whole segment.  An
    unregistered policy or prefetcher raises ``KeyError``."""
    _policy_fn(policy), PREFETCH_IDS[prefetch]  # an unregistered name raises KeyError
    blocks = np.asarray(blocks)
    next_use = np.asarray(next_use)
    pfx = _prefetcher(policy, prefetch, state.resident.shape[0], int(n_valid), state.device) if len(blocks) else None
    for periodic in (True, False):
        ev = compress_events(blocks, next_use, periodic=periodic)
        if ev.n_access == 0:
            return state, _empty_outs()
        st = state.clone()
        outs = _scan_events(st, ev, int(capacity), policy, evict_pref, pfx)
        if periodic and (ev.stride > 1).any() and bool(outs["pfault"]):
            continue  # divergence: a merged occurrence may have faulted
        if not want_outs:
            return st, None
        host = {k: torch.stack(outs[k]).cpu().numpy() for k in ("fault", "thrash", "was_evicted")}
        return st, _decompress_outs(host, ev)


def apply_prefetch(state: SimState, blocks_mask: torch.Tensor, *, capacity: int, policy: str = "learned",
                   evict_pref: torch.Tensor | None = None) -> SimState:
    """Stage externally-predicted prefetches (the learned runtime's async
    path): migrate the masked blocks, then evict back to capacity.
    Returns a new state."""
    key_fn = _policy_fn(policy)
    st = state.clone()
    newly = blocks_mask & ~st.resident & ~st.pinned
    n_new = newly.sum(dtype=_I32)
    thrash = (newly & st.evicted_once).sum(dtype=_I32)
    interval_now = torch.div(st.fault_count, INTERVAL, rounding_mode="floor")
    st.resident |= newly
    st.occupancy += n_new
    st.thrash_events += thrash
    st.migrations += n_new
    st.last_interval = torch.where(newly, interval_now, st.last_interval)
    st.last_access = torch.where(newly, st.time, st.last_access)
    _evict_fit(st, int(capacity), key_fn, None, interval_now, st.time, evict_pref)
    return st


def state_stats(state: SimState) -> dict:
    """The run's counters (one host sync); pages thrashed are blocks x 16."""
    thrash, faults, mig, zc, occ = torch.stack(
        [state.thrash_events, state.faults, state.migrations, state.zero_copy, state.occupancy]).tolist()
    return {"pages_thrashed": thrash * PAGES_PER_BLOCK, "faults": faults, "migrated_blocks": mig,
            "zero_copy": zc, "occupancy": occ}


class SimResult(NamedTuple):
    state: SimState  # on the run's device
    fault: np.ndarray
    thrash: np.ndarray
    was_evicted: np.ndarray

    @property
    def pages_thrashed(self) -> int:
        return int(self.state.thrash_events) * PAGES_PER_BLOCK

    @property
    def stats(self) -> dict:
        return state_stats(self.state)


def run(
    trace: Trace,
    *,
    policy: str = "lru",
    prefetch: str = "tree",
    oversubscription: float = 1.25,
    state: SimState | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> SimResult:
    """Run a full trace under (policy x prefetch) at an oversubscription
    level, from ``state`` (on its own device) or a fresh state on
    ``device`` (``seed``: the random policy's key)."""
    assert policy in POLICY_IDS and prefetch in PREFETCH_IDS, (policy, prefetch)
    if state is None:
        state = init_state(bucket_blocks(trace.n_blocks), device, seed)
    st, outs = run_segment(
        state, trace.block.astype(np.int32), next_use_for(trace),
        capacity=capacity_for(trace.n_blocks, oversubscription), policy=policy, prefetch=prefetch,
        n_valid=trace.n_blocks,
    )
    return SimResult(st, outs["fault"], outs["thrash"], outs["was_evicted"])


def run_batch(trace: Trace, cells: list[tuple[str, str, float]], *, seed: int = 0,
              seeds: list[int] | None = None, device: str | torch.device = "cuda") -> list[dict]:
    """Many (policy, prefetch, oversubscription) cells over one trace; one
    stats dict per cell.  The cells run one after another, each with its
    own rerun on plain run-length events when a periodic aggregate faults:
    the reference's batched lanes give each cell the counters of its own
    :func:`run`.  ``seeds`` (one per cell, else ``seed`` for every cell)
    key the random policy."""
    for policy, prefetch, _ in cells:
        assert policy in POLICY_IDS and prefetch in PREFETCH_IDS, (policy, prefetch)
    device = resolve_device(device)
    blocks = trace.block.astype(np.int32)
    nxt = next_use_for(trace)
    nb = bucket_blocks(trace.n_blocks)
    states = []
    for (policy, prefetch, oversub), sd in zip(cells, seeds if seeds is not None else [seed] * len(cells)):
        st, _ = run_segment(init_state(nb, device, sd), blocks, nxt, capacity=capacity_for(trace.n_blocks, oversub),
                            policy=policy, prefetch=prefetch, n_valid=trace.n_blocks, want_outs=False)
        states.append(st)
    return [state_stats(st) for st in states]


def run_segments_many(
    states: list[SimState],
    segments: list[tuple[np.ndarray, np.ndarray]],  # (blocks, next_use) per lane
    cells: list[tuple[str, str, int]],  # (policy, prefetch, capacity) per lane
    n_valids: list[int],
    *,
    want_outs: bool = True,
    evict_prefs: list | None = None,
) -> list[tuple[SimState, dict | None]]:
    """Run one trace segment per lane; one ``(new_state, outs)`` per lane.

    The lanes run one after another through :func:`run_segment` (each with
    its own rerun on plain run-length events when a periodic aggregate
    faulted), which is what the reference's bucketed vmapped lanes give each
    lane; its cells name the policy and prefetcher by id, these by name, as
    :func:`run_batch`'s do.  An empty lane returns its state and empty
    outputs.  ``evict_prefs`` (one entry per lane, ``None`` = no budget)
    carries each lane's QoS leading victim key."""
    eps = evict_prefs if evict_prefs is not None else [None] * len(states)
    return [
        run_segment(st, blocks, next_use, capacity=int(cap), policy=pol, prefetch=pf, n_valid=int(nv),
                    want_outs=want_outs, evict_pref=ep)
        for st, (blocks, next_use), (pol, pf, cap), nv, ep in zip(states, segments, cells, n_valids, eps)
    ]


# --- builtin registrations -----------------------------------------------------
# The paper's strategy matrix enters the same registry a plug-in does, in
# the reference's order, so the ids (lru=0 .. learned=4, demand=0, tree=1,
# none->demand) are the reference's.  Guarded for importlib.reload.
if "lru" not in POLICY_IDS:
    _registry.register_policy("lru", _lru_keys)
    _registry.register_policy("random", _random_keys)
    _registry.register_policy("belady", _belady_keys)
    _registry.register_policy("hpe", _hpe_keys)
    _registry.register_policy("learned", _learned_keys)
    _registry.register_prefetcher("demand", None)
    _registry.register_prefetcher("tree", _tree_mask)
    _registry.register_prefetcher("none", alias_of="demand")
