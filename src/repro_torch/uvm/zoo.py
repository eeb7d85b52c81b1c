"""Drifting-workload zoo (port of ``repro.uvm.zoo``; numpy only): seeded
generators beyond the fixed 11-benchmark suite, built to exercise the
streaming re-classification machinery (``ManagerConfig.reclass_interval`` /
``reclass_hysteresis``) and the :class:`~repro_torch.uvm.manager.TenantMux`'s
churn handling rather than a steady-state pattern.

* :func:`phase_trace` — phase-CHANGE traces splicing between base patterns
  at configurable switch points, abrupt or gradual (a seeded probabilistic
  blend window around each boundary);
* :func:`tenant_churn` — multi-tenant merges where sessions join late and
  leave early mid-stream (``trace.concurrent`` with per-tenant ``starts``
  and truncated spans);
* irregular single-pattern generators past the paper's suite:
  :func:`pointer_chase`, :func:`random_scan` (fresh uniform draws —
  unmemorizable noise) and :func:`strided_noise`, registered in
  :data:`PATTERNS` and resolvable by :func:`get_trace`.

Every trace is the JAX package's, array for array, under the same seed
(``tests/test_torch_zoo_qos.py`` holds their SHA-256); Table IX
(``repro_torch.bench.tables.table9``) runs its drift traces.
"""
from __future__ import annotations

import numpy as np

from repro_torch.uvm import trace as T
from repro_torch.uvm.trace import Trace, _align


# ---------------------------------------------------------------------------
# Irregular base patterns beyond the 11-benchmark suite.
# ---------------------------------------------------------------------------


def pointer_chase(scale: float = 1.0, seed: int = 11, passes: int = 3) -> Trace:
    """Linked-structure traversal: a seeded permutation cycle walked
    pointer-by-pointer.  Deltas are near-unique (no dominant stride), so the
    DFA classifies it firmly random; repeated passes over the same chain add
    cross-kernel re-reference (random REUSE) — the irregular-application
    shape the 11-benchmark suite lacks."""
    n = _align(int(768 * scale))
    b = T._Builder("PtrChase", n, seed)
    order = b.rng.permutation(n)
    # next[order[i]] = order[i+1]: one big cycle; the walk IS the pointer chain
    chain = np.empty(n, np.int64)
    chain[order[:-1]] = order[1:]
    chain[order[-1]] = order[0]
    cur = int(order[0])
    walk = np.empty(n, np.int64)
    for i in range(n):
        walk[i] = cur
        cur = int(chain[cur])
    for p in range(passes):
        b.emit(walk, pc=p % 2)
        b.next_kernel()
    return b.build()


def strided_noise(scale: float = 1.0, seed: int = 12, stride: int = 8,
                  noise: float = 0.2, iters: int = 3) -> Trace:
    """Strided sweep with seeded random interruptions: a fixed ``stride``
    walk where a ``noise`` fraction of accesses gather random pages (TLB
    shootdowns, helper-structure lookups).  Sits between the suite's clean
    streaming and pure random — the stride still dominates, but the noise
    floor drags the DFA's linearity score toward the mixed boundary."""
    n = _align(int(1024 * scale))
    b = T._Builder("StridedNoise", n, seed)
    steps = n  # the stride walk wraps `stride` times per pass, touching every page
    for it in range(iters):
        base = (np.arange(steps) * stride + it) % n
        jam = b.rng.random(steps) < noise
        pages = np.where(jam, b.rng.integers(0, n, steps), base)
        b.emit(pages, pc=it % 2)
        b.next_kernel()
    return b.build()


def random_scan(scale: float = 1.0, seed: int = 13, iters: int = 3) -> Trace:
    """Uniform random pages, FRESH draws every kernel: unlike
    :func:`pointer_chase` (whose repeated walk a capable predictor can
    memorize) there is nothing to learn here.  As a drift phase it is pure
    model poison — training on it only scrambles whatever model absorbs it,
    which is exactly what Table IX (``bench/tables.py::table9``) uses it for: a
    re-classifying manager quarantines the noise in the RANDOM entry while
    a frozen-pattern manager feeds it to the phase-A model."""
    n = _align(int(1024 * scale))
    b = T._Builder("RandomScan", n, seed)
    for it in range(iters):
        b.emit(b.rng.integers(0, n, n), pc=it % 2)
        b.next_kernel()
    return b.build()


#: the zoo's registered single-pattern workloads — resolvable anywhere a
#: benchmark name is (through :func:`get_trace`)
PATTERNS = {
    "PtrChase": pointer_chase,
    "RandomScan": random_scan,
    "StridedNoise": strided_noise,
}

#: access-pattern category of the zoo entries (extends trace.CATEGORY)
CATEGORY = {
    "PtrChase": "random",
    "RandomScan": "random",
    "StridedNoise": "mixed",
}


def get_trace(name: str, scale: float = 1.0) -> Trace:
    """Zoo-aware benchmark resolution: the paper's 11 generators first
    (:data:`repro_torch.uvm.trace.BENCHMARKS`), then the zoo's :data:`PATTERNS`."""
    if name in T.BENCHMARKS:
        return T.BENCHMARKS[name](scale=scale)
    if name in PATTERNS:
        return PATTERNS[name](scale=scale)
    raise KeyError(f"unknown workload {name!r}; one of "
                   f"{sorted(T.BENCHMARKS) + sorted(PATTERNS)}")


def workload_names() -> list[str]:
    """Every resolvable workload name: the 11-benchmark suite + the zoo."""
    return sorted(T.BENCHMARKS) + sorted(PATTERNS)


# ---------------------------------------------------------------------------
# Phase-change traces.
# ---------------------------------------------------------------------------


def _blend(out_tail: np.ndarray, in_head: np.ndarray, rng) -> np.ndarray:
    """Probabilistic boundary merge: interleave the outgoing phase's tail
    with the incoming phase's head, drawing the incoming side with a
    probability that ramps 0 -> 1 across the window.  Each side's internal
    order is preserved (it is a MERGE of two subsequences, never a shuffle),
    so per-phase access order survives the gradual switch.  Returns indices
    into the virtual concatenation [out_tail, in_head]."""
    na, nb = len(out_tail), len(in_head)
    ia = ib = 0
    order = np.empty(na + nb, np.int64)
    for j in range(na + nb):
        p_in = (j + 1) / (na + nb + 1)
        take_b = ib < nb and (ia >= na or rng.random() < p_in)
        if take_b:
            order[j] = na + ib
            ib += 1
        else:
            order[j] = ia
            ia += 1
    return order


def phase_trace(phases, scale: float = 1.0, seed: int = 0, segment: int = 1500,
                switch: str = "abrupt", mix_window: int = 0, name: str | None = None) -> Trace:
    """A workload whose access pattern CHANGES mid-stream: ``segment``
    accesses of each named base pattern (benchmark or zoo entry), spliced in
    order over a shared page space (``n_pages`` = the widest phase — a phase
    change over one allocation, not a tenant switch).

    ``switch='abrupt'`` concatenates the segments exactly: every segment is
    bit-equal to the first ``segment`` accesses of its standalone generator
    (the property tests pin this).  ``switch='gradual'`` additionally blends
    each boundary: the last ``mix_window`` accesses of the outgoing phase
    and the first ``mix_window`` of the incoming one are merged with a
    seeded ramping probability — per-phase access order is preserved, and
    everything outside the windows stays bit-equal."""
    phases = tuple(phases)
    if len(phases) < 2:
        raise ValueError("phase_trace needs at least two phases")
    if switch not in ("abrupt", "gradual"):
        raise ValueError(f"unknown switch {switch!r}; 'abrupt' or 'gradual'")
    segs = []
    for p in phases:
        tr = get_trace(p, scale=scale)
        segs.append(tr.slice(0, min(len(tr), segment)))
    n_pages = max(s.n_pages for s in segs)
    fields = ("page", "pc", "tb", "kernel")
    chunks = {f: [getattr(s, f) for s in segs] for f in fields}
    if switch == "gradual" and mix_window > 0:
        rng = np.random.default_rng(seed)
        for b in range(len(segs) - 1):
            w = min(mix_window, len(chunks["page"][b]), len(chunks["page"][b + 1]))
            if w == 0:
                continue
            order = _blend(chunks["page"][b][-w:], chunks["page"][b + 1][:w], rng)
            for f in fields:
                window = np.concatenate([chunks[f][b][-w:], chunks[f][b + 1][:w]])[order]
                chunks[f][b] = np.concatenate([chunks[f][b][:-w], window[:w]])
                chunks[f][b + 1] = np.concatenate([window[w:], chunks[f][b + 1][w:]])
    label = name or ("drift:" + ">".join(phases) + (f"|{switch}" if switch != "abrupt" else ""))
    return Trace(
        label,
        *(np.concatenate(chunks[f]).astype(np.int32) for f in fields),
        n_pages,
    )


# ---------------------------------------------------------------------------
# Tenant-churn streams.
# ---------------------------------------------------------------------------


def tenant_churn(tenants, scale: float = 1.0, seed: int = 0,
                 joins=(), spans=(), slice_len: int = 256) -> Trace:
    """A multi-tenant merge where sessions JOIN and LEAVE mid-run: tenant
    ``i`` is admitted only after ``joins[i]`` merged accesses
    (``trace.concurrent``'s ``starts``) and is truncated to ``spans[i]``
    accesses when positive (it leaves when its trace runs out).

    ``joins=()`` auto-staggers the arrivals evenly across the first half of
    the stream; ``spans=()`` keeps every tenant's full trace.  The result is
    tenant-tagged like any concurrent trace, so ``run_ours`` routes it
    through the :class:`~repro_torch.uvm.manager.TenantMux`, whose
    ``auto_create`` admission and per-tenant clock catch-up are exactly
    what churn stresses."""
    tenants = tuple(tenants)
    parts = []
    for i, nm in enumerate(tenants):
        tr = get_trace(nm, scale=scale)
        span = spans[i] if i < len(spans) and spans[i] else len(tr)
        parts.append(tr.slice(0, min(len(tr), span)))
    if not joins:
        total = sum(len(p) for p in parts)
        joins = tuple(i * total // (2 * max(len(parts), 1)) for i in range(len(parts)))
    tr = T.concurrent(parts, seed=seed, slice_len=slice_len, starts=list(joins))
    tr.name = "churn:" + "+".join(tenants)
    return tr
