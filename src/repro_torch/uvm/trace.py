"""Memory-access traces + synthetic generators for the paper's 11 benchmarks
(the port's copy of ``repro.uvm.trace``, with its Section V-F concurrent
merge; the fault-log interchange is not ported yet).

The paper traces real CUDA benchmarks under GPGPU-Sim; without a GPU we
generate seeded synthetic traces whose *structure* matches the published
characterisation:

  * access-pattern class per benchmark (streaming / stencil-reuse / wavefront
    / random-gather / phased, Table VII & Fig. 5),
  * unique-delta growth across program phases (Table III),
  * re-reference behaviour that produces the published thrash ORDERING under
    the rule-based policies (Table I/VI: e.g. streaming benchmarks never
    thrash, NW thrashes hardest, BICG/Srad keep capacity misses even under
    Belady).

A trace is page-granular: (page, pc, tb, kernel) per access. The simulator
migrates at 64KB basic-block granularity (16 x 4KB pages), like the CUDA
runtime it models.

Generator contract the simulator's period-p event compression relies on:
streaming kernels are built with :func:`_interleave`, which walks its p
streams in lockstep — one access from each stream per iteration.  With
chunk-aligned allocations (:func:`_align`) the resulting BLOCK stream is a
fixed-period sequence (``b0 b1 .. bp-1`` repeated ``PAGES_PER_BLOCK``
times before every block advances), which the simulator detects host-side
and compresses into per-window aggregate events
(see ``repro_torch/uvm/simulator.py``).  Nothing here may assume that
compression exists — it is exactness-checked at runtime — but keeping the
interleave idiom periodic is what makes streaming sweeps fast.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAGE_SIZE = 4096
PAGES_PER_BLOCK = 16  # 64KB basic block


@dataclasses.dataclass
class Trace:
    name: str
    page: np.ndarray  # int32 (T,)
    pc: np.ndarray  # int32 (T,)
    tb: np.ndarray  # int32 (T,)
    kernel: np.ndarray  # int32 (T,) kernel-launch index
    n_pages: int  # working-set size in pages
    #: per-access tenant index for Section V-F concurrent merges (None for
    #: single-workload traces); index i names ``tenant_names[i]``
    tenant: np.ndarray | None = None
    tenant_names: tuple[str, ...] = ()

    def __len__(self) -> int:
        return len(self.page)

    @property
    def n_blocks(self) -> int:
        return (self.n_pages + PAGES_PER_BLOCK - 1) // PAGES_PER_BLOCK

    @property
    def block(self) -> np.ndarray:
        return self.page // PAGES_PER_BLOCK

    def deltas(self) -> np.ndarray:
        d = np.diff(self.page.astype(np.int64), prepend=self.page[0])
        return d

    def slice(self, lo: int, hi: int) -> "Trace":
        return Trace(
            self.name, self.page[lo:hi], self.pc[lo:hi], self.tb[lo:hi], self.kernel[lo:hi], self.n_pages,
            tenant=None if self.tenant is None else self.tenant[lo:hi], tenant_names=self.tenant_names,
        )


class _Builder:
    def __init__(self, name: str, n_pages: int, seed: int):
        self.name = name
        self.n_pages = n_pages
        self.rng = np.random.default_rng(seed)
        self.page: list[np.ndarray] = []
        self.pc: list[np.ndarray] = []
        self.tb: list[np.ndarray] = []
        self.kern: list[np.ndarray] = []
        self.kernel_id = 0

    def emit(self, pages: np.ndarray, pc: int):
        pages = np.asarray(pages, np.int64) % self.n_pages
        self.page.append(pages.astype(np.int32))
        self.pc.append(np.full(len(pages), pc, np.int32))
        # thread-block id ~ position within the kernel's iteration space
        self.tb.append((np.arange(len(pages)) // 64).astype(np.int32))
        self.kern.append(np.full(len(pages), self.kernel_id, np.int32))

    def next_kernel(self):
        self.kernel_id += 1

    def build(self) -> Trace:
        return Trace(
            self.name,
            np.concatenate(self.page),
            np.concatenate(self.pc),
            np.concatenate(self.tb),
            np.concatenate(self.kern),
            self.n_pages,
        )


def _align(n: int, m: int = 512) -> int:
    """Allocations are chunk-aligned (cudaMallocManaged rounds to 2MB chunks);
    misaligned synthetic arrays would create chunk-straddling artefacts the
    real runtime never sees."""
    return max(int(round(n / m)), 1) * m


def _interleave(*streams: np.ndarray) -> np.ndarray:
    n = min(len(s) for s in streams)
    out = np.empty(n * len(streams), np.int64)
    for i, s in enumerate(streams):
        out[i :: len(streams)] = s[:n]
    return out


# ---------------------------------------------------------------------------
# Benchmark generators. `scale` multiplies the working set + trace length.
# ---------------------------------------------------------------------------

def addvectors(scale: float = 1.0, seed: int = 0) -> Trace:
    """c[i] = a[i] + b[i]: pure streaming over 3 arrays, never re-referenced."""
    n = _align(int(1536 * scale))  # pages per array
    b = _Builder("AddVectors", 3 * n, seed)
    a_s = np.arange(n)
    b.emit(_interleave(a_s, n + a_s, 2 * n + a_s), pc=0)
    return b.build()


def streamtriad(scale: float = 1.0, seed: int = 1) -> Trace:
    """a[i] = b[i] + s*c[i]: streaming; strong temporal pattern proximity."""
    n = _align(int(1536 * scale))
    b = _Builder("StreamTriad", 3 * n, seed)
    idx = np.arange(n)
    b.emit(_interleave(idx, n + idx, 2 * n + idx), pc=0)
    return b.build()


def _stream_with_gathers(stream: np.ndarray, gathers: np.ndarray, per: int = 24, g: int = 8) -> np.ndarray:
    """Streamed pages with periodic random gathers (GPU coalescing means the
    matrix stream dominates the fault sequence; vector gathers punctuate it)."""
    ns = len(stream) // per * per
    chunks = stream[:ns].reshape(-1, per)
    gs = np.resize(gathers, (len(chunks), g))
    return np.concatenate([chunks, gs], axis=1).reshape(-1)


def atax(scale: float = 1.0, seed: int = 2, iters: int = 4) -> Trace:
    """y = A^T (A x), iterated (the benchmark loops its kernels): A streamed
    twice per iteration; x gathered randomly (random class)."""
    rows = max(int(48 * scale), 48)
    cols = max(int(48 * scale), 48)
    A = rows * cols // 8  # pages of A (8 matrix rows per page-ish)
    n = A + rows + cols
    b = _Builder("ATAX", n, seed)
    a_pages = np.arange(A)
    for _ in range(iters):
        # tmp = A x — stream A rows, gather x (random reuse)
        b.emit(_stream_with_gathers(a_pages, A + b.rng.integers(0, rows, A)), pc=0)
        b.next_kernel()
        # y = A^T tmp — stream A again (re-reference => thrash at 125%)
        b.emit(_stream_with_gathers(a_pages, A + rows + b.rng.integers(0, cols, A)), pc=1)
        b.next_kernel()
    return b.build()


def bicg(scale: float = 1.0, seed: int = 3) -> Trace:
    """BiCG: q = A p, s = A^T r — A re-referenced with transposed order."""
    rows = max(int(52 * scale), 52)
    side = max(int(np.sqrt(rows * rows // 8)), 2)
    A = side * side  # pages of A (kept square for the transposed walk)
    n = A + 4 * rows
    b = _Builder("BICG", n, seed)
    a_pages = np.arange(A)
    at = (np.arange(A).reshape(side, side).T).reshape(-1)
    for _ in range(3):  # the solver iterates
        b.emit(_stream_with_gathers(a_pages, A + b.rng.integers(0, rows, A)), pc=0)
        b.next_kernel()
        # transposed walk: column-major => large strided deltas, heavy thrash
        b.emit(_stream_with_gathers(at, A + 2 * rows + b.rng.integers(0, rows, A)), pc=1)
        b.next_kernel()
    return b.build()


def mvt(scale: float = 1.0, seed: int = 4) -> Trace:
    """x1 += A y1; x2 += A^T y2. A's live rows are interleaved with allocated
    but untouched padding rows (10 of 16 blocks live): demand variants fit and
    never thrash; the tree prefetcher's garbage overflows capacity (paper:
    baseline 2912, every demand variant 0)."""
    blocks = max(int(120 * scale), 48)
    bpp = 16
    live_block = (np.arange(blocks) % 16) < 10
    live = np.concatenate([np.arange(bpp) + blk * bpp for blk in np.nonzero(live_block)[0]])
    b = _Builder("MVT", blocks * bpp, seed)
    b.emit(live, pc=0)
    b.next_kernel()
    side = int(np.sqrt(len(live)))
    at = live[: side * side].reshape(side, side).T.reshape(-1)
    b.emit(at, pc=1)
    return b.build()


def hotspot(scale: float = 1.0, seed: int = 5, iters: int = 12) -> Trace:
    """2D stencil, iterative. The LIVE stencil rows occupy 9 of every 16
    blocks of the allocation (row padding / halo pages are allocated but never
    touched). The live set fits device memory, so demand-load policies never
    thrash — but the tree prefetcher sees >50%-valid chunks and drags in the
    dead blocks, overflowing capacity and evicting live rows (the paper's
    baseline-thrash mechanism for regular benchmarks)."""
    blocks = int(160 * scale)
    bpp = 16  # pages per block
    live_block = (np.arange(blocks) % 16) < 9
    live_pages = np.concatenate([np.arange(bpp) + blk * bpp for blk in np.nonzero(live_block)[0]])
    b = _Builder("Hotspot", blocks * bpp, seed)
    for it in range(iters):
        reads = _interleave(live_pages, live_pages + 1, live_pages - 1)
        b.emit(reads, pc=it % 3)
        b.next_kernel()
    return b.build()


def srad_v2(scale: float = 1.0, seed: int = 6, iters: int = 10) -> Trace:
    """SRAD: image grid, 2 kernels/iter, growing delta vocabulary across phases."""
    grid = int(768 * scale)
    b = _Builder("Srad-v2", 2 * grid, seed)
    for it in range(iters):
        idx = np.arange(grid)
        stride = 1 + it  # phase-dependent stride -> new deltas appear over time
        b.emit(_interleave(idx, (idx + stride), grid + idx), pc=0)
        b.next_kernel()
        b.emit(_interleave(grid + idx, (grid + idx + stride)), pc=1)
        b.next_kernel()
    return b.build()


def nw(scale: float = 1.0, seed: int = 7) -> Trace:
    """Needleman-Wunsch: anti-diagonal wavefront; delta vocab explodes (mixed)."""
    side = int(72 * scale)  # matrix side in pages^(1/2) units
    n = side * side // 2
    b = _Builder("NW", n, seed)
    width = int(np.sqrt(n))
    pages = []
    for d in range(2 * width - 1):  # anti-diagonals
        i = np.arange(max(0, d - width + 1), min(d + 1, width))
        j = d - i
        diag = i * width + j
        pages.append(diag)
        if d and d % 16 == 0:
            pages.append(diag[:: max(len(diag) // 4, 1)] - width)  # reference back rows
    b.emit(np.concatenate(pages), pc=0)
    b.next_kernel()
    # second pass: traceback (reverse walk, re-references everything)
    b.emit(np.concatenate(pages[::-1])[: 2 * n], pc=1)
    return b.build()


def backprop(scale: float = 1.0, seed: int = 8) -> Trace:
    """Two-layer NN: weights are re-read fwd+bwd but always interleaved with
    the (once-streamed) activation pages, so the weight set stays hot and
    NOTHING thrashes under demand load or driver-LRU (paper: 0 everywhere
    except Tree.+HPE, whose chain never sees the prefetches)."""
    w = _align(int(1280 * scale))  # weight pages, re-referenced
    act = _align(int(512 * scale))  # activation pages, streamed once
    b = _Builder("Backprop", w + act, seed)
    wp = np.arange(w)
    # weights stream in warp-coalesced chunks, punctuated by slowly-advancing
    # activation pages (chunked, so the delta stream stays learnable)
    ap_fwd = w + np.repeat(np.arange(act // 2), max(w // (act // 2), 1))
    ap_bwd = w + act // 2 + np.repeat(np.arange(act // 2), max(w // (act // 2), 1))
    b.emit(_stream_with_gathers(wp, ap_fwd, per=24, g=8), pc=0)
    b.next_kernel()
    b.emit(_stream_with_gathers(wp[::-1], ap_bwd, per=24, g=8), pc=1)
    return b.build()


def pathfinder(scale: float = 1.0, seed: int = 9) -> Trace:
    """Row-by-row DP: streams each row, re-uses only the previous row."""
    rows, row_pages = int(24 * scale), int(96 * scale)
    b = _Builder("Pathfinder", rows * row_pages, seed)
    for r in range(rows):
        cur = r * row_pages + np.arange(row_pages)
        prev = np.maximum(cur - row_pages, 0)
        b.emit(_interleave(cur, prev), pc=0)
    return b.build()


def twodconv(scale: float = 1.0, seed: int = 10) -> Trace:
    """2D convolution: single streaming pass with row-neighbour deltas."""
    grid = _align(int(1800 * scale))
    b = _Builder("2DCONV", 2 * grid, seed)
    idx = np.arange(grid)
    width = int(np.sqrt(grid))
    reads = _interleave(idx, idx + 1, idx + width, grid + idx)  # in, in+dx, in+dy, out
    b.emit(reads, pc=0)
    return b.build()


BENCHMARKS = {
    "AddVectors": addvectors,
    "ATAX": atax,
    "Backprop": backprop,
    "BICG": bicg,
    "Hotspot": hotspot,
    "MVT": mvt,
    "NW": nw,
    "Pathfinder": pathfinder,
    "Srad-v2": srad_v2,
    "2DCONV": twodconv,
    "StreamTriad": streamtriad,
}

# published access-pattern category (Table VII + Section V-F)
CATEGORY = {
    "AddVectors": "streaming",
    "StreamTriad": "streaming",
    "2DCONV": "streaming",
    "Pathfinder": "streaming",
    "Hotspot": "regular",
    "Srad-v2": "regular",
    "Backprop": "regular",
    "MVT": "regular",
    "NW": "mixed",
    "ATAX": "random",
    "BICG": "random",
}


def get_trace(name: str, scale: float = 1.0) -> Trace:
    return BENCHMARKS[name](scale=scale)


def concurrent(traces: list[Trace], seed: int = 0, slice_len: int = 256,
               starts: list[int] | None = None) -> Trace:
    """Interleave multiple workloads in disjoint page ranges (Section V-F).

    Interleaving is at scheduler-slice granularity (not per access): each
    turn picks a live tenant at random (``np.random.default_rng(seed)``)
    and takes its next ``slice_len`` accesses, so the migration stream keeps
    per-workload temporal locality while the global stream mixes pattern
    classes.  Tenant ``w``'s pages move past the earlier tenants' pages, its
    pcs by ``16 * w`` and its kernel ids by ``64 * w``.

    The merge is tenant-tagged: ``.tenant`` carries each access's workload
    index and ``tenant_names`` maps it back to the constituent trace's name.
    ``starts[i]`` delays tenant ``i``'s admission until at least that many
    merged accesses have been produced, and a tenant whose trace runs out
    leaves the schedule.  A tenant that contributes no access (an empty
    trace) keeps its index.  When every remaining tenant is still waiting to
    join, the clock jumps to the earliest joiner.
    """
    rng = np.random.default_rng(seed)
    offset = 0
    parts = []
    for t in traces:
        parts.append((t.page + offset, t.pc, t.tb, t.kernel))
        offset += t.n_pages
    joins = [0] * len(parts) if starts is None else [int(s) for s in starts]
    if len(joins) != len(parts):
        raise ValueError(f"starts must align with traces (expected {len(parts)}, got {len(joins)})")
    cursors = [0] * len(parts)
    produced = 0
    slices = []
    while any(cursors[i] < len(p[0]) for i, p in enumerate(parts)):
        live = [i for i, p in enumerate(parts) if cursors[i] < len(p[0]) and joins[i] <= produced]
        if not live:  # every remaining tenant joins later: jump to the earliest one
            nxt = min(joins[i] for i, p in enumerate(parts) if cursors[i] < len(p[0]))
            live = [i for i, p in enumerate(parts) if cursors[i] < len(p[0]) and joins[i] <= nxt]
        w = int(rng.choice(live))
        lo = cursors[w]
        hi = min(lo + slice_len, len(parts[w][0]))
        slices.append((w, lo, hi))
        cursors[w] = hi
        produced += hi - lo
    page, pc, tb, kern, tnt = [], [], [], [], []
    for w, lo, hi in slices:
        p = parts[w]
        page.append(p[0][lo:hi])
        pc.append(p[1][lo:hi] + 16 * w)
        tb.append(p[2][lo:hi])
        kern.append(p[3][lo:hi] + 64 * w)
        tnt.append(np.full(hi - lo, w, np.int32))
    cat = lambda chunks: (np.concatenate(chunks) if chunks else np.zeros(0, np.int64)).astype(np.int32)
    return Trace("+".join(t.name for t in traces), cat(page), cat(pc), cat(tb), cat(kern), offset,
                 tenant=cat(tnt), tenant_names=tuple(t.name for t in traces))
