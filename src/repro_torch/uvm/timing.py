"""IPC timing proxy (replaces GPGPU-Sim's cycle model; constants = Table V).

    GPU core clock        1481 MHz
    far-fault latency     45 us          (batched: concurrent warps overlap)
    CPU-GPU interconnect  PCIe 3.0 16x -> 16 GB/s
    zero-copy access      200 core cycles
    DRAM access           100 core cycles
    prediction overhead   1..100 us per prediction (Fig. 13 sweep)

IPC is reported normalised (paper Figs. 13/14), so the instructions-per-
access constant cancels.
"""
from __future__ import annotations

CORE_MHZ = 1481.0
FAR_FAULT_US = 45.0
PCIE_BYTES_PER_S = 16e9
ZERO_COPY_CYCLES = 200
DRAM_CYCLES = 100
BLOCK_BYTES = 64 * 1024
INSTR_PER_ACCESS = 20.0
FAULT_OVERLAP = 16.0  # concurrent far-faults amortised across warps


def cycles(stats: dict, n_accesses: int, *, pred_overhead_us: float = 0.0, n_predictions: int = 0) -> float:
    base = n_accesses * INSTR_PER_ACCESS  # pipeline
    base += n_accesses * 0.1 * DRAM_CYCLES  # L2-miss fraction
    c = base
    c += stats["faults"] * FAR_FAULT_US * CORE_MHZ / FAULT_OVERLAP
    # PCIe transfers OVERLAP kernel execution (cudaMemPrefetchAsync — the
    # paper's premise for why prefetching beats demand load despite moving
    # more bytes); only transfer time exceeding the compute window stalls.
    mig = stats["migrated_blocks"] * BLOCK_BYTES / PCIE_BYTES_PER_S * CORE_MHZ * 1e6
    c += max(mig - base, 0.0)
    c += stats["zero_copy"] * ZERO_COPY_CYCLES
    c += n_predictions * pred_overhead_us * CORE_MHZ
    return float(c)


def ipc(stats: dict, n_accesses: int, **kw) -> float:
    return n_accesses * INSTR_PER_ACCESS / cycles(stats, n_accesses, **kw)



def normalized_ipc(stats: dict, ref_stats: dict, n_accesses: int, **kw) -> float:
    """IPC relative to a reference strategy on the same trace (``kw``, a
    prediction overhead, is charged to ``stats`` only, as in the
    reference)."""
    return ipc(stats, n_accesses, **kw) / ipc(ref_stats, n_accesses)
