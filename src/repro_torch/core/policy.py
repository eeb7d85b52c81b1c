"""Policy engine (Section IV-D, Fig. 9).

The prediction frequency table is a 1024-set, 16-way set-associative cache
keyed by 64KB basic block, with 6-bit saturating counters, flushed every 3
intervals (interval = 64 faults, as in HPE).  Counters record how often a
block appears in the current intervals' predictions.

  * prefetch candidates = predicted blocks, highest counter first
  * eviction candidates = lowest counter within the oldest non-empty chain
    partition (the simulator's ``learned`` policy reads the dense counter
    export).
Blocks never predicted have frequency -1 (evicted first).

The table's int32 tags and counters live on the manager's device.
``update`` and ``lookup_many`` go through :mod:`repro_torch.kernels.
freq_table`: the CUDA kernels for a CUDA table, their plain versions for a
CPU table.  ``update`` changes the table in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.freq_table import COUNTER_MAX, freq_lookup, freq_update

FLUSH_INTERVALS = 3

__all__ = ["COUNTER_MAX", "FLUSH_INTERVALS", "PredictionFrequencyTable", "predicted_blocks", "rank_prefetches"]


class PredictionFrequencyTable:
    def __init__(self, n_sets: int = 1024, ways: int = 16, device: str | torch.device = "cuda"):
        self.n_sets, self.ways = n_sets, ways
        self.device = resolve_device(device)
        self.tags = torch.full((n_sets, ways), -1, dtype=torch.int32, device=self.device)
        self.counters = torch.zeros((n_sets, ways), dtype=torch.int32, device=self.device)
        self.intervals_since_flush = 0
        self.flushes = 0

    def _blocks(self, blocks) -> torch.Tensor:
        b = np.asarray(blocks, np.int64).ravel()
        if b.size and not (-1 <= b.min() and b.max() < 2**31):
            raise ValueError("frequency-table block ids must fit int32 (>= -1)")
        return torch.tensor(b.astype(np.int32), device=self.device)

    def update(self, blocks) -> None:
        """Count one prediction per block occurrence, in arrival order."""
        freq_update(self.tags, self.counters, self._blocks(blocks))

    def lookup(self, block: int) -> int:
        return int(self.lookup_many(np.array([block]))[0])

    def lookup_many(self, blocks) -> torch.Tensor:
        """Current counter per block (int64 tensor on the table's device), -1 on miss."""
        return freq_lookup(self.tags, self.counters, self._blocks(blocks)).long()

    def dense(self, n_blocks: int) -> torch.Tensor:
        """Dense per-block counter array (int32 on the table's device, -1 =
        never predicted), built without a host round trip."""
        valid = (self.tags >= 0) & (self.tags < n_blocks)
        idx = torch.where(valid, self.tags, n_blocks).flatten().long()  # out of range -> dump slot
        out = torch.full((n_blocks + 1,), -1, dtype=torch.int32, device=self.device)
        out.scatter_(0, idx, torch.where(valid, self.counters, -1).flatten())
        return out[:n_blocks]

    def on_intervals(self, n_new_intervals: int) -> None:
        self.intervals_since_flush += n_new_intervals
        if self.intervals_since_flush >= FLUSH_INTERVALS:
            self.tags.fill_(-1)
            self.counters.fill_(0)
            self.intervals_since_flush = 0
            self.flushes += 1

    def storage_bits(self) -> int:
        """18KB per the paper: (6*16 + 48)/8 * 1024 bytes."""
        return self.n_sets * (6 * self.ways + 48)


def predicted_blocks(pred_pages: np.ndarray, pages_per_block: int = 16) -> np.ndarray:
    return np.unique(np.asarray(pred_pages, np.int64) // pages_per_block)


def rank_prefetches(table: PredictionFrequencyTable, blocks: np.ndarray, limit: int | None = None) -> np.ndarray:
    """Prefetch candidates ordered by prediction frequency (highest first)."""
    blocks = np.asarray(blocks, np.int64)
    freq = table.lookup_many(blocks).cpu().numpy() if len(blocks) else np.zeros(0, np.int64)
    order = np.argsort(-freq, kind="stable")
    out = blocks[order]
    return out if limit is None else out[:limit]
