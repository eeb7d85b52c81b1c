"""Feature extraction from the demand stream (Section IV-A step 1/4).

Inputs per access: page address, page delta, PC, thread-block ID. The delta
vocabulary GROWS online (Table III) — new deltas get fresh class ids until
the configured capacity, then hash into the existing space. Windows of
``history`` accesses form one sample; the label is the next access's delta
class.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.uvm.trace import Trace


class DeltaVocab:
    """Online-growing delta -> class-id map with bounded capacity."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.table: dict[int, int] = {}

    @property
    def n_classes(self) -> int:
        return len(self.table)

    def encode_one(self, delta: int) -> int:
        if delta in self.table:
            return self.table[delta]
        if len(self.table) < self.capacity:
            self.table[delta] = len(self.table)
            return self.table[delta]
        return hash(delta) % self.capacity  # overflow: hash into existing ids

    def encode(self, deltas: np.ndarray) -> np.ndarray:
        return np.fromiter((self.encode_one(int(d)) for d in deltas), np.int32, len(deltas))


@dataclasses.dataclass
class FeatureSet:
    page: np.ndarray   # (N, T) hashed page ids
    delta: np.ndarray  # (N, T) delta class ids
    pc: np.ndarray     # (N, T)
    tb: np.ndarray     # (N, T)
    label: np.ndarray  # (N,) next delta class id
    label_page: np.ndarray  # (N,) next raw page id (for the policy engine)
    t_index: np.ndarray  # (N,) trace position of the label access

    def __len__(self):
        return len(self.label)

    def slice(self, lo, hi):
        return FeatureSet(*(getattr(self, f.name)[lo:hi] for f in dataclasses.fields(self)))


def extract(trace: Trace, vocab: DeltaVocab, history: int = 10, *, page_vocab=4096, pc_vocab=512, tb_vocab=512, start: int = 0, stop: int | None = None) -> FeatureSet:
    """Build windowed samples for trace[start:stop] (vocab grows in order)."""
    stop = len(trace) if stop is None else stop
    page = trace.page[:stop].astype(np.int64)
    deltas = np.diff(page, prepend=page[0])
    dcls = vocab.encode(deltas)
    ph = (page % page_vocab).astype(np.int32)
    pch = (trace.pc[:stop] % pc_vocab).astype(np.int32)
    tbh = (trace.tb[:stop] % tb_vocab).astype(np.int32)

    lo = max(start, history)
    n = max(stop - lo, 0)
    if n == 0:
        e = np.zeros((0, history), np.int32)
        z = np.zeros((0,), np.int32)
        return FeatureSet(e, e.copy(), e.copy(), e.copy(), z, z.copy(), z.copy())

    idx = lo + np.arange(n)[:, None] - np.arange(history, 0, -1)[None, :]  # (N, T)
    return FeatureSet(
        page=ph[idx],
        delta=dcls[idx],
        pc=pch[idx],
        tb=tbh[idx],
        label=dcls[lo : lo + n].astype(np.int32),
        label_page=trace.page[lo : lo + n].astype(np.int32),
        t_index=(lo + np.arange(n)).astype(np.int32),
    )


class FeatureStream:
    """Incremental feature encoder for the online runtime: appends trace
    segments (growing the delta vocab in arrival order) and yields window
    samples for any [lo, hi) span without re-encoding the prefix."""

    def __init__(self, trace: Trace, vocab: DeltaVocab, history: int = 10, *, page_vocab=4096, pc_vocab=512, tb_vocab=512):
        self.trace = trace
        self.vocab = vocab
        self.history = history
        self.page_vocab, self.pc_vocab, self.tb_vocab = page_vocab, pc_vocab, tb_vocab
        self.encoded_upto = 0
        n = len(trace)
        self._dcls = np.zeros(n, np.int32)
        self._ph = (trace.page.astype(np.int64) % page_vocab).astype(np.int32)
        self._pch = (trace.pc % pc_vocab).astype(np.int32)
        self._tbh = (trace.tb % tb_vocab).astype(np.int32)

    def ensure(self, upto: int):
        upto = min(upto, len(self.trace))
        if upto <= self.encoded_upto:
            return
        lo = self.encoded_upto
        page = self.trace.page.astype(np.int64)
        prev = page[lo - 1] if lo > 0 else page[0]
        deltas = np.diff(page[: upto], prepend=prev)[lo:]
        self._dcls[lo:upto] = self.vocab.encode(deltas)
        self.encoded_upto = upto

    def windows(self, lo: int, hi: int) -> FeatureSet:
        self.ensure(hi)
        lo = max(lo, self.history)
        n = max(hi - lo, 0)
        if n == 0:
            e = np.zeros((0, self.history), np.int32)
            z = np.zeros((0,), np.int32)
            return FeatureSet(e, e.copy(), e.copy(), e.copy(), z, z.copy(), z.copy())
        idx = lo + np.arange(n)[:, None] - np.arange(self.history, 0, -1)[None, :]
        return FeatureSet(
            page=self._ph[idx],
            delta=self._dcls[idx],
            pc=self._pch[idx],
            tb=self._tbh[idx],
            label=self._dcls[lo:hi].astype(np.int32),
            label_page=self.trace.page[lo:hi].astype(np.int32),
            t_index=(lo + np.arange(n)).astype(np.int32),
        )



def unique_deltas_per_phase(trace: Trace, n_phases: int = 3) -> list[int]:
    """Table III: cumulative unique page deltas at each program phase."""
    page = trace.page.astype(np.int64)
    deltas = np.diff(page, prepend=page[0])
    out = []
    for p in range(1, n_phases + 1):
        out.append(int(len(np.unique(deltas[: len(deltas) * p // n_phases]))))
    return out
