"""Append-only feature encoder for the streaming manager.

:class:`repro_torch.core.features.FeatureStream` needs the whole trace up front;
an online manager only ever sees the next fault batch.  This encoder
appends batches and yields the SAME window samples `FeatureStream.windows`
would produce over the concatenated stream — byte-identical arrays, so a
driver that replays a trace through :class:`OversubscriptionManager`
reproduces the monolithic `run_ours` bit for bit (the delta vocabulary
grows in arrival order, window history crosses batch boundaries, the first
``history`` accesses never become samples).

Memory is BOUNDED: only the last ``history`` encoded rows survive between
batches (that tail is all a future window can reach, and the previous raw
page is all the delta encoder needs), so an endless stream — the ``cli
serve`` sidecar, the serving offload adapter — costs O(history + batch)
resident, not O(stream).  Indices stay global: ``windows``/``page_at``
take stream positions and refuse spans that slid out of retention.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.features import DeltaVocab, FeatureSet

_FIELDS = ("_page", "_ph", "_dcls", "_pch", "_tbh")


class OnlineFeatureStream:
    """Incremental (page, pc, tb) encoder with cross-batch window history."""

    def __init__(self, vocab: DeltaVocab, history: int = 10, *, page_vocab=4096, pc_vocab=512, tb_vocab=512):
        self.vocab = vocab
        self.history = history
        self.page_vocab, self.pc_vocab, self.tb_vocab = page_vocab, pc_vocab, tb_vocab
        self._off = 0  # global stream index of the retained arrays' row 0
        self._page = np.zeros(0, np.int32)  # raw page ids (label_page / prev-page)
        self._ph = np.zeros(0, np.int32)
        self._dcls = np.zeros(0, np.int32)
        self._pch = np.zeros(0, np.int32)
        self._tbh = np.zeros(0, np.int32)

    def __len__(self) -> int:
        """Global stream length (includes rows already trimmed)."""
        return self._off + len(self._page)

    def page_at(self, idx: np.ndarray) -> np.ndarray:
        """Raw page ids at GLOBAL stream positions (must be retained)."""
        local = np.asarray(idx) - self._off
        if local.size and int(local.min()) < 0:
            raise IndexError(f"stream position {int(np.asarray(idx).min())} slid out of retention")
        return self._page[local]

    def append(self, page: np.ndarray, pc: np.ndarray, tb: np.ndarray) -> tuple[int, int]:
        """Encode one batch; returns its [g0, g1) span in the stream."""
        pg = np.asarray(page, np.int64)
        g0 = len(self)
        if len(pg) == 0:
            return g0, g0
        # delta of the batch's first access reaches back across the batch
        # boundary (FeatureStream: prev = page[lo-1] if lo else page[0])
        prev = np.int64(self._page[-1]) if g0 else pg[0]
        deltas = np.diff(pg, prepend=prev)
        # trim to what future calls can still address: the NEXT batch's
        # windows reach back `history` rows; the delta encoder needs row -1
        keep = max(self.history, 1)
        if len(self._page) > keep:
            drop = len(self._page) - keep
            self._off += drop
            for f in _FIELDS:
                setattr(self, f, getattr(self, f)[drop:])
        self._page = np.concatenate([self._page, np.asarray(page).astype(np.int32)])
        self._ph = np.concatenate([self._ph, (pg % self.page_vocab).astype(np.int32)])
        self._dcls = np.concatenate([self._dcls, self.vocab.encode(deltas)])
        self._pch = np.concatenate([self._pch, (np.asarray(pc) % self.pc_vocab).astype(np.int32)])
        self._tbh = np.concatenate([self._tbh, (np.asarray(tb) % self.tb_vocab).astype(np.int32)])
        return g0, len(self)

    def windows(self, lo: int, hi: int) -> FeatureSet:
        """Window samples for GLOBAL stream span [lo, hi) —
        `FeatureStream.windows` verbatim (same index math, same dtypes)."""
        lo = max(lo, self.history)
        n = max(hi - lo, 0)
        if n == 0:
            e = np.zeros((0, self.history), np.int32)
            z = np.zeros((0,), np.int32)
            return FeatureSet(e, e.copy(), e.copy(), e.copy(), z, z.copy(), z.copy())
        if lo - self.history < self._off:
            raise IndexError(f"window span [{lo}, {hi}) reaches rows that slid out of retention")
        idx = (lo - self._off) + np.arange(n)[:, None] - np.arange(self.history, 0, -1)[None, :]
        sl = slice(lo - self._off, hi - self._off)
        return FeatureSet(
            page=self._ph[idx],
            delta=self._dcls[idx],
            pc=self._pch[idx],
            tb=self._tbh[idx],
            label=self._dcls[sl].astype(np.int32),
            label_page=self._page[sl].astype(np.int32),
            t_index=(lo + np.arange(n)).astype(np.int32),
        )
