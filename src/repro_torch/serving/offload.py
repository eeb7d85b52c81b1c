"""Learned device<->host KV-page offload: the paper's technique at serving time.

During long-context decode the KV cache oversubscribes device memory; cold
pages live in host memory and must be prefetched back before attention
needs them.  Two managers of the JAX package share one decision-stream
surface (:class:`OffloadStats`):

  * :class:`LRUOffloadManager`: plain LRU residency (the ablation baseline);
  * :class:`KVOffloadManager`: the paper's policy engine driven by an EMA
    of attention mass (the serving analogue of the delta predictor).

The JAX package's third manager, ``LearnedOffloadManager`` (the full
streaming manager, which fine-tunes its predictor on the touch stream),
waits for the training slice (ROADMAP A2).

The pool itself is simulated: the managers track residency and count the
decisions.  Residency bookkeeping is numpy on the host, as in the
reference; the prediction-frequency table is the port's device table, so
each step's ``update`` launches the ``freq_update`` kernel on a CUDA table,
and an eviction brings the dense counters to the host once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.policy import PredictionFrequencyTable

INTERVAL_STEPS = 64  # chain interval, in decode steps


@dataclasses.dataclass
class OffloadStats:
    hbm_hits: int = 0
    hbm_misses: int = 0  # demand fetch from host (stall!)
    prefetches: int = 0
    evictions: int = 0
    thrash: int = 0  # page evicted then needed again

    @property
    def hit_rate(self) -> float:
        t = self.hbm_hits + self.hbm_misses
        return self.hbm_hits / t if t else 1.0


class KVOffloadManager:
    def __init__(self, n_pages: int, hbm_capacity: int, *, ema: float = 0.8, prefetch_per_step: int = 4,
                 device: str | torch.device = "cuda"):
        self.n_pages = n_pages
        self.capacity = hbm_capacity
        self.resident = np.zeros(n_pages, bool)
        self.evicted_once = np.zeros(n_pages, bool)
        self.last_interval = np.full(n_pages, -1, np.int64)
        self.attn_mass = np.zeros(n_pages, np.float64)  # EMA of attention mass
        self.freq_table = PredictionFrequencyTable(device=device)
        self.ema = ema
        self.prefetch_per_step = prefetch_per_step
        self.step = 0
        self.stats = OffloadStats()

    # -- the predictor hook ---------------------------------------------------
    def predict_hot(self, k: int) -> np.ndarray:
        """Pages predicted to be accessed soon (the attention-mass EMA)."""
        order = np.argsort(-self.attn_mass)
        return order[:k]

    # -- per decode step --------------------------------------------------------
    def on_attention(self, page_mass: np.ndarray, touched: np.ndarray):
        """page_mass: (n_pages,) attention mass this step; touched: page ids
        the attention actually read."""
        self.attn_mass = self.ema * self.attn_mass + (1 - self.ema) * page_mass
        interval = self.step // INTERVAL_STEPS
        for p in np.asarray(touched, np.int64):
            if self.resident[p]:
                self.stats.hbm_hits += 1
            else:
                self.stats.hbm_misses += 1
                if self.evicted_once[p]:
                    self.stats.thrash += 1
                self._admit(p)
            self.last_interval[p] = interval
        self._post_step()
        self.step += 1

    def _post_step(self):
        """End-of-step prediction + prefetch."""
        hot = self.predict_hot(4 * self.prefetch_per_step)
        self.freq_table.update(hot)
        if self.step % INTERVAL_STEPS == INTERVAL_STEPS - 1:
            self.freq_table.on_intervals(1)
        for p in hot:
            if not self.resident[p] and self.prefetch_per_step > 0:
                self._admit(int(p))
                self.stats.prefetches += 1

    def _admit(self, p: int):
        while self.resident.sum() >= self.capacity:
            self._evict_one(exclude=p)
        self.resident[p] = True

    def _freq_dense(self) -> np.ndarray:
        """Per-page prediction-frequency counters the eviction key reads
        (int32, -1 = never predicted), copied to the host."""
        return self.freq_table.dense(self.n_pages).cpu().numpy()

    def _evict_one(self, exclude: int):
        interval = self.step // INTERVAL_STEPS
        age = np.clip(interval - self.last_interval, 0, 2)
        freq = self._freq_dense()
        cand = self.resident.copy()
        cand[exclude] = False
        if not cand.any():
            return
        # oldest partition first, then lowest prediction frequency
        key = (-age * 1_000_000 + freq * 100).astype(np.int64)
        key[~cand] = np.iinfo(np.int64).max
        victim = int(np.argmin(key))
        self.resident[victim] = False
        self.evicted_once[victim] = True
        self.stats.evictions += 1


class LRUOffloadManager(KVOffloadManager):
    """Ablation baseline: plain LRU residency, no prediction."""

    def predict_hot(self, k: int) -> np.ndarray:
        return np.zeros(0, np.int64)

    def _evict_one(self, exclude: int):
        cand = self.resident.copy()
        cand[exclude] = False
        if not cand.any():
            return
        li = self.last_interval.copy()
        li[~cand] = np.iinfo(np.int64).max
        victim = int(np.argmin(li))
        self.resident[victim] = False
        self.evicted_once[victim] = True
        self.stats.evictions += 1
