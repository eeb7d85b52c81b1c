"""Learned device<->host KV-page offload: the paper's technique at serving time.

During long-context decode the KV cache oversubscribes device memory; cold
pages live in host memory and must be prefetched back before attention
needs them.  Three managers share one decision-stream surface
(:class:`OffloadStats`):

  * :class:`LRUOffloadManager`: plain LRU residency (the ablation baseline);
  * :class:`KVOffloadManager`: the paper's policy engine driven by an EMA
    of attention mass (the serving analogue of the delta predictor);
  * :class:`LearnedOffloadManager`: the full learned stack: KV-page touch
    streams become :class:`~repro_torch.uvm.manager.OversubscriptionManager`
    observations, so the classifier -> per-pattern predictor -> policy
    engine pipeline that drives the trace simulator also decides serving
    residency, and fine-tunes its predictor on the hit/miss outcomes.

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

from repro_torch.configs.predictor_paper import SMOKE
from repro_torch.core.incremental import TrainConfig
from repro_torch.core.policy import PredictionFrequencyTable
from repro_torch.uvm.manager import FaultBatch, ManagerConfig, Outcomes, OversubscriptionManager, SnapshotStore

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
            self._note_touch(int(p))
        self._post_step()
        self.step += 1

    def _note_touch(self, p: int):
        """Per-touch hook (the manager adapter buffers its fault batches)."""

    def _post_step(self):
        """End-of-step prediction + prefetch (subclasses replace the source
        of predictions; the default is the attention-mass EMA)."""
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


def _default_serving_manager(n_pages: int, capacity: int, *, reclass_interval: int = 0, reclass_hysteresis: int = 2,
                             table=None, device: str | torch.device = "cuda") -> OversubscriptionManager:
    """A manager sized for KV pages: page == management unit
    (``pages_per_block=1``), the ``SMOKE`` predictor, single-epoch
    fine-tuning (decode-step batches are tiny).  ``reclass_interval`` opts
    the endless decode stream into periodic re-classification
    (hysteresis-guarded); 0 classifies every batch.  ``table``: the model
    table to start from (default: an empty one, whose slots start from
    ``predictor.init``)."""
    cfg = ManagerConfig(
        predictor=SMOKE,
        train=TrainConfig(group_size=64, epochs=1, batch_size=32),
        n_pages=n_pages, n_blocks=n_pages, capacity=capacity,
        pages_per_block=1,
        reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
    )
    return OversubscriptionManager(cfg, table=table, device=device)


class LearnedOffloadManager(KVOffloadManager):
    """KV-page residency decided by the streaming
    :class:`~repro_torch.uvm.manager.OversubscriptionManager` (pass
    ``manager=`` to share one; the default builds a fresh page-granular
    manager on ``device``).

    Adaptation: touched KV pages accumulate into fault batches of ``group``
    accesses; each full batch becomes one ``observe`` -> apply-actions ->
    ``feedback`` round.  KV page ``p`` is observed as page id ``p *
    pages_per_block``, so the manager's block id is exactly the KV page id
    whatever granularity its config came with: ``Actions.prefetch_blocks``
    and the frequency counters are read back as KV pages directly.
    Prefetches are budgeted like the attention-EMA manager, evictions read
    the manager's counters through the page-set chain (oldest partition,
    lowest frequency), and ``feedback`` carries each touch's E∪T
    membership and the miss count as the fault clock, so the predictor
    fine-tunes causally on the live serving stream (each round's
    ``train_group`` draws its schedule from ``default_rng(seed)``, as in
    the reference).

    ``checkpoint_dir``/``checkpoint_every``/``resume`` survive engine
    restarts: the adapter and manager state is snapshotted into a
    :class:`~repro_torch.uvm.manager.SnapshotStore` every N observed
    batches (host numpy: a snapshot taken on the card resumes on the CPU
    and the other way round), and ``resume=True`` restores the latest
    snapshot at construction.  The resumed decision stream is bit-identical
    to an uninterrupted one.
    """

    def __init__(self, n_pages: int, hbm_capacity: int, *, manager: OversubscriptionManager | None = None,
                 group: int = 64, prefetch_per_step: int = 4, reclass_interval: int = 0, reclass_hysteresis: int = 2,
                 checkpoint_dir=None, checkpoint_every: int = 0, resume: bool = False,
                 device: str | torch.device = "cuda"):
        super().__init__(n_pages, hbm_capacity, prefetch_per_step=prefetch_per_step,
                         device=device if manager is None else manager.device)
        self.manager = manager if manager is not None else _default_serving_manager(
            n_pages, hbm_capacity, reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
            device=device)
        if self.manager.cfg.n_blocks < n_pages:
            raise ValueError(
                f"manager.cfg.n_blocks ({self.manager.cfg.n_blocks}) must cover the "
                f"KV pool ({n_pages} pages): the manager's block unit is the KV page"
            )
        self.group = group
        self._buf: list[int] = []
        self.last_actions = None
        # engine-restart survival: snapshot the adapter and the manager every
        # checkpoint_every observed batches
        self._snapshots = None
        self._checkpoint_every = checkpoint_every
        self._observed_batches = 0
        if checkpoint_dir is not None:
            self._snapshots = SnapshotStore(checkpoint_dir)
            self._snapshots.clean_tmp()
            if resume and self._snapshots.latest_step() is not None:
                _step, state, _extra = self._snapshots.restore()
                self.restore(state)

    # -- snapshot / restore ---------------------------------------------------

    def state(self) -> dict:
        """Host-side snapshot: the residency adapter's arrays and stats, and
        the wrapped manager's full learned state (versioned and
        config-signed by :meth:`OversubscriptionManager.state`)."""
        return {
            "adapter": {
                "resident": self.resident.copy(),
                "evicted_once": self.evicted_once.copy(),
                "last_interval": self.last_interval.copy(),
                "attn_mass": self.attn_mass.copy(),
                "step": self.step,
                "buf": list(self._buf),
                "observed_batches": self._observed_batches,
                "stats": dataclasses.asdict(self.stats),
            },
            "manager": self.manager.state(),
        }

    def restore(self, state: dict) -> None:
        a = state["adapter"]
        self.resident = a["resident"].copy()
        self.evicted_once = a["evicted_once"].copy()
        self.last_interval = a["last_interval"].copy()
        self.attn_mass = a["attn_mass"].copy()
        self.step = a["step"]
        self._buf = list(a["buf"])
        self._observed_batches = a["observed_batches"]
        self.stats = OffloadStats(**a["stats"])
        self.manager.restore(state["manager"])

    # -- the manager adapter --------------------------------------------------

    def _observe_batch(self):
        batch = np.asarray(self._buf[: self.group], np.int64)
        self._buf = self._buf[self.group:]
        # kv page p -> manager page p*ppb, so manager block id == kv page id
        actions = self.manager.observe(FaultBatch(page=batch * self.manager.cfg.pages_per_block))
        self.last_actions = actions
        budget = self.prefetch_per_step
        for p in np.asarray(actions.prefetch_blocks, np.int64):
            if p < self.n_pages and not self.resident[p] and budget > 0:
                self._admit(int(p))
                self.stats.prefetches += 1
                budget -= 1
        # causal fine-tune: E∪T membership of each touch, misses as the
        # fault clock that advances the flush/chain intervals
        self.manager.feedback(Outcomes(
            was_evicted=self.evicted_once[batch],
            fault_count=self.stats.hbm_misses,
        ))
        self._observed_batches += 1
        if (self._snapshots is not None and self._checkpoint_every
                and self._observed_batches % self._checkpoint_every == 0):
            self._snapshots.save(self._observed_batches, self.state())

    def _freq_dense(self) -> np.ndarray:
        # block id == kv page id (see _observe_batch), so the manager's
        # counters index the KV pool directly
        return self.manager.freq_table.dense(self.n_pages).cpu().numpy()

    def _note_touch(self, p: int):
        self._buf.append(p)

    def _post_step(self):
        while len(self._buf) >= self.group:
            self._observe_batch()
