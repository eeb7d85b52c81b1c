"""`OversubscriptionManager` — the paper's online pipeline as a streaming API.

Port of ``repro.uvm.manager.core``.  A consumer pushes fault batches in and
gets management actions out, then reports what actually happened so the
predictor can fine-tune causally::

    mgr = OversubscriptionManager(ManagerConfig(n_pages=..., n_blocks=..., capacity=...))
    actions = mgr.observe(FaultBatch(page=pages))   # classify -> predict -> engine
    ... apply actions.prefetch_blocks / actions.counters ...
    mgr.feedback(Outcomes(was_evicted=..., fault_count=...))

The model table, the predictor and the prediction-frequency table live on
the manager's device (``"cuda"`` unless the caller passes ``device="cpu"``);
``Actions.counters`` is the dense per-block counter export as an int32
tensor on that device, so it feeds the simulator's ``learned`` eviction
keys without a host round trip.  The classifier, the feature stream and the
page-set chain are host numpy, as in the JAX package.

Not ported yet (ROADMAP.md, queue A3): the degraded-mode health machine
(``ManagerConfig.health`` must be ``None``; :meth:`~OversubscriptionManager.
guard_dispatch`, :meth:`~OversubscriptionManager.check_result` and
:meth:`~OversubscriptionManager.note_fault` are its inert ``health=None``
form, which ``TenantMux`` calls), snapshots and the component registry
(only the ``dfa`` classifier and the ``setassoc`` table exist).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.predictor_paper import CONFIG_QUICK, PredictorConfig
from repro_torch.core.features import DeltaVocab, FeatureSet
from repro_torch.core.incremental import TrainConfig, Trainer
from repro_torch.core.model_table import Entry, ModelTable
from repro_torch.core.pattern import LINEAR, RANDOM, RANDOM_REUSE, PatternClassifier
from repro_torch.core.policy import PredictionFrequencyTable, predicted_blocks
from repro_torch.device import resolve_device
from repro_torch.uvm.manager.stream import OnlineFeatureStream
from repro_torch.uvm.trace import PAGES_PER_BLOCK

#: page-set-chain interval, in faults (= repro_torch.uvm.simulator.INTERVAL)
INTERVAL_FAULTS = 64


# --- protocol payloads -------------------------------------------------------


@dataclasses.dataclass
class FaultBatch:
    """One batch of the demand stream: raw page ids plus the optional
    side-channel features the predictor consumes (absent channels are
    zeros).  ``tenant`` tags each access with its workload (any hashable
    id, or a scalar for a whole-batch tag): a plain
    :class:`OversubscriptionManager` ignores it, ``TenantMux`` demultiplexes
    on it."""

    page: np.ndarray
    pc: np.ndarray | None = None
    tb: np.ndarray | None = None
    kernel: np.ndarray | None = None
    tenant: np.ndarray | None = None

    def __post_init__(self):
        self.page = np.asarray(self.page)
        n = len(self.page)
        z = lambda a: np.zeros(n, np.int32) if a is None else np.asarray(a)
        self.pc, self.tb, self.kernel = z(self.pc), z(self.tb), z(self.kernel)
        if self.tenant is not None and np.ndim(self.tenant) > 0:
            self.tenant = np.asarray(self.tenant)
            if len(self.tenant) != n:
                raise ValueError(f"tenant tags must align with pages (expected {n}, got {len(self.tenant)})")

    def __len__(self) -> int:
        return len(self.page)


@dataclasses.dataclass
class Actions:
    """The policy engine's output for one observed batch.

    ``prefetch_blocks`` — block ids to stage ahead of use (host int64).
    ``pre_evict_blocks`` — advisory victim ranking, worst first (host int64).
    ``counters`` — the dense per-block prediction-frequency export (int32
    tensor on the manager's device; ``None`` while the prefetch gate is
    closed)."""

    prefetch_blocks: np.ndarray
    pre_evict_blocks: np.ndarray
    counters: torch.Tensor | None
    pattern: int
    accuracy: float | None  # this batch's strictly-causal top-1 (None: no samples)
    n_samples: int
    warm: bool


@dataclasses.dataclass
class Outcomes:
    """What happened after the consumer applied a batch's actions: per-access
    E∪T membership (the thrashing-loss signal) and the cumulative far-fault
    count (advances the flush/chain intervals)."""

    was_evicted: np.ndarray | None = None  # bool per access of the LAST batch
    fault_count: int = 0


@dataclasses.dataclass
class EvalRequest:
    """Staged-observe handle: the predictor dispatch."""

    params: object
    fs: FeatureSet
    n_active: int


@dataclasses.dataclass
class TrainRequest:
    """Staged-feedback handle: the fine-tune dispatch."""

    entry: Entry
    fs: FeatureSet
    n_active: int
    in_et: np.ndarray | None
    use_lucir: bool


@dataclasses.dataclass
class ManagerConfig:
    """The predictor stack, the workload geometry and the component choices."""

    predictor: PredictorConfig = CONFIG_QUICK
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    kind: str = "transformer"
    n_pages: int = 4096  # working-set size (clips predicted pages)
    n_blocks: int = 256  # dense-counter width (simulator: the padded bucket)
    capacity: int = 192  # device blocks (the prefetch budget base)
    pages_per_block: int = PAGES_PER_BLOCK
    use_thrash_term: bool = True
    use_lucir: bool = True
    classifier: str = "dfa"
    freq_table: str = "setassoc"
    pre_evict_budget: int = 32  # advisory victims per Actions
    #: streaming periodic re-classification every ``reclass_interval``
    #: faults (0: classify every observed batch)
    reclass_interval: int = 0
    #: consecutive windows a challenger pattern must win to take over
    reclass_hysteresis: int = 2
    #: the degraded-mode health machine is not ported: must be None
    health: object | None = None


# --- Section IV-D gates -------------------------------------------------------


def prefetch_warm(entry: Entry, pat: int) -> bool:
    """Pattern-aware aggressiveness gate: cold models and random-classified
    phases must not drive prefetch, and the PREVIOUS group's measured
    accuracy must clear a pattern-dependent floor."""
    acc_floor = 0.4 if pat == LINEAR else 0.6
    return entry.n_updates > 0 and pat not in (RANDOM, RANDOM_REUSE) and entry.last_acc >= acc_floor


def prefetch_mask(dense: torch.Tensor, pred_pages: np.ndarray, last_acc: float, nb: int, cap: int,
                  pages_per_block: int = PAGES_PER_BLOCK) -> torch.Tensor:
    """Section IV-D prefetch candidate selection, on ``dense``'s device:
    gate by repeated prediction and cap the in-flight budget, scaled by model
    confidence.  Returns a bool (nb,) mask.

    Over budget, the JAX package keeps the first ``budget`` candidates of a
    stable descending sort by counter; here every candidate is ranked by a
    stable sort that puts the gated-out ones last, so the same blocks are
    kept without the host reading the counters."""
    pblocks = predicted_blocks(pred_pages, pages_per_block)
    pblocks = pblocks[pblocks < nb]
    min_freq = 1 if last_acc >= 0.7 else 2
    budget = cap if last_acc >= 0.7 else cap // 2
    mask = torch.zeros(nb, dtype=torch.bool, device=dense.device)
    if len(pblocks) == 0:
        return mask
    pb = torch.as_tensor(pblocks, device=dense.device)
    f = dense[pb].long()
    ok = f >= min_freq
    order = torch.argsort(torch.where(ok, -f, torch.full_like(f, 1 << 40)), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=dense.device)
    mask[pb] = ok & (rank < budget)
    return mask


@dataclasses.dataclass
class _Pending:
    """Per-round state carried from observe to feedback."""

    g0: int
    n: int  # batch length (validates Outcomes.was_evicted alignment)
    fs: FeatureSet
    pat: int
    entry: Entry
    n_active: int
    warm: bool


class OversubscriptionManager:
    """The classify -> predict -> policy-engine pipeline, one batch at a time,
    on one device.  Pass ``table`` to start from a Section V-A pretrained
    model table (its params must live on ``device``); ``trainer`` and
    ``freq_table`` inject a shared trainer or frequency table (``TenantMux``
    does both), each on ``device``."""

    def __init__(
        self,
        cfg: ManagerConfig,
        *,
        table: ModelTable | None = None,
        trainer: Trainer | None = None,
        freq_table=None,
        device: str | torch.device = "cuda",
    ):
        if cfg.health is not None:
            raise NotImplementedError("the degraded-mode health machine is not ported yet; use health=None")
        if (cfg.classifier, cfg.freq_table) != ("dfa", "setassoc"):
            raise NotImplementedError(f"classifier {cfg.classifier!r} / freq_table {cfg.freq_table!r}: only the "
                                      f"builtin 'dfa' / 'setassoc' are ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trainer = trainer if trainer is not None else Trainer(cfg.predictor, cfg.train, cfg.kind, self.device)
        self.table = table if table is not None else ModelTable(
            lambda s: self.trainer.new_params(s), n_slots=cfg.train.table_slots
        )
        self.classifier = PatternClassifier()
        self.freq_table = freq_table if freq_table is not None else PredictionFrequencyTable(device=self.device)
        pcfg = cfg.predictor
        self.vocab = DeltaVocab(pcfg.delta_vocab)
        self.stream = OnlineFeatureStream(
            self.vocab, pcfg.history,
            page_vocab=pcfg.page_vocab, pc_vocab=pcfg.pc_vocab, tb_vocab=pcfg.tb_vocab,
        )
        # accuracy bookkeeping (exact counts: top-1 = true / total)
        self.per_group: list[float] = []
        self._corr_true = 0
        self._corr_n = 0
        self._warm_true = 0
        self._warm_n = 0
        self.n_predictions = 0
        # class-id -> raw delta decode array, grown with the vocabulary
        self._decode = np.zeros(max(pcfg.delta_vocab, 2), np.int64)
        self._decoded_upto = 0
        # flush cadence + advisory page-set chain; the fault clock is the
        # consumer-reported count, re-based when a new consumer restarts it
        self._flush_interval = 0
        self._interval = 0
        self._fault_base = 0
        self._fault_raw = 0
        self._chain_li = np.full(cfg.n_blocks, -1, np.int64)
        self._pending: _Pending | None = None
        # streaming periodic re-classification (cfg.reclass_interval > 0)
        self._active_pat: int | None = None
        self._cand_pat: int | None = None
        self._cand_streak = 0
        self._last_reclass = 0
        self._obs_accesses = 0
        self._last_reclass_obs = 0
        self.n_reclassifications = 0
        self.n_pattern_switches = 0

    # -- result views --------------------------------------------------------

    @property
    def n_classes(self) -> int:
        return self.vocab.n_classes

    @property
    def n_models(self) -> int:
        return self.table.n_models

    @property
    def top1(self) -> float:
        return self._corr_true / self._corr_n if self._corr_n else 0.0

    @property
    def warm_top1(self) -> float:
        """Top-1 excluding each pattern-model's first (cold) group."""
        return self._warm_true / self._warm_n if self._warm_n else self.top1

    # -- streaming protocol --------------------------------------------------

    def observe(self, batch: FaultBatch) -> Actions:
        """One full round: ingest a fault batch, return the engine's actions."""
        req = self.observe_begin(batch)
        corr = pred = None
        if req is not None:
            corr, pred = self.trainer.evaluate(req.params, req.fs, req.n_active)
        return self.observe_finish(corr, pred)

    def feedback(self, outcomes: Outcomes) -> None:
        """Close the last observed batch: flush cadence + causal fine-tune."""
        req = self.feedback_begin(outcomes)
        if req is not None:
            entry = self.trainer.train_group(
                req.entry, req.fs, req.n_active, in_et=req.in_et, use_lucir=req.use_lucir
            )
            self.feedback_finish(entry)

    # -- staged halves -------------------------------------------------------

    def observe_begin(self, batch: FaultBatch) -> EvalRequest | None:
        """Ingest + classify; returns the predictor dispatch (None when the
        batch yields no window samples)."""
        if self._pending is not None:
            raise RuntimeError("observe() called twice without feedback()")
        batch = batch if isinstance(batch, FaultBatch) else FaultBatch(np.asarray(batch))
        g0, g1 = self.stream.append(batch.page, batch.pc, batch.tb)
        fs = self.stream.windows(g0, g1)
        blocks = np.asarray(batch.page, np.int64) // self.cfg.pages_per_block
        if self.cfg.reclass_interval > 0:
            pat = self._reclassify(blocks, batch.kernel)
        else:
            pat = self.classifier.classify(blocks, batch.kernel)
        entry = self.table.get(pat)
        self._pending = _Pending(
            g0=g0, n=g1 - g0, fs=fs, pat=pat, entry=entry,
            n_active=max(self.vocab.n_classes, 2),
            warm=prefetch_warm(entry, pat),  # the PREVIOUS group's accuracy
        )
        # advisory chain: demand touches land in the current interval
        seen = blocks[blocks < self.cfg.n_blocks]
        self._chain_li[seen] = self._interval
        if len(fs) == 0:
            return None
        return EvalRequest(entry.params, fs, self._pending.n_active)

    def observe_finish(self, corr: np.ndarray | None, pred_cls: np.ndarray | None) -> Actions:
        """Fold the predictor's output into the policy engine; emit actions."""
        p = self._pending
        if p is None:
            raise RuntimeError("observe_finish() without observe_begin()")
        counters = None
        prefetch = np.zeros(0, np.int64)
        accuracy = None
        if corr is not None and len(p.fs):
            accuracy = float(corr.mean())
            self.per_group.append(accuracy)
            self._corr_true += int(np.count_nonzero(corr))
            self._corr_n += len(corr)
            if p.entry.n_updates > 0:
                self._warm_true += int(np.count_nonzero(corr))
                self._warm_n += len(corr)
            self.n_predictions += len(p.fs)
            p.entry.last_acc = accuracy  # informs the NEXT group's gate
            # predicted classes -> raw deltas -> predicted pages
            pred_delta = self._decode_deltas(pred_cls)
            prev_page = self.stream.page_at(p.fs.t_index - 1).astype(np.int64)
            pred_pages = np.clip(prev_page + pred_delta, 0, self.cfg.n_pages - 1)
            if p.warm:
                self.freq_table.update(np.asarray(pred_pages, np.int64) // self.cfg.pages_per_block)
                # one dense export per batch, on the device: it feeds both
                # the simulator's `learned` eviction keys and the gate
                counters = self.freq_table.dense(self.cfg.n_blocks)
                mask = prefetch_mask(
                    counters, pred_pages, p.entry.last_acc,
                    self.cfg.n_blocks, self.cfg.capacity, self.cfg.pages_per_block,
                )
                prefetch = np.flatnonzero(mask.cpu().numpy()).astype(np.int64)
                self._chain_li[prefetch] = self._interval  # staged = touched
        return Actions(
            prefetch_blocks=prefetch,
            pre_evict_blocks=self._pre_evict(counters),
            counters=counters,
            pattern=p.pat,
            accuracy=accuracy,
            n_samples=len(p.fs),
            warm=p.warm,
        )

    def feedback_begin(self, outcomes: Outcomes) -> TrainRequest | None:
        """Advance the flush/chain intervals; stage the fine-tune dispatch
        (None when the batch had no samples — bookkeeping still happens)."""
        p = self._pending
        if p is None:
            raise RuntimeError("feedback() without a pending observe()")
        raw = int(outcomes.fault_count)
        if raw < self._fault_raw:  # consumer switch: its clock restarted at 0
            self._fault_base += self._fault_raw
        self._fault_raw = raw
        interval_now = (self._fault_base + raw) // INTERVAL_FAULTS
        if interval_now > self._flush_interval:
            self.freq_table.on_intervals(interval_now - self._flush_interval)
            self._flush_interval = interval_now
        self._interval = max(self._interval, interval_now)
        if len(p.fs) == 0:
            self._pending = None
            return None
        if self.cfg.use_lucir:
            self.table.snapshot_prev(p.pat)
            p.entry = self.table.get(p.pat)
        in_et = None
        if self.cfg.use_thrash_term and outcomes.was_evicted is not None:
            we = np.asarray(outcomes.was_evicted)
            if len(we) != p.n:
                raise ValueError(
                    f"Outcomes.was_evicted must have one entry per access of the "
                    f"last observed batch (expected {p.n}, got {len(we)})"
                )
            in_et = we[p.fs.t_index - p.g0]
        return TrainRequest(p.entry, p.fs, p.n_active, in_et, self.cfg.use_lucir)

    def feedback_finish(self, entry: Entry) -> None:
        """Publish the fine-tuned entry back to the pattern table."""
        p = self._pending
        if p is None:
            raise RuntimeError("feedback_finish() without feedback_begin()")
        self.table.put(p.pat, entry)
        self._pending = None

    # -- the health machine's hooks (inert: ``cfg.health`` is None) ----------

    def guard_dispatch(self, req: EvalRequest | None) -> bool:
        """Pre-dispatch health check: always ``True`` without the health
        machine, which is not ported (``cfg.health`` is None)."""
        return True

    def check_result(self, corr, pred_cls, *, elapsed_s: float = 0.0) -> bool:
        """Post-dispatch validation: always ``True`` without the health
        machine."""
        return True

    def note_fault(self, exc: BaseException | str) -> None:
        """Record a learned-path failure: a no-op without the health machine
        (a lockstep driver such as ``TenantMux`` re-raises the failure)."""

    # -- internals -----------------------------------------------------------

    def _reclassify(self, blocks: np.ndarray, kernels: np.ndarray) -> int:
        """Periodic re-classification with hysteresis (cfg.reclass_interval
        faults per window, with observed accesses as the fallback clock; a
        challenger needs cfg.reclass_hysteresis consecutive agreeing windows
        to dethrone the active pattern)."""
        clock = self._fault_base + self._fault_raw
        self._obs_accesses += len(blocks)
        due = (clock - self._last_reclass >= self.cfg.reclass_interval
               or self._obs_accesses - self._last_reclass_obs >= self.cfg.reclass_interval)
        if self._active_pat is None:  # first observation seeds the pattern
            self._active_pat = self.classifier.classify(blocks, kernels)
            self._last_reclass = clock
            self._last_reclass_obs = self._obs_accesses
            self.n_reclassifications += 1
        elif due:
            proposal = self.classifier.classify(blocks, kernels)
            self._last_reclass = clock
            self._last_reclass_obs = self._obs_accesses
            self.n_reclassifications += 1
            if proposal == self._active_pat:
                self._cand_pat, self._cand_streak = None, 0
            else:
                if proposal == self._cand_pat:
                    self._cand_streak += 1
                else:
                    self._cand_pat, self._cand_streak = proposal, 1
                if self._cand_streak >= max(self.cfg.reclass_hysteresis, 1):
                    self._active_pat = proposal
                    self._cand_pat, self._cand_streak = None, 0
                    self.n_pattern_switches += 1
        return self._active_pat

    def _decode_deltas(self, pred_cls: np.ndarray) -> np.ndarray:
        """Class id -> raw delta (unknown ids decode to delta 0)."""
        if self.vocab.n_classes > self._decoded_upto:
            for delta, cls in self.vocab.table.items():
                if cls >= self._decoded_upto:
                    self._decode[cls] = delta
            self._decoded_upto = self.vocab.n_classes
        return self._decode[np.asarray(pred_cls, np.int64)]

    def _pre_evict(self, counters: torch.Tensor | None) -> np.ndarray:
        """Advisory victim ranking: oldest chain partition first, lowest
        prediction frequency inside it, budgeted to the blocks the working
        set holds over capacity."""
        seen = np.flatnonzero(self._chain_li >= 0)
        budget = min(max(int(seen.size) - self.cfg.capacity, 0), self.cfg.pre_evict_budget)
        if budget == 0:
            return np.zeros(0, np.int64)
        dense = counters if counters is not None else self.freq_table.dense(self.cfg.n_blocks)
        dense = dense.cpu().numpy()
        age = np.clip(self._interval - self._chain_li[seen], 0, 2)
        key = (-age << 20) + dense[seen]  # lexicographic (-age, freq), smallest first
        order = np.argsort(key, kind="stable")
        return seen[order[:budget]]
