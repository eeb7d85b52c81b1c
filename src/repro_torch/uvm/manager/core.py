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

Every component is swappable through :mod:`repro_torch.uvm.registry`:
``classifier`` (builtin ``dfa``), ``freq_table`` (builtin ``setassoc``, the
table behind the ``freq_table`` kernels), ``kind`` (the registered
predictor architectures).

Fault tolerance, as in the reference: ``ManagerConfig.health`` (a
:class:`HealthConfig`; ``None``, the default, leaves it off and every
dispatch failure propagates) runs the degraded-mode state machine, which
serves rule-based fallback actions while the learned path is demoted;
:meth:`OversubscriptionManager.state` / :meth:`~OversubscriptionManager.
restore` snapshot and restore everything the pipeline learned, as host
numpy (a snapshot taken on the card restores on the CPU and the other way
round).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pickle
import time

import numpy as np
import torch

from repro_torch.configs.predictor_paper import CONFIG_QUICK, PredictorConfig
from repro_torch.core.features import DeltaVocab, FeatureSet
from repro_torch.core.incremental import TrainConfig, Trainer
from repro_torch.core.model_table import Entry, ModelTable
from repro_torch.core.pattern import LINEAR, RANDOM, RANDOM_REUSE, PatternClassifier
from repro_torch.core.policy import PredictionFrequencyTable, predicted_blocks
from repro_torch.device import resolve_device
from repro_torch.uvm import registry as _registry
from repro_torch.uvm.manager.snapshot import STATE_VERSION, tree_to_device, tree_to_host
from repro_torch.uvm.manager.stream import _FIELDS as _STREAM_FIELDS
from repro_torch.uvm.manager.stream import OnlineFeatureStream
from repro_torch.uvm.trace import PAGES_PER_BLOCK

#: page-set-chain interval, in faults (= repro_torch.uvm.simulator.INTERVAL)
INTERVAL_FAULTS = 64

#: the degraded-mode state machine's states, in promotion order
HEALTH_STATES = ("healthy", "degraded", "recovering")


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
    closed).  ``health`` / ``fallback`` — the degraded-mode state machine's
    verdict for this batch: ``fallback=True`` means the learned path did
    not run and the blocks are the rule-based floor (buddy tree-prefetch +
    LRU victims)."""

    prefetch_blocks: np.ndarray
    pre_evict_blocks: np.ndarray
    counters: torch.Tensor | None
    pattern: int
    accuracy: float | None  # this batch's strictly-causal top-1 (None: no samples)
    n_samples: int
    warm: bool
    health: str = "healthy"
    fallback: bool = False


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
class HealthConfig:
    """Degraded-mode policy-engine knobs.  ``ManagerConfig.health=None``
    (the default) disables the state machine: dispatch failures propagate
    and no validation runs.

    With health enabled the manager runs a three-state machine
    (``healthy -> degraded -> recovering -> healthy``): any dispatch
    exception, non-finite model output or params, or per-observe latency
    overrun demotes to ``degraded``, where the batch (and the next
    ``backoff`` batches) take the rule-based fallback path instead of the
    learned one.  When the backoff window expires the manager enters
    ``recovering`` and retries the learned path; ``recovery_successes``
    consecutive clean dispatches re-promote to ``healthy``, while another
    fault doubles the backoff (capped at ``backoff_max``)."""

    backoff_initial: int = 1  # fallback rounds after the first fault
    backoff_max: int = 64  # exponential-backoff ceiling (rounds)
    recovery_successes: int = 2  # clean dispatches to re-promote
    latency_budget_ms: float = 0.0  # per-observe dispatch budget (0 = none)
    check_params: bool = True  # validate entry params finite pre-dispatch


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
    #: degraded-mode fallback (None: no health machine, dispatch failures
    #: propagate; see :class:`HealthConfig`)
    health: HealthConfig | None = None


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
    blocks: np.ndarray | None = None  # observed in-range blocks (fallback prefetch)
    fallback: bool = False  # degraded mode: emit rule-based actions, skip training


def _tree_finite(tree) -> bool:
    """True when every floating leaf of a tree of tensors and arrays is
    finite: the tensors in one concatenation, one reduction and one host
    read."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            leaves.append(t)

    walk(tree)
    tensors = [t.reshape(-1) for t in leaves if isinstance(t, torch.Tensor) and t.is_floating_point()]
    for a in (np.asarray(t) for t in leaves if not isinstance(t, torch.Tensor)):
        if np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a)):
            return False
    return not tensors or bool(torch.isfinite(torch.cat(tensors)).all())


def _cfg_signature(cfg: ManagerConfig) -> str:
    """Stable digest of the state-shaping config fields (the reference's
    digest for the same configuration): a snapshot restores only into an
    identically configured manager.  ``health`` is excluded: its knobs
    shape behaviour, not state layout, and enabling them on resume is
    legitimate."""
    d = dataclasses.asdict(cfg)
    d.pop("health", None)
    return hashlib.md5(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()[:12]


class OversubscriptionManager:
    """The classify -> predict -> policy-engine pipeline, one batch at a time,
    on one device.  Components default to fresh registry builds
    (``cfg.classifier`` / ``cfg.freq_table`` / a ``Trainer`` of
    ``cfg.kind``); pass ``table`` to start from a Section V-A pretrained
    model table (its params must live on ``device``), or inject any
    component (``TenantMux`` injects a shared trainer and frequency table),
    each on ``device``."""

    def __init__(
        self,
        cfg: ManagerConfig,
        *,
        table: ModelTable | None = None,
        trainer: Trainer | None = None,
        classifier=None,
        freq_table=None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trainer = trainer if trainer is not None else Trainer(cfg.predictor, cfg.train, cfg.kind, self.device)
        self.table = table if table is not None else ModelTable(
            lambda s: self.trainer.new_params(s), n_slots=cfg.train.table_slots
        )
        self.classifier = classifier if classifier is not None else _registry.classifier_factory(cfg.classifier)()
        self.freq_table = freq_table if freq_table is not None else \
            _registry.freq_table_factory(cfg.freq_table)(device=self.device)
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
        # degraded-mode state machine (inert while cfg.health is None)
        self._health_state = "healthy"
        self._backoff = 0  # current episode's backoff width, doubles per relapse
        self._backoff_left = 0  # fallback rounds before the next learned retry
        self._recovery_left = 0  # clean dispatches still owed before re-promotion
        self.n_health_faults = 0
        self.n_fallbacks = 0
        self.n_recoveries = 0
        self.last_health_error: str | None = None

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

    @property
    def health_state(self) -> str:
        return self._health_state

    # -- streaming protocol --------------------------------------------------

    def observe(self, batch: FaultBatch) -> Actions:
        """One full round: ingest a fault batch, return the engine's actions."""
        req = self.observe_begin(batch)
        corr = pred = None
        if req is not None and self.guard_dispatch(req):
            t0 = time.perf_counter()
            try:
                corr, pred = self.trainer.evaluate(req.params, req.fs, req.n_active)
            except Exception as exc:  # noqa: BLE001 — degraded mode absorbs anything
                if self.cfg.health is None:
                    raise
                self.note_fault(exc)
                corr = pred = None
            else:
                if not self.check_result(corr, pred, elapsed_s=time.perf_counter() - t0):
                    corr = pred = None
        return self.observe_finish(corr, pred)

    def feedback(self, outcomes: Outcomes) -> None:
        """Close the last observed batch: flush cadence + causal fine-tune."""
        req = self.feedback_begin(outcomes)
        if req is not None:
            try:
                entry = self.trainer.train_group(
                    req.entry, req.fs, req.n_active, in_et=req.in_et, use_lucir=req.use_lucir
                )
            except Exception as exc:  # noqa: BLE001
                if self.cfg.health is None:
                    raise
                self.note_fault(exc)  # the entry update is lost; the round still closes
                self._pending = None
                return
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
        self._pending.blocks = seen
        if self.cfg.health is not None and self._health_state == "degraded":
            if self._backoff_left > 0:
                # still inside the backoff window: the learned path is not
                # even dispatched, this round takes the floor
                self._backoff_left -= 1
                self._pending.fallback = True
                return None
            self._health_state = "recovering"
            self._recovery_left = self.cfg.health.recovery_successes
        if len(fs) == 0:
            return None
        return EvalRequest(entry.params, fs, self._pending.n_active)

    def observe_finish(self, corr: np.ndarray | None, pred_cls: np.ndarray | None) -> Actions:
        """Fold the predictor's output into the policy engine; emit actions."""
        p = self._pending
        if p is None:
            raise RuntimeError("observe_finish() without observe_begin()")
        if p.fallback:
            self.n_fallbacks += 1
            return self._fallback_actions(p)
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
        if self.cfg.health is not None and self._health_state == "recovering" and corr is not None:
            self._recovery_left -= 1
            if self._recovery_left <= 0:
                self._health_state = "healthy"
                self._backoff = 0
                self.n_recoveries += 1
        return Actions(
            prefetch_blocks=prefetch,
            pre_evict_blocks=self._pre_evict(counters),
            counters=counters,
            pattern=p.pat,
            accuracy=accuracy,
            n_samples=len(p.fs),
            warm=p.warm,
            health=self._health_state,
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
        if p.fallback or len(p.fs) == 0:
            # fallback rounds skip the fine-tune (the learned path never saw
            # this batch's predictions); the clocks above still advance
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

    # -- degraded-mode health machine ----------------------------------------

    def guard_dispatch(self, req: EvalRequest | None) -> bool:
        """Pre-dispatch health check: ``False`` means the learned path must
        not run this round.  Non-finite entry params (a poisoned model) are
        quarantined by re-initialising the pattern's slot, so a later retry
        dispatches a fresh model instead of the same NaNs forever."""
        if self.cfg.health is None or req is None:
            return True
        if self.cfg.health.check_params and not _tree_finite(req.params):
            p = self._pending
            if p is not None:
                slot = self.table.slot_of(p.pat)
                self.table.slots[slot] = Entry(params=self.table.init_fn(slot))
            self.note_fault(ValueError("non-finite model params"))
            return False
        return True

    def check_result(self, corr, pred_cls, *, elapsed_s: float = 0.0) -> bool:
        """Post-dispatch validation: a non-finite predictor output or a
        latency-budget overrun demotes the learned path and sends this batch
        to the fallback floor."""
        if self.cfg.health is None:
            return True
        if corr is not None:
            for arr in (np.asarray(corr), np.asarray(pred_cls)):
                if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
                    self.note_fault(ValueError("non-finite predictor output"))
                    return False
        budget = self.cfg.health.latency_budget_ms
        if budget > 0 and elapsed_s * 1e3 > budget:
            self.note_fault(TimeoutError(f"observe dispatch took {elapsed_s * 1e3:.2f}ms > {budget}ms budget"))
            return False
        return True

    def note_fault(self, exc: BaseException | str) -> None:
        """Record a learned-path failure (dispatch exception, poisoned
        output, budget overrun) and demote: the current round falls back and
        the next ``backoff`` rounds skip the learned path entirely.  Each
        relapse doubles the backoff up to ``backoff_max``; a full recovery
        resets it.  Lockstep drivers that own the dispatch (``TenantMux``)
        call this when their batched call fails."""
        if self.cfg.health is None:
            return
        self.n_health_faults += 1
        self.last_health_error = str(exc)
        self._backoff = (self.cfg.health.backoff_initial if self._backoff == 0
                         else min(self._backoff * 2, self.cfg.health.backoff_max))
        self._backoff_left = self._backoff
        self._health_state = "degraded"
        self._recovery_left = 0
        if self._pending is not None:
            self._pending.fallback = True

    def _fallback_actions(self, p: _Pending) -> Actions:
        """The rule-based floor (the paper's baseline): tree-prefetch the
        observed blocks' buddy siblings, pre-evict pure-LRU by chain
        interval.  No learned component is touched."""
        blocks = p.blocks if p.blocks is not None else np.zeros(0, np.int64)
        buddies = np.unique(np.asarray(blocks, np.int64) ^ 1)  # 2-block tree nodes
        buddies = buddies[(buddies >= 0) & (buddies < self.cfg.n_blocks)]
        prefetch = buddies[: max(self.cfg.capacity // 2, 1)]
        self._chain_li[prefetch] = self._interval  # staged = touched
        return Actions(
            prefetch_blocks=prefetch,
            pre_evict_blocks=self._lru_pre_evict(),
            counters=None,
            pattern=p.pat,
            accuracy=None,
            n_samples=len(p.fs),
            warm=False,
            health=self._health_state,
            fallback=True,
        )

    def _lru_pre_evict(self) -> np.ndarray:
        """Pure-LRU advisory victims (oldest chain interval first): the
        fallback ranking needs no frequency table."""
        seen = np.flatnonzero(self._chain_li >= 0)
        budget = min(max(int(seen.size) - self.cfg.capacity, 0), self.cfg.pre_evict_budget)
        if budget == 0:
            return np.zeros(0, np.int64)
        order = np.argsort(self._chain_li[seen], kind="stable")
        return seen[order[:budget]]

    # -- snapshot / restore --------------------------------------------------

    def state(self, *, include_freq_table: bool = True) -> dict:
        """Host-side snapshot of everything the online pipeline learned:
        model table (numpy arrays), classifier, frequency table (its host
        form), delta vocabulary, the bounded feature stream, accuracy
        counters, fault clock, reclass hysteresis and health state.  It
        holds no tensor, so it restores on any device.  Versioned and
        config-signed; restoring it into an identically configured manager
        reproduces the uninterrupted run's ``Actions`` bit for bit.

        Raises with a pending round: snapshots happen at batch boundaries
        only.  ``include_freq_table=False`` is for :class:`TenantMux`'s
        shared table, which the mux serialises once."""
        if self._pending is not None:
            raise RuntimeError("cannot snapshot with a pending observe(); close the round first")
        s = self.stream
        return {
            "version": STATE_VERSION,
            "cfg_sig": _cfg_signature(self.cfg),
            "table": {
                "n_slots": self.table.n_slots,
                "hits": self.table.hits,
                "misses": self.table.misses,
                "slots": {
                    slot: {
                        "params": tree_to_host(e.params),
                        "prev_params": tree_to_host(e.prev_params),
                        "opt_state": tree_to_host(e.opt_state),
                        "step": int(e.step),
                        "n_updates": int(e.n_updates),
                        "last_acc": float(e.last_acc),
                    }
                    for slot, e in self.table.slots.items()
                },
            },
            "classifier": pickle.dumps(self.classifier),
            "freq_table": pickle.dumps(self.freq_table) if include_freq_table else None,
            "vocab": {"capacity": self.vocab.capacity, "table": dict(self.vocab.table)},
            "stream": {"off": s._off, "rows": {f: getattr(s, f).copy() for f in _STREAM_FIELDS}},
            "accuracy": {
                "per_group": list(self.per_group),
                "corr_true": self._corr_true,
                "corr_n": self._corr_n,
                "warm_true": self._warm_true,
                "warm_n": self._warm_n,
                "n_predictions": self.n_predictions,
            },
            "decode": {"table": self._decode.copy(), "upto": self._decoded_upto},
            "clock": {
                "flush_interval": self._flush_interval,
                "interval": self._interval,
                "fault_base": self._fault_base,
                "fault_raw": self._fault_raw,
                "chain_li": self._chain_li.copy(),
            },
            "reclass": {
                "active_pat": self._active_pat,
                "cand_pat": self._cand_pat,
                "cand_streak": self._cand_streak,
                "last_reclass": self._last_reclass,
                "obs_accesses": self._obs_accesses,
                "last_reclass_obs": self._last_reclass_obs,
                "n_reclassifications": self.n_reclassifications,
                "n_pattern_switches": self.n_pattern_switches,
            },
            "health": {
                "state": self._health_state,
                "backoff": self._backoff,
                "backoff_left": self._backoff_left,
                "recovery_left": self._recovery_left,
                "n_health_faults": self.n_health_faults,
                "n_fallbacks": self.n_fallbacks,
                "n_recoveries": self.n_recoveries,
                "last_health_error": self.last_health_error,
            },
        }

    def restore(self, state: dict) -> None:
        """Inverse of :meth:`state`: validates the schema version and the
        config signature, then overwrites every learned component, putting
        the model table and the frequency table on this manager's device."""
        if state.get("version") != STATE_VERSION:
            raise ValueError(f"snapshot state version {state.get('version')!r} != supported {STATE_VERSION}")
        if state.get("cfg_sig") != _cfg_signature(self.cfg):
            raise ValueError("snapshot was taken under a different ManagerConfig; "
                             "restore requires an identically-configured manager")
        if self._pending is not None:
            raise RuntimeError("cannot restore over a pending observe()")
        t = state["table"]
        self.table.n_slots = t["n_slots"]
        self.table.hits, self.table.misses = t["hits"], t["misses"]
        self.table.slots = {
            slot: Entry(
                params=tree_to_device(e["params"], self.device),
                prev_params=tree_to_device(e["prev_params"], self.device),
                opt_state=tree_to_device(e["opt_state"], self.device),
                step=e["step"],
                n_updates=e["n_updates"],
                last_acc=e["last_acc"],
            )
            for slot, e in t["slots"].items()
        }
        self.classifier = pickle.loads(state["classifier"])
        if state["freq_table"] is not None:
            self.freq_table = pickle.loads(state["freq_table"])
            if hasattr(self.freq_table, "to"):
                self.freq_table.to(self.device)
        self.vocab.capacity = state["vocab"]["capacity"]
        self.vocab.table = dict(state["vocab"]["table"])
        st = state["stream"]
        self.stream.vocab = self.vocab  # the stream encodes through our vocab
        self.stream._off = st["off"]
        for f in _STREAM_FIELDS:
            setattr(self.stream, f, st["rows"][f].copy())
        acc = state["accuracy"]
        self.per_group = list(acc["per_group"])
        self._corr_true, self._corr_n = acc["corr_true"], acc["corr_n"]
        self._warm_true, self._warm_n = acc["warm_true"], acc["warm_n"]
        self.n_predictions = acc["n_predictions"]
        dec = state["decode"]
        self._decode = dec["table"].copy()
        self._decoded_upto = dec["upto"]
        clk = state["clock"]
        self._flush_interval = clk["flush_interval"]
        self._interval = clk["interval"]
        self._fault_base, self._fault_raw = clk["fault_base"], clk["fault_raw"]
        self._chain_li = clk["chain_li"].copy()
        rc = state["reclass"]
        self._active_pat, self._cand_pat = rc["active_pat"], rc["cand_pat"]
        self._cand_streak = rc["cand_streak"]
        self._last_reclass, self._obs_accesses = rc["last_reclass"], rc["obs_accesses"]
        self._last_reclass_obs = rc["last_reclass_obs"]
        self.n_reclassifications = rc["n_reclassifications"]
        self.n_pattern_switches = rc["n_pattern_switches"]
        h = state["health"]
        self._health_state = h["state"]
        self._backoff, self._backoff_left = h["backoff"], h["backoff_left"]
        self._recovery_left = h["recovery_left"]
        self.n_health_faults = h["n_health_faults"]
        self.n_fallbacks = h["n_fallbacks"]
        self.n_recoveries = h["n_recoveries"]
        self.last_health_error = h["last_health_error"]

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


# --- builtin component registrations ---------------------------------------------
# The paper's classifier and frequency table enter the same registry a
# plug-in does (the port's ``setassoc`` is the table behind the
# ``freq_table`` kernels).  Guarded for importlib.reload.
if "dfa" not in _registry.classifier_names():
    _registry.register_classifier("dfa", PatternClassifier)
if "setassoc" not in _registry.freq_table_names():
    _registry.register_freq_table("setassoc", PredictionFrequencyTable)
