"""`TenantMux` — multi-tenant streaming oversubscription management (port
of ``repro.uvm.manager.multi``).

The paper's second accuracy result covers multiple concurrent GPGPU
workloads (Section V-F: +10.2% top-1 on average, up to +30.2%): one
classifier->predictor pipeline over the merged fault stream blends pattern
classes inside every observation window.  The mux demultiplexes the
tenant-tagged stream into one :class:`~repro_torch.uvm.manager.
OversubscriptionManager` per tenant, each with its own classifier state,
delta vocabulary, window history and per-pattern model table, and combines
the device-wide artifacts (the dense prediction-frequency export that the
`learned` eviction policy reads, the staged prefetch set)::

    mux = TenantMux(cfg, tenants=(0, 1), device="cuda")
    out = mux.observe(FaultBatch(page=pages, tenant=tags))   # demux -> per-tenant pipelines
    ... stage out.prefetch_blocks / out.counters ...
    mux.feedback(Outcomes(was_evicted=..., fault_count=...)) # split back per tenant

* ``observe`` splits the batch by tag (first-appearance order, each
  tenant's access order kept), runs each tenant's ``observe_begin``, sends
  every predictor dispatch through one ``Trainer.evaluate_many`` call and
  combines the per-tenant actions into a :class:`MuxActions`.
* ``feedback`` splits ``was_evicted`` along the same partition and forwards
  the global fault clock to every tenant observed this round (absent
  tenants catch up on their next observation); ``feedback(..., tenant=k)``
  closes tenant ``k``'s pending batch alone.
* the staged halves (``observe_begin``/``observe_finish``,
  ``feedback_begin``/``feedback_finish``) return per-tenant request lists
  for lockstep drivers.

``shared_freq_table=False`` (the default) gives every tenant its own
frequency table, and the combined export is the elementwise
``torch.maximum`` of the tenants' dense tensors on the device (tenants hold
disjoint page ranges, so the max is the union); ``True`` makes every tenant
update one table (the paper's single 18KB budget, Section IV-D) whose flush
cadence the mux owns.  Tenants share one :class:`~repro_torch.core.
incremental.Trainer`, never model state.

``qos`` attaches a :class:`~repro_torch.uvm.qos.BudgetController`: every
observed batch claims its tenant's blocks (first-toucher ownership), every
feedback round feeds the tenant's thrash rate into the elastic rebalance,
and :meth:`TenantMux.evict_pref` compiles the budgets into the simulator's
leading victim key (a fourth ``evict_select`` key).

Not ported (ROADMAP A4): snapshots (``state``, ``restore``) and the
component registry's classifiers and frequency tables (a non-builtin one);
each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.incremental import Trainer
from repro_torch.core.model_table import ModelTable
from repro_torch.core.policy import PredictionFrequencyTable
from repro_torch.device import resolve_device
from repro_torch.uvm.manager.core import (
    INTERVAL_FAULTS,
    EvalRequest,
    FaultBatch,
    ManagerConfig,
    Outcomes,
    OversubscriptionManager,
    TrainRequest,
)

_UNSET = object()


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A4)")


@dataclasses.dataclass
class MuxActions:
    """One round's combined output: the device-wide artifacts a simulator
    stages, plus every tenant's own :class:`~repro_torch.uvm.manager.Actions`.

    ``counters`` is the combined dense prediction-frequency export (an int32
    tensor on the mux's device), ``None`` when no tenant's prefetch gate
    opened this round.  ``pre_evict_blocks`` round-robins the tenants'
    advisory rankings.  ``budgets`` is the QoS capacity partition this round
    was observed under (tenant -> blocks), ``None`` without a budget
    controller."""

    per_tenant: dict
    prefetch_blocks: np.ndarray
    counters: torch.Tensor | None
    pre_evict_blocks: np.ndarray
    budgets: dict | None = None

    @property
    def patterns(self) -> dict:
        return {k: a.pattern for k, a in self.per_tenant.items()}


def _thrash_rate(was_evicted) -> float:
    return float(np.mean(was_evicted)) if was_evicted is not None and len(was_evicted) else 0.0


def _stable_unique(parts: list[np.ndarray]) -> np.ndarray:
    """Concatenate and dedup, keeping first-appearance order."""
    if not parts:
        return np.zeros(0, np.int64)
    cat = np.concatenate([np.asarray(p, np.int64) for p in parts])
    _, first = np.unique(cat, return_index=True)
    return cat[np.sort(first)]


def _round_robin(parts: list[np.ndarray]) -> np.ndarray:
    """Interleave the tenants' rankings fairly (worst first per tenant)."""
    parts = [np.asarray(p, np.int64) for p in parts if len(p)]
    if not parts:
        return np.zeros(0, np.int64)
    width = max(len(p) for p in parts)
    out = [p[i] for i in range(width) for p in parts if i < len(p)]
    return _stable_unique([np.asarray(out, np.int64)])


class _SharedFreqTableView:
    """The shared frequency table as one tenant manager sees it: reads and
    updates pass through, ``on_intervals`` is a no-op (the mux owns the
    flush cadence: every manager computes the same interval delta from the
    global fault clock, and applying each would flush the one table once
    per tenant)."""

    def __init__(self, table: PredictionFrequencyTable):
        self._table = table

    def update(self, blocks) -> None:
        self._table.update(blocks)

    def lookup(self, block):
        return self._table.lookup(block)

    def lookup_many(self, blocks):
        return self._table.lookup_many(blocks)

    def dense(self, n_blocks: int) -> torch.Tensor:
        return self._table.dense(n_blocks)

    def on_intervals(self, n: int) -> None:  # mux-owned (TenantMux._advance_shared_clock)
        pass

    @property
    def tags(self):
        return self._table.tags

    @property
    def counters(self):
        return self._table.counters

    @property
    def flushes(self):
        return self._table.flushes


class TenantMux:
    """Demultiplex a tenant-tagged fault stream into per-tenant
    classifier->predictor pipelines on one device (the module docstring has
    the protocol).

    ``tenants`` pre-declares the tenant keys; ``auto_create=True`` admits an
    unseen tag by building its manager on first contact, ``False`` makes it
    a ``KeyError``.  ``tables`` seeds each tenant's model table: a dict
    keyed by tenant, or one Section V-A master that every tenant clones.
    ``qos`` attaches a :class:`~repro_torch.uvm.qos.BudgetController`
    (``None``: one shared capacity pool).
    """

    def __init__(
        self,
        cfg: ManagerConfig,
        tenants=(),
        *,
        shared_freq_table: bool = False,
        auto_create: bool = True,
        tables: dict | ModelTable | None = None,
        trainer: Trainer | None = None,
        qos=None,
        device: str | torch.device = "cuda",
    ):
        if (cfg.classifier, cfg.freq_table) != ("dfa", "setassoc"):
            raise _unported(f"the component registry (classifier {cfg.classifier!r}, freq_table "
                            f"{cfg.freq_table!r}; only 'dfa' / 'setassoc' are builtin)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.shared_freq_table = shared_freq_table
        self.auto_create = auto_create
        self._tables = tables
        self.trainer = trainer if trainer is not None else Trainer(cfg.predictor, cfg.train, cfg.kind, self.device)
        self._shared_freq = PredictionFrequencyTable(device=self.device) if shared_freq_table else None
        self.qos = qos
        self.managers: dict = {}
        # released tenants' final counts, so departure keeps them in the views
        self._departed: dict = {}
        self.per_group: list[float] = []  # batch accuracies in dispatch order
        self._round: list[tuple] | None = None  # [(tenant, positions, n)] of the last observe
        self._last_feedback: list[tuple] = []  # feedback_begin's pairs, for feedback_finish
        # the mux-owned flush cadence of the shared table (rebased like a manager's)
        self._fault_base = 0
        self._fault_raw = 0
        self._flush_interval = 0
        for t in tenants:
            self._create(t)

    # -- tenant admission ----------------------------------------------------

    def _create(self, key) -> OversubscriptionManager:
        table = self._tables
        if isinstance(table, dict):
            table = table.get(key)
        elif isinstance(table, ModelTable):
            table = table.clone()  # one warm master, a private copy per tenant
        view = _SharedFreqTableView(self._shared_freq) if self._shared_freq is not None else None
        mgr = OversubscriptionManager(self.cfg, table=table, trainer=self.trainer, freq_table=view,
                                      device=self.device)
        self.managers[key] = mgr
        return mgr

    def tenant(self, key) -> OversubscriptionManager:
        """The tenant's manager (admitting the key if ``auto_create``)."""
        if key not in self.managers:
            if not self.auto_create:
                raise KeyError(f"unknown tenant {key!r}; declared: {list(self.managers)}")
            self._create(key)
        return self.managers[key]

    def release(self, key) -> None:
        """Retire a departed tenant: drop its manager so its stale counters
        leave :meth:`_combined_dense`, keeping its accuracy and model counts
        for the result views, and return its QoS claim so budgets rebalance
        to the live tenants.  Idempotent; a re-appearing tag is re-admitted
        fresh."""
        m = self.managers.pop(key, None)
        if m is not None:
            self._departed[key] = {
                "corr": (m._corr_true, m._corr_n), "warm": (m._warm_true, m._warm_n),
                "top1": m.top1, "n_predictions": m.n_predictions,
                "n_classes": m.n_classes, "n_models": m.n_models,
            }
        if self.qos is not None:
            self.qos.release(key)
        if self._round is not None:
            self._round = [r for r in self._round if r[0] != key] or None

    def _split(self, batch: FaultBatch) -> list[tuple]:
        """Partition one batch by tenant tag, first-appearance order, each
        tenant's access order kept.  An untagged batch goes to the
        ``'default'`` tenant."""
        tags = batch.tenant
        if tags is None or np.ndim(tags) == 0:
            key = "default" if tags is None else (tags.item() if hasattr(tags, "item") else tags)
            return [(key, np.arange(len(batch)), batch)]
        keys, first = np.unique(tags, return_index=True)
        out = []
        for k in keys[np.argsort(first)]:
            idx = np.flatnonzero(tags == k)
            out.append((
                k.item() if hasattr(k, "item") else k,
                idx,
                FaultBatch(batch.page[idx], batch.pc[idx], batch.tb[idx], batch.kernel[idx]),
            ))
        return out

    # -- streaming protocol --------------------------------------------------

    def observe(self, batch: FaultBatch) -> MuxActions:
        """One full round: demux, per-tenant classify, one batched predictor
        dispatch, combined actions."""
        pairs, evals = self.observe_requests(batch)
        out: list | BaseException = []
        if evals:
            try:
                out = self.trainer.evaluate_many(
                    [r.params for _, r in evals], [r.fs for _, r in evals], [r.n_active for _, r in evals],
                )
            except Exception as exc:  # noqa: BLE001 — observe_apply re-raises it (no health machine)
                out = exc
        return self.observe_apply(pairs, evals, out)

    def observe_requests(self, batch: FaultBatch):
        """Demux and classify via :meth:`observe_begin`, then each tenant's
        pre-dispatch guard.  Returns ``(pairs, evals)``: every ``(tenant,
        request)`` pair and the subset to send to the trainer."""
        pairs = self.observe_begin(batch)
        evals = [(k, r) for k, r in pairs if r is not None and self.managers[k].guard_dispatch(r)]
        return pairs, evals

    def observe_apply(self, pairs, evals, out) -> MuxActions:
        """Fold ``evaluate_many``'s results (aligned with ``evals``) into
        :meth:`observe_finish`; an exception from it is raised again."""
        dispatched = {id(r) for _, r in evals}
        if isinstance(out, BaseException):
            if self.cfg.health is None:
                raise out
            for k, _r in evals:
                self.managers[k].note_fault(out)
            out = [None] * len(evals)
        else:
            out = [res if self.managers[k].check_result(*res) else None for (k, _r), res in zip(evals, out)]
        results = iter(out)
        return self.observe_finish(
            [next(results) if (r is not None and id(r) in dispatched) else None for _, r in pairs]
        )

    def feedback(self, outcomes: Outcomes, *, tenant=_UNSET) -> None:
        """Close the last round (or one tenant's pending batch): split the
        outcome report, advance every observed tenant's fault clock, send the
        fine-tunes through one ``train_group_many`` call."""
        pairs, treqs = self.feedback_requests(outcomes, tenant=tenant)
        exc = None
        try:
            self.trainer.train_group_many(
                [r.entry for _, r in treqs], [r.fs for _, r in treqs], [r.n_active for _, r in treqs],
                in_et_list=[r.in_et for _, r in treqs], use_lucir=self.cfg.use_lucir,
            )
        except Exception as e:  # noqa: BLE001 — feedback_apply re-raises it (no health machine)
            exc = e
        self.feedback_apply(pairs, treqs, exc)

    def feedback_requests(self, outcomes: Outcomes, *, tenant=_UNSET):
        """Split the outcome report and stage each tenant's fine-tune.
        Returns ``(pairs, treqs)``: every ``(tenant, request)`` pair and the
        non-``None`` subset for ``train_group_many``."""
        pairs = self.feedback_begin(outcomes, tenant=tenant)
        treqs = [(k, r) for k, r in pairs if r is not None]
        return pairs, treqs

    def feedback_apply(self, pairs, treqs, exc) -> None:
        """Publish the fine-tuned entries (updated in place); an exception
        from ``train_group_many`` is raised again."""
        if exc is not None:
            if self.cfg.health is None:
                raise exc
            for k, _r in treqs:
                self.managers[k].note_fault(exc)
                self.managers[k]._pending = None
            self.feedback_finish([None] * len(pairs))
            return
        self.feedback_finish([r.entry if r is not None else None for _, r in pairs])

    # -- staged halves ---------------------------------------------------------

    def observe_begin(self, batch: FaultBatch) -> list[tuple[object, EvalRequest | None]]:
        """Demux and per-tenant ingest/classify; ``(tenant, request)`` pairs
        in first-appearance order (``None`` where a tenant's slice yields no
        window sample)."""
        batch = batch if isinstance(batch, FaultBatch) else FaultBatch(np.asarray(batch))
        split = self._split(batch)
        self._round = [(k, idx, len(idx)) for k, idx, _ in split]
        if self.qos is not None:
            for k, _idx, sub in split:
                self.qos.observe_blocks(k, np.unique(np.asarray(sub.page, np.int64) // self.cfg.pages_per_block))
        return [(k, self.tenant(k).observe_begin(sub)) for k, idx, sub in split]

    def observe_finish(self, results: list) -> MuxActions:
        """Fold each tenant's predictor output (``(corr, pred_cls)`` or
        ``None``, aligned with ``observe_begin``'s pairs) and combine the
        device-wide artifacts."""
        if self._round is None:
            raise RuntimeError("observe_finish() without observe_begin()")
        per_tenant: dict = {}
        for (k, _idx, _n), res in zip(self._round, results):
            corr, pred = res if res is not None else (None, None)
            actions = self.managers[k].observe_finish(corr, pred)
            per_tenant[k] = actions
            if actions.accuracy is not None:
                self.per_group.append(actions.accuracy)
        warm_any = any(a.counters is not None for a in per_tenant.values())
        return MuxActions(
            per_tenant=per_tenant,
            prefetch_blocks=_stable_unique([a.prefetch_blocks for a in per_tenant.values()]),
            counters=self._combined_dense() if warm_any else None,
            pre_evict_blocks=_round_robin([a.pre_evict_blocks for a in per_tenant.values()]),
            budgets=dict(self.qos.budgets) if self.qos is not None else None,
        )

    def feedback_begin(self, outcomes: Outcomes, *, tenant=_UNSET) -> list[tuple[object, TrainRequest | None]]:
        """Split the outcome report along the last round's partition (or
        hand it whole to one tenant) and stage each fine-tune."""
        self._advance_shared_clock(outcomes)
        if tenant is not _UNSET:
            out = [(tenant, self.tenant(tenant).feedback_begin(outcomes))]
            # the tenant's slot in a pending round is closed now
            if self._round is not None:
                self._round = [r for r in self._round if r[0] != tenant] or None
            if self.qos is not None:
                self.qos.observe_pressure(tenant, _thrash_rate(outcomes.was_evicted))
                self.qos.step()
            self._last_feedback = out
            return out
        if self._round is None:
            raise RuntimeError("feedback() without a pending observe() round")
        we = None if outcomes.was_evicted is None else np.asarray(outcomes.was_evicted)
        out = []
        for k, idx, _n in self._round:
            sub = Outcomes(was_evicted=None if we is None else we[idx],
                           fault_count=outcomes.fault_count)  # the global device clock
            # the tenant's thrash rate this round is the budgets' pressure signal
            if self.qos is not None:
                self.qos.observe_pressure(k, _thrash_rate(sub.was_evicted))
            out.append((k, self.managers[k].feedback_begin(sub)))
        if self.qos is not None:
            self.qos.step()
        self._round = None
        self._last_feedback = out
        return out

    def feedback_finish(self, entries: list) -> None:
        """Publish each tenant's fine-tuned entry (aligned with
        ``feedback_begin``'s pairs; ``None``: nothing was staged)."""
        for (k, _r), entry in zip(self._last_feedback, entries):
            if entry is not None:
                self.managers[k].feedback_finish(entry)

    # -- snapshots (not ported) --------------------------------------------------

    def state(self) -> dict:
        raise _unported("TenantMux.state (manager/snapshot.py)")

    def restore(self, state: dict) -> None:
        raise _unported("TenantMux.restore (manager/snapshot.py)")

    # -- combined artifacts ------------------------------------------------------

    def _advance_shared_clock(self, outcomes: Outcomes) -> None:
        """Advance the shared table's flush cadence from the global fault
        clock, once per device interval however many tenants reported it;
        a no-op with isolated tables."""
        if self._shared_freq is None:
            return
        raw = int(outcomes.fault_count)
        if raw < self._fault_raw:  # consumer switch: its clock restarted at 0
            self._fault_base += self._fault_raw
        self._fault_raw = raw
        interval_now = (self._fault_base + raw) // INTERVAL_FAULTS
        if interval_now > self._flush_interval:
            self._shared_freq.on_intervals(interval_now - self._flush_interval)
            self._flush_interval = interval_now

    def _combined_dense(self) -> torch.Tensor:
        """The device-wide dense frequency export, on the device: the shared
        table directly, or the elementwise maximum of the live tenants'
        tables (-1: never predicted)."""
        nb = self.cfg.n_blocks
        if self._shared_freq is not None:
            return self._shared_freq.dense(nb)
        if not self.managers:
            return torch.full((nb,), -1, dtype=torch.int32, device=self.device)  # every tenant released
        out = None
        for m in self.managers.values():
            d = m.freq_table.dense(nb)
            out = d if out is None else torch.maximum(out, d)
        return out

    def evict_pref(self, resident: torch.Tensor) -> torch.Tensor | None:
        """The QoS leading victim key for ``resident`` (the simulator's bool
        residency mask), an int32 tensor on the mux's device; ``None``
        without a budget controller (the three-key program).  The budgets
        live on the host, so this reads the mask back once per call."""
        if self.qos is None:
            return None
        pref = self.qos.evict_pref(resident.cpu().numpy())
        return torch.tensor(pref, device=self.device)

    # -- result views ----------------------------------------------------------

    @property
    def top1(self) -> float:
        t = sum(m._corr_true for m in self.managers.values()) + sum(d["corr"][0] for d in self._departed.values())
        n = sum(m._corr_n for m in self.managers.values()) + sum(d["corr"][1] for d in self._departed.values())
        return t / n if n else 0.0

    @property
    def warm_top1(self) -> float:
        t = sum(m._warm_true for m in self.managers.values()) + sum(d["warm"][0] for d in self._departed.values())
        n = sum(m._warm_n for m in self.managers.values()) + sum(d["warm"][1] for d in self._departed.values())
        return t / n if n else self.top1

    @property
    def n_predictions(self) -> int:
        return sum(m.n_predictions for m in self.managers.values()) + \
            sum(d["n_predictions"] for d in self._departed.values())

    @property
    def n_classes(self) -> int:
        return sum(m.n_classes for m in self.managers.values()) + \
            sum(d["n_classes"] for d in self._departed.values())

    @property
    def n_models(self) -> int:
        return sum(m.n_models for m in self.managers.values()) + sum(d["n_models"] for d in self._departed.values())

    @property
    def per_tenant_top1(self) -> dict:
        out = {str(k): d["top1"] for k, d in self._departed.items()}
        out.update({str(k): m.top1 for k, m in self.managers.items()})
        return out
