"""The paper's online loop end to end, on one device (port of
``repro.uvm.runtime``'s serial drivers).  Per group of accesses:

  1. ``manager.observe(FaultBatch)`` — classify the group, predict each
     access's next page delta with the pattern's model (strictly before
     training on it), update the prediction-frequency table and return the
     staged prefetches + dense counters (Section IV-D)
  2. :func:`_apply_actions` — export the counters to the simulator's
     ``learned`` eviction keys and stage the prefetches
  3. ``simulator.run_segment`` — demand migration + learned eviction
  4. ``manager.feedback(Outcomes)`` — advance the flush cadence and
     fine-tune the pattern's model on the group (CE + LUCIR + the
     thrashing term, AdamW; ``TrainConfig.epochs == 0`` freezes it)

A tenant-tagged trace (a :func:`repro_torch.uvm.trace.concurrent` merge,
Section V-F) runs through a :class:`~repro_torch.uvm.manager.TenantMux` by
default: one pipeline per tenant, their combined prefetches and counters
staged into one simulator over the merged device; ``multi_tenant=False``
drives it through one merged manager instead (the paper's baseline).
:func:`run_ours_many` drives many traces, one :func:`run_ours` each.

Model, frequency table and simulator state live on the device (``"cuda"``
unless the caller passes ``device="cpu"``).  Pretrained tables come from
the JAX package's memo pickles (:func:`load_pretrain_memo`) or from the
``.npz`` written by ``scripts/export_torch_reference.py``
(:func:`load_pretrained`), or are trained here by :func:`pretrain_table`
(Section V-A), which reads the JAX package's memo of the same recipe when
``memo_dir`` holds it and never writes one.
"""
from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.predictor_paper import PredictorConfig
from repro_torch.core.features import DeltaVocab, FeatureStream
from repro_torch.core.incremental import TrainConfig, Trainer
from repro_torch.core.model_table import ModelTable
from repro_torch.core.pattern import PatternClassifier
from repro_torch.device import resolve_device
from repro_torch.uvm import simulator as S
from repro_torch.uvm import timing
from repro_torch.uvm.manager import FaultBatch, ManagerConfig, Outcomes, OversubscriptionManager, TenantMux
from repro_torch.uvm.trace import PAGES_PER_BLOCK, Trace

@dataclasses.dataclass
class LearnedRunResult:
    stats: dict
    top1: float
    n_predictions: int
    n_classes: int
    n_models: int
    per_group_acc: list
    warm_top1: float = 0.0  # excludes each pattern-model's first (cold) group
    n_accesses: int = 0
    #: per-tenant strictly causal top-1 (mux runs only), keyed by str(tenant)
    per_tenant_top1: dict | None = None
    #: per-tenant {pages_thrashed, faults, accesses} (tenant-tagged runs
    #: only), each event counted for the tenant of the access that caused it
    per_tenant_stats: dict | None = None
    #: final per-tenant QoS block budgets (budgeted mux runs only)
    budgets: dict | None = None

    def ipc(self, pred_overhead_us: float = 1.0, n_accesses: int | None = None) -> float:
        # the predictor runs asynchronously with kernel execution; only
        # predictions consumed on the fault path serialise, so the overhead
        # is charged per far-fault (Section V-A/C, Fig. 13)
        if n_accesses is None:
            n_accesses = self.n_accesses
        if not n_accesses:
            raise ValueError("n_accesses is 0; pass ipc(..., n_accesses=len(trace)) explicitly")
        charged = min(self.n_predictions, self.stats["faults"])
        return timing.ipc(self.stats, n_accesses, pred_overhead_us=pred_overhead_us, n_predictions=charged)


def _pretrain_cache_key(corpus, pcfg, tcfg, kind, target_acc, max_rounds) -> str:
    """The JAX package's pretrain memo key (``pretrain_<key>.pkl``)."""
    h = hashlib.md5()
    for tr in corpus:
        h.update(tr.name.encode())
        h.update(str(tr.n_pages).encode())
        for arr in (tr.page, tr.pc, tr.tb, tr.kernel):
            h.update(np.ascontiguousarray(arr))
    h.update(repr((pcfg, dataclasses.astuple(tcfg), kind, target_acc, max_rounds)).encode())
    return h.hexdigest()[:16]


def load_pretrain_memo(path: str | Path, pcfg: PredictorConfig, device: str | torch.device = "cuda",
                       fresh: dict | None = None) -> ModelTable:
    """A JAX-package pretrain memo (``experiments/cache/pretrain_*.pkl``, the
    raw host table or its checksummed envelope) as a table on ``device``;
    ``fresh`` as in :func:`repro_torch.convert.table_from_blob`."""
    obj = convert.unpickle_jax(Path(path).read_bytes())
    if isinstance(obj, dict) and "sha256" in obj and "payload" in obj:
        if hashlib.sha256(obj["payload"]).hexdigest() != obj["sha256"]:
            raise ValueError(f"pretrain memo {path} fails its checksum")
        obj = convert.unpickle_jax(obj["payload"])
    return convert.table_from_blob(obj, pcfg, device, fresh)


def load_pretrained(path: str | Path, pcfg: PredictorConfig, device: str | torch.device = "cuda",
                    fresh: dict | None = None) -> ModelTable:
    """A pretrained table from a memo pickle or an exported ``.npz``.  Slots
    it lacks start from ``fresh[slot]`` where given (a mapping slot ->
    params, e.g. :func:`repro_torch.convert.fresh_slots` of the JAX
    package's exported initial weights), else from ``predictor.init``'s
    draws of them."""
    if Path(path).suffix == ".npz":
        return convert.table_from_blob(convert.blob_from_npz(path), pcfg, device, fresh)
    return load_pretrain_memo(path, pcfg, device, fresh)


def pretrain_table(
    corpus: list[Trace],
    pcfg: PredictorConfig,
    tcfg: TrainConfig,
    *,
    kind: str = "transformer",
    target_acc: float = 0.85,
    max_rounds: int = 4,
    memo_dir: str | Path | None = None,
    device: str | torch.device = "cuda",
) -> ModelTable:
    """Section V-A: build a per-pattern corpus from (different-input) runs of
    benchmarks and pre-train each pattern's model until accuracy is
    reasonable, to hide the initial training latency.  Each trace's first
    half is cut into groups; every round evaluates and then fine-tunes each
    group's pattern model, until the mean corpus accuracy reaches
    ``target_acc`` or ``max_rounds`` rounds have run.

    ``memo_dir``: a directory of the JAX package's pretrain memos
    (``experiments/cache/``); when it holds ``pretrain_<key>.pkl`` for this
    recipe (:func:`_pretrain_cache_key`), that table is loaded instead of
    trained.  The port never writes a memo: the directory is the JAX
    package's, which would load a port-trained table under its key."""
    if memo_dir is not None:
        path = Path(memo_dir) / f"pretrain_{_pretrain_cache_key(corpus, pcfg, tcfg, kind, target_acc, max_rounds)}.pkl"
        if path.exists():
            return load_pretrain_memo(path, pcfg, device)
    trainer = Trainer(pcfg, tcfg, kind, device)
    table = ModelTable(lambda s: trainer.new_params(s), n_slots=tcfg.table_slots)
    classifier = PatternClassifier()
    groups = []  # (pattern, FeatureSet, n_active)
    for tr in corpus:
        vocab = DeltaVocab(pcfg.delta_vocab)
        stream = FeatureStream(tr, vocab, pcfg.history, page_vocab=pcfg.page_vocab, pc_vocab=pcfg.pc_vocab,
                               tb_vocab=pcfg.tb_vocab)
        half = len(tr) // 2
        for g0 in range(0, half, tcfg.group_size):
            g1 = min(g0 + tcfg.group_size, half)
            fs = stream.windows(g0, g1)
            if len(fs):
                pat = classifier.classify(tr.block[g0:g1], tr.kernel[g0:g1])
                groups.append((pat, fs, max(vocab.n_classes, 2)))
    for _ in range(max_rounds):
        accs = []
        for pat, fs, n_active in groups:
            entry = table.get(pat)
            corr, _ = trainer.evaluate(entry.params, fs, n_active)
            accs.append(corr.mean())
            # corpus accuracy seeds the prefetch gate CONSERVATIVELY: transfer
            # to an unseen trace is unproven until measured on it
            entry.last_acc = min(float(corr.mean()), 0.5)
            entry = trainer.train_group(entry, fs, n_active)
            table.put(pat, entry)
        if accs and float(np.mean(accs)) >= target_acc:
            break
    return table


def _manager_config(trace: Trace, pcfg: PredictorConfig, tcfg: TrainConfig, *, oversubscription: float,
                    kind: str, use_thrash_term: bool, use_lucir: bool, reclass_interval: int = 0,
                    reclass_hysteresis: int = 2, health=None) -> ManagerConfig:
    return ManagerConfig(
        predictor=pcfg, train=tcfg, kind=kind,
        n_pages=trace.n_pages,
        n_blocks=S.bucket_blocks(trace.n_blocks),
        capacity=S.capacity_for(trace.n_blocks, oversubscription),
        use_thrash_term=use_thrash_term, use_lucir=use_lucir,
        reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
        health=health,
    )


def manager_for(
    trace: Trace,
    pcfg: PredictorConfig | None = None,
    tcfg: TrainConfig | None = None,
    *,
    oversubscription: float = 1.25,
    kind: str = "transformer",
    table: ModelTable | None = None,
    use_thrash_term: bool = True,
    use_lucir: bool = True,
    reclass_interval: int = 0,
    reclass_hysteresis: int = 2,
    health=None,
    device: str | torch.device = "cuda",
) -> OversubscriptionManager:
    """An :class:`OversubscriptionManager` configured for one trace's
    geometry (padded block bucket + oversubscribed capacity)."""
    cfg = _manager_config(
        trace, pcfg or PredictorConfig(), tcfg or TrainConfig(),
        oversubscription=oversubscription, kind=kind,
        use_thrash_term=use_thrash_term, use_lucir=use_lucir,
        reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
        health=health,
    )
    return OversubscriptionManager(cfg, table=table, device=device)


def mux_for(
    trace: Trace,
    pcfg: PredictorConfig | None = None,
    tcfg: TrainConfig | None = None,
    *,
    oversubscription: float = 1.25,
    kind: str = "transformer",
    table: ModelTable | None = None,
    use_thrash_term: bool = True,
    use_lucir: bool = True,
    shared_freq_table: bool = False,
    reclass_interval: int = 0,
    reclass_hysteresis: int = 2,
    health=None,
    trainer: Trainer | None = None,
    qos=None,
    device: str | torch.device = "cuda",
) -> TenantMux:
    """A :class:`TenantMux` for a tenant-tagged concurrent trace (Section
    V-F): one manager per tenant over the merged geometry (tenants hold
    disjoint page ranges of the shared device, so every pipeline sees global
    page ids).  ``table`` is a Section V-A master each tenant clones.
    ``qos`` opts the mux into per-tenant capacity partitioning: a
    :class:`~repro_torch.uvm.api.specs.QosSpec` (tiers keyed by the trace's
    ``tenant_names``, resolved here against its geometry) or a built
    :class:`~repro_torch.uvm.qos.BudgetController`."""
    if trace.tenant is None:
        raise ValueError(f"trace {trace.name!r} has no tenant tags; use manager_for() instead")
    cfg = _manager_config(
        trace, pcfg or PredictorConfig(), tcfg or TrainConfig(),
        oversubscription=oversubscription, kind=kind,
        use_thrash_term=use_thrash_term, use_lucir=use_lucir,
        reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
        health=health,
    )
    if qos is not None and hasattr(qos, "controller"):  # a QosSpec
        qos = qos.controller(cfg.capacity, cfg.n_blocks, trace.tenant_names)
    tenants = [int(t) for t in np.unique(trace.tenant)]
    return TenantMux(cfg, tenants, shared_freq_table=shared_freq_table, auto_create=False, tables=table,
                     trainer=trainer, qos=qos, device=resolve_device(device))


def _group_batch(trace: Trace, g0: int, g1: int) -> FaultBatch:
    return FaultBatch(trace.page[g0:g1], trace.pc[g0:g1], trace.tb[g0:g1], trace.kernel[g0:g1],
                      tenant=None if trace.tenant is None else trace.tenant[g0:g1])


def _apply_actions(state: S.SimState, actions, nb: int, cap: int, evict_pref=None) -> S.SimState:
    """Stage one batch's actions into the simulator state: export the dense
    counters to the `learned` eviction keys, then apply the prefetches
    (``counters is None``: the gate was closed, nothing to stage)."""
    if actions.counters is None:
        return state
    state = dataclasses.replace(state, freq=actions.counters)
    mask = torch.zeros(nb, dtype=torch.bool, device=state.device)
    mask[torch.as_tensor(actions.prefetch_blocks, device=state.device)] = True
    return S.apply_prefetch(state, mask, capacity=cap, policy="learned", evict_pref=evict_pref)


def _result(mgr, state: S.SimState, n_accesses: int, per_tenant_stats: dict | None = None) -> LearnedRunResult:
    is_mux = isinstance(mgr, TenantMux)
    return LearnedRunResult(
        S.state_stats(state), mgr.top1, mgr.n_predictions, mgr.n_classes,
        mgr.n_models, mgr.per_group, mgr.warm_top1, n_accesses,
        per_tenant_top1=mgr.per_tenant_top1 if is_mux else None,
        per_tenant_stats=per_tenant_stats,
        budgets={str(k): v for k, v in mgr.qos.budgets.items()} if is_mux and mgr.qos is not None else None,
    )


class _TenantLedger:
    """Per-tenant fairness accounting and QoS departures for one
    tenant-tagged trace: each group's thrash and fault events go to the
    tenant of the access that caused them, and (budgeted runs only) a
    tenant is released from the mux once its last access is behind us, so
    its counters and budget slice rebalance to the tenants still running."""

    def __init__(self, trace: Trace, mgr):
        tn = np.asarray(trace.tenant)
        self.trace = trace
        self.mgr = mgr if isinstance(mgr, TenantMux) else None
        self.stats = {int(t): {"pages_thrashed": 0, "faults": 0, "accesses": 0} for t in np.unique(tn)}
        # releasing is observable (combined counters shrink), so only a
        # budgeted run does it, as in the reference
        self.departs = ({int(t): int(np.max(np.nonzero(tn == t)[0])) for t in np.unique(tn)}
                        if self.mgr is not None and self.mgr.qos is not None else {})

    def account(self, g0: int, g1: int, outs: dict) -> None:
        """``outs`` is ``run_segment``'s per-access outputs, already host
        arrays: this adds no device sync."""
        tn = self.trace.tenant[g0:g1]
        th = np.asarray(outs["thrash"])
        fa = np.asarray(outs["fault"])
        for t in np.unique(tn):
            m = tn == t
            d = self.stats[int(t)]
            d["pages_thrashed"] += int(th[m].sum()) * PAGES_PER_BLOCK
            d["faults"] += int(fa[m].sum())
            d["accesses"] += int(m.sum())
        if g1 < len(self.trace):  # keep final-group tenants admitted
            for t in [t for t, last in self.departs.items() if last < g1]:
                del self.departs[t]
                self.mgr.release(t)

    def result(self) -> dict:
        return {str(t): dict(d) for t, d in self.stats.items()}


def run_ours(
    trace: Trace,
    pcfg: PredictorConfig | None = None,
    tcfg: TrainConfig | None = None,
    *,
    oversubscription: float = 1.25,
    kind: str = "transformer",
    table: ModelTable | None = None,
    use_thrash_term: bool = True,
    use_lucir: bool = True,
    manager: OversubscriptionManager | TenantMux | None = None,
    multi_tenant: bool | None = None,
    shared_freq_table: bool = False,
    reclass_interval: int = 0,
    reclass_hysteresis: int = 2,
    health=None,
    qos=None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> LearnedRunResult:
    """Drive one trace through the streaming manager + simulator on
    ``device`` (a passed ``manager`` brings its own device; ``seed`` seeds
    the simulator state, as a sim cell's does).

    A tenant-tagged trace goes through a :class:`TenantMux` unless
    ``multi_tenant=False`` (one manager over the merged stream, the Section
    V-F baseline); ``shared_freq_table`` gives the mux's tenants one
    frequency table.  Either way the result carries each tenant's
    ``per_tenant_stats``.  ``qos`` (a :class:`~repro_torch.uvm.api.specs.
    QosSpec` or a built :class:`~repro_torch.uvm.qos.BudgetController`)
    opts the mux run into per-tenant capacity partitioning: the budgets
    become the leading victim key, rebalance from observed pressure, and a
    tenant whose trace is exhausted is released; the result carries the
    final ``budgets``."""
    pcfg = pcfg or PredictorConfig()
    tcfg = tcfg or TrainConfig()
    if multi_tenant is None:
        multi_tenant = trace.tenant is not None
    if qos is not None and not multi_tenant:
        raise ValueError("qos= requires a tenant-tagged multi-tenant run")
    if manager is not None:
        mgr = manager
    elif multi_tenant:
        mgr = mux_for(
            trace, pcfg, tcfg, oversubscription=oversubscription, kind=kind,
            table=table, use_thrash_term=use_thrash_term, use_lucir=use_lucir,
            shared_freq_table=shared_freq_table,
            reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
            health=health, qos=qos, device=device,
        )
    else:
        mgr = manager_for(
            trace, pcfg, tcfg, oversubscription=oversubscription, kind=kind,
            table=table, use_thrash_term=use_thrash_term, use_lucir=use_lucir,
            reclass_interval=reclass_interval, reclass_hysteresis=reclass_hysteresis,
            health=health, device=resolve_device(device),
        )
    nb, cap = mgr.cfg.n_blocks, mgr.cfg.capacity
    state = S.init_state(nb, mgr.device, seed)
    blocks = trace.block.astype(np.int32)
    nxt = S.next_use_for(trace)
    ledger = _TenantLedger(trace, mgr) if trace.tenant is not None else None
    n = len(trace)
    # the manager's own schedule sets the batch cadence
    G = mgr.cfg.train.group_size
    for g0 in range(0, n, G):
        g1 = min(g0 + G, n)
        actions = mgr.observe(_group_batch(trace, g0, g1))
        # the QoS leading victim key (None: no budgets, the plain program)
        ep = mgr.evict_pref(state.resident) if isinstance(mgr, TenantMux) else None
        state = _apply_actions(state, actions, nb, cap, evict_pref=ep)
        state, outs = S.run_segment(
            state, blocks[g0:g1], nxt[g0:g1],
            capacity=cap, policy="learned", prefetch="demand", n_valid=trace.n_blocks, evict_pref=ep,
        )
        mgr.feedback(Outcomes(was_evicted=outs["was_evicted"], fault_count=int(state.fault_count)))
        if ledger is not None:
            ledger.account(g0, g1, outs)
    return _result(mgr, state, n, None if ledger is None else ledger.result())


def run_ours_many(
    traces: list[Trace],
    pcfg: PredictorConfig | None = None,
    tcfg: TrainConfig | None = None,
    *,
    tables: list[ModelTable] | None = None,
    qos=None,
    multi_tenant: bool | None = None,
    **kw,
) -> list[LearnedRunResult]:
    """Run the learned system over many traces, one :func:`run_ours` per
    lane (``kw`` are its keywords); each lane keeps its own manager and
    simulator state, so its result is its serial run's.  The reference's
    lockstep order (one ``evaluate_many`` and one ``train_group_many`` over
    every lane per group) changes nothing while those run lane by lane; it
    comes with stacking lanes into one launch per kernel (ROADMAP A5b).

    ``tables`` gives each lane its pretrained table; ``qos`` (one
    :class:`~repro_torch.uvm.api.specs.QosSpec`) opts every tenant-tagged
    lane into per-tenant capacity partitioning, each with its own
    controller, and raises before any run on an untagged lane."""
    if qos is not None:
        for trace in traces:
            if not (trace.tenant is not None if multi_tenant is None else multi_tenant):
                raise ValueError(f"qos= requires tenant-tagged lanes; trace {trace.name!r} has none")
    return [run_ours(trace, pcfg, tcfg, table=tables[i] if tables is not None else None, qos=qos,
                     multi_tenant=multi_tenant, **kw)
            for i, trace in enumerate(traces)]
