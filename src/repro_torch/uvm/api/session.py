"""`Session`: the spec-driven experiment runner behind the CLI (port of
``repro.uvm.api.session``).

A Session executes :class:`~repro_torch.uvm.api.specs.CellSpec` /
:class:`~repro_torch.uvm.api.specs.ProtocolSpec` cells on one device
(``"cuda"`` unless the caller passes ``device="cpu"``) and serves every
repeat from two layers of cache:

* an in-process memo (one entry per spec content key), and
* the persistent content-addressed :class:`~repro_torch.uvm.api.store.RunStore`
  under ``experiments/runs_torch/`` — so a second process (or a CLI
  invocation after another) never recomputes a cell it can look up.

The keys are the JAX package's, and so is the record format, but the
default root is the port's own: a fine-tuned result is not the same across
frameworks, so a store shared with the JAX package would hand one
framework's result to the other.

Cells are grouped as the reference groups them: the ``sim`` cells of one
workload run through one :func:`repro_torch.uvm.simulator.run_batch` call,
``ours`` cells that share a model, oversubscription and seed run one after
another through :func:`repro_torch.uvm.runtime.run_ours` from one shared
pretrained table (the reference's engine on one device), and ``uvmsmart``
cells one after another.  Threads would add nothing on one stream, and the
kernels' launch counters are not thread-safe.  Counters are bit-identical
to the single-cell entry points for every policy except ``random``, whose
cells are memoised in process but never persisted, as in the reference.

The reference's ``enable_compile_cache`` (a persistent XLA compilation
cache) has no counterpart: the port's kernels build once into
``build/torch_kernels/``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from repro_torch.configs.predictor_paper import CONFIG as PCFG_PAPER
from repro_torch.configs.predictor_paper import CONFIG_QUICK as PCFG_QUICK
from repro_torch.core.incremental import RunResult, TrainConfig, run_protocol
from repro_torch.core.model_table import ModelTable
from repro_torch.device import resolve_device
from repro_torch.uvm import runtime as R
from repro_torch.uvm import simulator as S
from repro_torch.uvm import timing
from repro_torch.uvm import trace as T
from repro_torch.uvm import zoo
from repro_torch.uvm.api.specs import (
    PAPER_TRAIN,
    PRETRAIN_BENCHES,
    SCALE_PRESETS,
    CellSpec,
    ExperimentSpec,
    ModelSpec,
    PolicySpec,
    PrefetchSpec,
    PretrainSpec,
    ProtocolSpec,
    TrainSpec,
    WorkloadSpec,
)
from repro_torch.uvm.api.store import RunStore
from repro_torch.uvm.runtime import LearnedRunResult
from repro_torch.uvm.uvmsmart import run_uvmsmart

ALL_BENCH = list(T.BENCHMARKS)
FEATURED = ["ATAX", "BICG", "Hotspot", "NW", "Srad-v2"]  # the paper's focus set

#: predictor kinds whose implementation lives in this repo (safe to persist)
_BUILTIN_PREDICTORS = frozenset({"transformer", "lstm", "cnn", "mlp"})

EXPERIMENTS = Path(__file__).resolve().parents[4] / "experiments"
#: the JAX package's pretrain memos (read, never written)
MEMO_DIR = EXPERIMENTS / "cache"
#: the committed exports of the paper preset's Section V-A tables (every
#: slot's params and AdamW moments), by ``PretrainSpec.seed0``: the
#: reference's ``Session.paper().pretrained()``, Table VII's and Fig. 11's
PAPER_TABLES = {777: EXPERIMENTS / "torch" / "pretrain_paper.npz",
                321: EXPERIMENTS / "torch" / "pretrain_paper_s321.npz",
                123: EXPERIMENTS / "torch" / "pretrain_paper_s123.npz"}
#: the committed exports of the quick preset's Section V-A tables, by
#: ``seed0``: Table VII's (the quick ``ours`` table is the JAX package's
#: memo in ``MEMO_DIR``; Fig. 11's, ``seed0=123``, is not committed)
QUICK_TABLES = {321: EXPERIMENTS / "torch" / "pretrain_quick_s321.npz"}


def _export_of(pspec: PretrainSpec, pcfg, train: TrainConfig, kind: str) -> Path | None:
    """The committed export of a recipe, if it is exactly the paper
    preset's (``CONFIG``, ``PAPER_TRAIN``, scale ``1.0 * 0.6``) or the quick
    preset's (``CONFIG_QUICK``, ``TrainSpec()``, scale ``0.4 * 0.6``) over
    the default corpus in two rounds, with a ``seed0`` that has one."""
    presets = ((PAPER_TABLES, PCFG_PAPER, PAPER_TRAIN, 1.0), (QUICK_TABLES, PCFG_QUICK, TrainSpec(), 0.4))
    for exports, preset_pcfg, preset_train, scale in presets:
        recipe = PretrainSpec(benchmarks=PRETRAIN_BENCHES, scale=scale * 0.6, seed0=pspec.seed0, max_rounds=2)
        if (pspec.seed0 in exports and pspec == recipe
                and (pcfg, train, kind) == (preset_pcfg, preset_train.to_train_config(), "transformer")):
            return exports[pspec.seed0]
    return None


def pretrained_table(pspec: PretrainSpec, pcfg, train: TrainConfig, kind: str = "transformer", *,
                     memo_dir: str | Path | None = MEMO_DIR, fresh: dict | None = None,
                     device: str | torch.device = "cuda") -> ModelTable:
    """The Section V-A table of one recipe, a master that callers clone per
    use.  The paper preset's recipe (``CONFIG``, ``PAPER_TRAIN``, the
    default corpus at scale 0.6, two rounds) with ``seed0`` 777, 321 or 123,
    and the quick preset's (``CONFIG_QUICK``, ``TrainSpec()``, scale 0.24)
    with ``seed0`` 321, load the committed export (``PAPER_TABLES``,
    ``QUICK_TABLES``: params and AdamW moments; ``fresh`` gives the slots it
    lacks); any other recipe loads the JAX package's memo of it from
    ``memo_dir`` where there is one, else pretrains here."""
    export = _export_of(pspec, pcfg, train, kind)
    if export is not None:
        return R.load_pretrained(export, pcfg, device, fresh=fresh)
    corpus = [T.BENCHMARKS[n](scale=pspec.scale, seed=pspec.seed0 + i) for i, n in enumerate(pspec.benchmarks)]
    return R.pretrain_table(corpus, pcfg, train, kind=kind, max_rounds=pspec.max_rounds, memo_dir=memo_dir,
                            device=device)


def _learned_to_payload(res: LearnedRunResult) -> dict:
    return dataclasses.asdict(res)


def _payload_to_learned(payload: dict) -> LearnedRunResult:
    return LearnedRunResult(**payload)


def _protocol_to_payload(res: RunResult) -> dict:
    # the summary the tables/figures consume; the per-sample arrays are
    # derived data too bulky to persist per cell
    return {
        "top1": res.top1, "per_group": list(res.per_group),
        "n_classes": res.n_classes, "n_models": res.n_models, "n_samples": res.n_samples,
    }


def _payload_to_protocol(payload: dict) -> RunResult:
    return RunResult(
        top1=payload["top1"], per_group=payload["per_group"],
        n_classes=payload["n_classes"], n_models=payload["n_models"],
        n_samples=payload["n_samples"], predictions=None, t_index=None, correct=None,
    )


class Session:
    """Spec-driven runner with a persistent run store (see module docs).

    ``Session()`` is quick scale; ``Session.paper()`` is the full generator
    sizes and the paper's predictor.  ``store=None`` uses the default
    ``experiments/runs_torch/`` store; pass a :class:`RunStore` to relocate
    it or ``RunStore(enabled=False)`` / env ``REPRO_RUN_STORE=0`` to
    disable persistence.
    """

    # Every rule-based cell the tables/figures touch; a sim miss computes
    # the whole row for (workload, oversubscription).
    STANDARD_CELLS = (
        ("lru", "tree"), ("lru", "demand"), ("hpe", "demand"),
        ("hpe", "tree"), ("belady", "demand"),
    )

    def __init__(
        self,
        scale: float = SCALE_PRESETS["quick"][0],
        cap: int = SCALE_PRESETS["quick"][1],
        model: ModelSpec | None = None,
        benches: list | None = None,
        store: RunStore | None = None,
        device: str | torch.device = "cuda",
    ):
        self.scale = scale
        self.cap = cap
        self.model = model if model is not None else ModelSpec()
        self.benches = list(benches) if benches is not None else list(ALL_BENCH)
        self.store = store if store is not None else RunStore()
        self.device = resolve_device(device)
        self._tcfg = self.model.train.to_train_config()
        self._traces: dict = {}
        self._results: dict = {}  # spec key -> result object (in-process memo)
        self._pretrained: dict = {}  # (recipe, model-config) key -> ModelTable master
        self.counters = {"memory_hits": 0, "store_hits": 0, "computed": 0}

    @classmethod
    def paper(cls, **kw) -> "Session":
        kw.setdefault("scale", SCALE_PRESETS["paper"][0])
        kw.setdefault("cap", SCALE_PRESETS["paper"][1])
        kw.setdefault("model", ModelSpec(predictor=PCFG_PAPER, train=PAPER_TRAIN))
        return cls(**kw)

    # -- config views ---------------------------------------------------------

    @property
    def pcfg(self):
        return self.model.predictor

    @property
    def tcfg(self):
        return self._tcfg

    @property
    def default_pretrain(self) -> PretrainSpec:
        """The benchmark suite's Section V-A recipe at this session's scale."""
        return PretrainSpec(scale=self.scale * 0.6)

    # -- workloads ----------------------------------------------------------

    def workload(self, name: str) -> WorkloadSpec:
        return WorkloadSpec(name, self.scale, self.cap)

    def concurrent(self, tenants, *, slice_len: int = 256, seed: int = 0) -> WorkloadSpec:
        """A Section V-F multi-tenant workload of this session's scale."""
        return WorkloadSpec.concurrent(tenants, scale=self.scale, cap=self.cap, slice_len=slice_len, seed=seed)

    def drifting(self, phases, **kw) -> WorkloadSpec:
        """A drifting zoo workload (phase change or tenant churn) of this
        session's scale — see :meth:`WorkloadSpec.drifting` for the knobs."""
        kw.setdefault("scale", self.scale)
        kw.setdefault("cap", self.cap)
        return WorkloadSpec.drifting(phases, **kw)

    def _workload(self, w) -> WorkloadSpec:
        return self.workload(w) if isinstance(w, str) else w

    def trace(self, w: WorkloadSpec | str) -> T.Trace:
        w = self._workload(w)
        if w.key not in self._traces:
            if w.drift is not None:
                d = w.drift
                if d.kind == "churn":
                    tr = zoo.tenant_churn(d.phases, scale=w.scale, seed=d.seed,
                                          joins=d.joins, spans=d.spans, slice_len=w.slice_len)
                else:
                    tr = zoo.phase_trace(d.phases, scale=w.scale, seed=d.seed,
                                         segment=d.segment, switch=d.switch,
                                         mix_window=d.mix_window)
                self._traces[w.key] = tr.slice(0, min(len(tr), w.cap))
            elif w.tenants:
                parts = [self.trace(WorkloadSpec(t, w.scale, w.cap)) for t in w.tenants]
                self._traces[w.key] = T.concurrent(parts, seed=w.seed, slice_len=w.slice_len)
            else:
                tr = zoo.get_trace(w.benchmark, scale=w.scale)
                self._traces[w.key] = tr.slice(0, min(len(tr), w.cap))
        return self._traces[w.key]

    def ipc(self, w: WorkloadSpec | str, stats: dict, **kw) -> float:
        return timing.ipc(stats, len(self.trace(w)), **kw)

    # -- cache plumbing ------------------------------------------------------

    def _lookup(self, spec, from_payload):
        """Memory first, then the persistent store (reconstructing the
        result object); None on a full miss."""
        key = spec.key
        if key in self._results:
            self.counters["memory_hits"] += 1
            return self._results[key]
        payload = self.store.get(spec)
        if payload is not None:
            res = from_payload(payload)
            self._results[key] = res
            self.counters["store_hits"] += 1
            return res
        return None

    def _record(self, spec, result, to_payload, *, persist: bool = True):
        self._results[spec.key] = result
        self.counters["computed"] += 1
        if persist:
            self.store.put(spec, to_payload(result))
        return result

    # -- spec execution ------------------------------------------------------

    def run(self, cell: CellSpec):
        """Execute (or look up) one cell; returns its stats dict
        (sim/uvmsmart) or :class:`LearnedRunResult` (ours)."""
        return self.sweep([cell])[0]

    def sweep(self, cells) -> list:
        """Execute a list of cells (or an :class:`ExperimentSpec`), serving
        repeats from the store and grouping the misses by engine.  Results
        align with the input order."""
        if isinstance(cells, ExperimentSpec):
            cells = cells.cells()
        cells = list(cells)
        results: dict[int, object] = {}
        missing: list[tuple[int, CellSpec]] = []
        for i, cell in enumerate(cells):
            hit = self._lookup(cell, self._payload_decoder(cell))
            if hit is not None:
                results[i] = hit
            else:
                missing.append((i, cell))

        sim_by_workload: dict[str, list[tuple[int, CellSpec]]] = {}
        ours_by_model: dict[str, list[tuple[int, CellSpec]]] = {}
        smart: list[tuple[int, CellSpec]] = []
        for i, cell in missing:
            if cell.strategy == "sim":
                sim_by_workload.setdefault(cell.workload.key, []).append((i, cell))
            elif cell.strategy == "ours":
                ours_by_model.setdefault(f"{cell.model.key}|{cell.oversubscription}|{cell.seed}", []).append((i, cell))
            else:
                smart.append((i, cell))

        for group in sim_by_workload.values():
            results.update(self._run_sim_group(group))
        for group in ours_by_model.values():
            results.update(self._run_ours_group(group))
        results.update(self._run_uvmsmart_group(smart))
        return [results[i] for i in range(len(cells))]

    def _payload_decoder(self, cell: CellSpec):
        if cell.strategy != "ours":
            return lambda p: p

        def decode(payload: dict) -> LearnedRunResult:
            res = _payload_to_learned(payload)
            if not res.n_accesses:  # record stored before the field existed
                res.n_accesses = len(self.trace(cell.workload))
            return res

        return decode

    def _run_sim_group(self, group) -> dict[int, dict]:
        """All sim cells of one workload in one ``run_batch`` call."""
        _, first = group[0]
        tr = self.trace(first.workload)
        tuples = [(c.policy.name, c.prefetch.name, c.oversubscription) for _, c in group]
        stats = S.run_batch(tr, tuples, seeds=[c.seed for _, c in group], device=self.device)
        return {i: self._record(cell, st, lambda p: p, persist=self._persistable(cell))
                for (i, cell), st in zip(group, stats)}

    @staticmethod
    def _persistable(cell: CellSpec) -> bool:
        """Whether a cell's result may enter the PERSISTENT store.

        Two exemptions (memoised in-process only):
        * ``random`` — the reference's counters depend on lane padding
          (its documented contract), so no stored result is shared;
        * plugin strategies — a spec hashes a registered policy/prefetcher/
          predictor by NAME only, so a changed implementation under the same
          name would silently be served the old result across processes.
        """
        if cell.strategy == "uvmsmart":
            return True
        if cell.strategy == "ours":
            return cell.model.kind in _BUILTIN_PREDICTORS
        return (
            cell.policy.name != "random"
            and cell.policy.name in S.POLICIES
            and cell.prefetch.name in S.PREFETCHERS
        )

    def _run_ours_group(self, group) -> dict[int, LearnedRunResult]:
        """Learned cells sharing one ModelSpec, oversubscription and seed:
        one ``run_ours`` after another, each from a clone of the group's
        pretrained table (built or loaded once)."""
        _, first = group[0]
        model, oversub = first.model, first.oversubscription
        kw = dict(
            kind=model.kind,
            use_thrash_term=model.use_thrash_term,
            use_lucir=model.use_lucir,
            seed=first.seed,  # cells group by (model, oversub, seed)
            # tenancy only matters on tenant-tagged (concurrent) workloads:
            # 'merged' forces the single-manager baseline, otherwise the
            # runtime routes tagged traces through the TenantMux
            multi_tenant=False if model.tenancy == "merged" else None,
            shared_freq_table=model.tenancy == "mux-shared",
            reclass_interval=model.reclass_interval,
            reclass_hysteresis=model.reclass_hysteresis,
            health=model.health_config(),
            qos=model.qos,
            device=self.device,
        )
        tcfg = model.train.to_train_config()
        out = {}
        for i, cell in group:
            # the table is pretrained with the CELL's model configs (which may
            # differ from this session's defaults)
            table = (self.pretrained(model.pretrain, pcfg=model.predictor, train=model.train, kind=model.kind)
                     if model.pretrain is not None else None)
            res = R.run_ours(self.trace(cell.workload), model.predictor, tcfg,
                             oversubscription=oversub, table=table, **kw)
            out[i] = self._record(cell, res, _learned_to_payload, persist=self._persistable(cell))
        return out

    def _run_uvmsmart_group(self, group) -> dict[int, dict]:
        return {
            i: self._record(cell, run_uvmsmart(self.trace(cell.workload), oversubscription=cell.oversubscription,
                                               seed=cell.seed, device=self.device), lambda p: p)
            for i, cell in group
        }

    # -- named conveniences --------------------------------------------------

    def _sim_cell(self, w, policy: str, prefetch: str, oversub: float) -> CellSpec:
        return CellSpec(self._workload(w), "sim", PolicySpec(policy), PrefetchSpec(prefetch), oversub)

    def sims(self, w, cells: list) -> list[dict]:
        """(policy, prefetch, oversub) tuples over one workload in one sweep
        (bit-identical to per-cell ``run`` for non-random policies)."""
        return self.sweep([self._sim_cell(w, p, f, os_) for p, f, os_ in cells])

    def sim(self, w, policy: str, prefetch: str, oversub: float = 1.25) -> dict:
        """One rule-based cell; a miss computes the whole STANDARD_CELLS row
        for (workload, oversub), as the row-oriented tables consume it."""
        cell = self._sim_cell(w, policy, prefetch, oversub)
        hit = self._lookup(cell, self._payload_decoder(cell))
        if hit is not None:
            return hit
        todo = [(p, f, oversub) for p, f in self.STANDARD_CELLS]
        if (policy, prefetch, oversub) not in todo:
            todo.append((policy, prefetch, oversub))
        row = self.sims(w, todo)
        return row[todo.index((policy, prefetch, oversub))]

    def _ours_model(self, **kw) -> ModelSpec:
        unknown = set(kw) - {"kind", "use_thrash_term", "use_lucir",
                             "tenancy", "reclass_interval", "reclass_hysteresis",
                             "health", "latency_budget_ms", "qos"}
        if unknown:
            raise TypeError(f"unknown learned-run options: {sorted(unknown)}")
        return dataclasses.replace(self.model, pretrain=self.default_pretrain, **kw)

    def ours_cell(self, w, oversub: float = 1.25, seed: int = 0, **kw) -> CellSpec:
        return CellSpec(
            self._workload(w), "ours", PolicySpec("learned"), PrefetchSpec("none"),
            oversub, self._ours_model(**kw), seed,
        )

    def ours(self, w, oversub: float = 1.25, seed: int = 0, **kw) -> LearnedRunResult:
        """The paper's full learned runtime on one workload (Section IV),
        from this session's Section V-A table.  ``seed`` seeds the simulator
        state (like sim cells); model/training seeds live in the ModelSpec's
        TrainSpec.  :meth:`manager` hands you the streaming manager an
        ``ours`` cell drives."""
        return self.run(self.ours_cell(w, oversub, seed, **kw))

    def manager(self, w, oversub: float = 1.25, *, pretrained: bool = False, **kw):
        """A streaming :class:`~repro_torch.uvm.manager.OversubscriptionManager`
        configured for workload ``w`` at this session's model/scale — the
        object an ``ours`` cell drives.  ``pretrained=True`` starts it from
        this session's Section V-A table (a fresh clone).

        A tenant list (``manager(["ATAX", "BICG"])``) or a concurrent
        :class:`WorkloadSpec` returns the multi-tenant
        :class:`~repro_torch.uvm.manager.TenantMux` instead (one pipeline per
        tenant; ``tenancy='mux-shared'`` shares the frequency table,
        ``tenancy='merged'`` falls back to one merged-stream manager)."""
        if isinstance(w, (list, tuple)):
            w = self.concurrent(tuple(w))
        model = self._ours_model(**kw)
        table = (
            self.pretrained(model.pretrain, pcfg=model.predictor, train=model.train, kind=model.kind)
            if pretrained else None
        )
        common = dict(
            oversubscription=oversub, kind=model.kind, table=table,
            use_thrash_term=model.use_thrash_term, use_lucir=model.use_lucir,
            reclass_interval=model.reclass_interval,
            reclass_hysteresis=model.reclass_hysteresis,
            health=model.health_config(), device=self.device,
        )
        tr = self.trace(w)
        if tr.tenant is not None and model.tenancy != "merged":
            return R.mux_for(
                tr, model.predictor, model.train.to_train_config(),
                shared_freq_table=model.tenancy == "mux-shared",
                qos=model.qos, **common,
            )
        return R.manager_for(tr, model.predictor, model.train.to_train_config(), **common)

    def ours_many(self, names: list, oversub: float = 1.25, **kw) -> list[LearnedRunResult]:
        """The learned runs of many benchmarks in one grouped sweep."""
        return self.sweep([self.ours_cell(n, oversub, **kw) for n in names])

    def _uvmsmart_cell(self, w, oversub: float) -> CellSpec:
        return CellSpec(self._workload(w), "uvmsmart", PolicySpec("adaptive"), PrefetchSpec("adaptive"), oversub)

    def uvmsmart(self, w, oversub: float = 1.25) -> dict:
        return self.run(self._uvmsmart_cell(w, oversub))

    def uvmsmart_many(self, names: list, oversub: float = 1.25) -> list[dict]:
        return self.sweep([self._uvmsmart_cell(n, oversub) for n in names])

    # -- pretraining + protocols --------------------------------------------

    def pretrained(self, pspec: PretrainSpec | None = None, *,
                   pcfg=None, train: TrainSpec | None = None, kind: str = "transformer"):
        """Section V-A pretrained per-pattern table for ``pspec`` (default:
        this session's recipe); built or loaded once per (recipe, predictor,
        training, kind) by :func:`pretrained_table` and CLONED per use
        (fine-tuning changes the entries).  ``pcfg``/``train``/``kind``
        default to this session's model, but a cell carries its own
        :class:`ModelSpec`: the table must be pretrained with the configs
        and architecture that fine-tune it."""
        pspec = pspec or self.default_pretrain
        pcfg = pcfg if pcfg is not None else self.pcfg
        train = train if train is not None else self.model.train
        memo_key = (pspec.key, pcfg, train, kind)
        if memo_key not in self._pretrained:
            self._pretrained[memo_key] = pretrained_table(pspec, pcfg, train.to_train_config(), kind,
                                                          device=self.device)
        return self._pretrained[memo_key].clone()

    def protocol(self, w, mode: str, kind: str = "transformer",
                 pretrain: PretrainSpec | None = None) -> RunResult:
        """One prediction-accuracy protocol run (strictly-causal top-1).
        ``pretrain`` (with ``mode='ours'``) starts from a fresh clone of
        that recipe's table — the paper's pretrain-then-finetune protocol;
        without it every slot starts from the JAX package's initial weights
        (:mod:`repro_torch.random`)."""
        return self.protocol_chain([w], mode, kind=kind, pretrain=pretrain)[0]

    def protocol_chain(self, workloads: list, mode: str, *, kind: str = "transformer",
                       pretrain: PretrainSpec | None = None) -> list[RunResult]:
        """Protocol runs that SHARE one pretrained table, fine-tuned link by
        link (fig11's shape): link i's result depends on links < i, so each
        link's spec carries the chain prefix in ``prior`` and the chain is
        served from the store only when every link hits."""
        model = dataclasses.replace(self.model, kind=kind, pretrain=pretrain)
        specs, prior = [], ()
        for w in workloads:
            w = self._workload(w)
            specs.append(ProtocolSpec(w, mode, model, prior))
            if pretrain is not None:
                prior = prior + (w.key,)
        hits = [self._lookup(s, _payload_to_protocol) for s in specs]
        if all(h is not None for h in hits):
            return hits
        table = (
            self.pretrained(pretrain, pcfg=model.predictor, train=model.train, kind=kind)
            if pretrain is not None else None
        )
        tcfg = model.train.to_train_config()
        out = []
        for spec in specs:
            res = run_protocol(
                self.trace(spec.workload), model.predictor, tcfg,
                mode=mode, kind=kind, table=table, device=self.device,
            )
            out.append(self._record(
                spec, res, _protocol_to_payload,
                persist=spec.model.kind in _BUILTIN_PREDICTORS,
            ))
        return out
