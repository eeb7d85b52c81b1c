"""The paper's Tables I-IV and VI-VIII and the reference's Tables IX
(drift) and X (QoS fairness) on the port (counterpart of
``benchmarks/tables.py``'s ``table1``-``table4`` and ``table6``-``table10``),
and the :class:`Context` that the figures (``repro_torch.bench.figures``)
share.

    PYTHONPATH=src python -m repro_torch.bench.tables --only table6 [--scale paper] \\
        [--frozen] [--table PATH] [--fresh PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.tables --only table7 table8 --scale paper
    PYTHONPATH=src python -m repro_torch.bench.tables --only table9 table10 --scale quick

Every cell runs on the card unless ``--device cpu`` is given.  Each table
prints the reference's contract line (``name,us_per_call,derived``) and
then one JSON object per row; Table VI's first row is the average
reduction of ``ours`` against the baseline (``lru`` + ``tree``), Table
VIII's the average top-1 gain of the per-tenant ``TenantMux`` over one
merged manager (it raises, with the per-pair breakdown, when that is below
0).  Tables VII and VIII run the Section V-F pairs (``CONCURRENT_PAIRS``),
each a :func:`repro_torch.uvm.trace.concurrent` merge in slices of one
training group.  Tables IX and X pin their own geometry to the quick
preset whatever ``--scale`` says, as the reference does, and write no
file (the reference's record their rows into ``BENCH_sim.json``).

A :class:`Context` takes the place of the reference's ``Session`` (the
port's :class:`~repro_torch.uvm.api.session.Session` is the reference's,
and lends this module its constants): the same benchmarks
(``ALL_BENCH``), presets (``SCALE_PRESETS``) and rule-based cells
(``STANDARD_CELLS``), each trace cut to its first ``cap`` accesses (a
benchmark, a zoo pattern, or a :class:`Drift` workload of
:mod:`repro_torch.uvm.zoo`), and an in-process memo of traces and cells; it
keeps no disk store.  ``ours`` is the paper's learned runtime, ``run_ours``
at the preset's predictor and schedule (``--frozen``: no fine-tuning), from
a pretrained table: at the ``paper`` preset the one
``scripts/export_torch_reference.py`` exports from ``Session.paper()``
(``experiments/torch/pretrain_paper.npz``: every slot's params and AdamW
moments, so fine-tuning starts from the same optimizer state as the
reference's runner); at the ``quick`` preset the JAX package's own memo of
``Session().pretrained()`` in ``experiments/cache/``
(``pretrain_0e86a9ef3a27bb0d.pkl``, read by :func:`repro_torch.uvm.
runtime.pretrain_table`'s ``memo_dir``).  Table VII's ``ours`` starts from
its own Section V-A table (``PretrainSpec(scale=0.6, seed0=321)``:
``experiments/torch/pretrain_paper_s321.npz``), its ``online_single`` from
fresh weights; Fig. 11's chain from ``seed0=123``'s
(``experiments/torch/pretrain_paper_s123.npz``); neither has a quick copy.

A slot that a table lacks, and the ``offline`` protocol's one model, start
from the JAX package's initial weights as :mod:`repro_torch.random` draws
them (a few float32 normals in a hundred thousand one ulp apart); ``--fresh
experiments/torch/init_paper_slots.npz`` hands over the JAX package's own
(exported) weights of the slots its runs of Tables VII and VIII and of the
figures create.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.predictor_paper import CONFIG, CONFIG_QUICK
from repro_torch.core.features import unique_deltas_per_phase
from repro_torch.core.incremental import RunResult, TrainConfig, run_protocol
from repro_torch.core.model_table import ModelTable
from repro_torch.core.pattern import PatternClassifier
from repro_torch.core.predictor import param_count
from repro_torch.device import resolve_device
from repro_torch.uvm import runtime as R
from repro_torch.uvm import simulator as S
from repro_torch.uvm import timing
from repro_torch.uvm import trace as T
from repro_torch.uvm import zoo as Z
from repro_torch.uvm.api.session import ALL_BENCH, FEATURED, MEMO_DIR, PAPER_TABLES, Session, pretrained_table
from repro_torch.uvm.api.specs import PRETRAIN_BENCHES, SCALE_PRESETS, TENANCIES, PretrainSpec, QosSpec, QosTierSpec
from repro_torch.uvm.uvmsmart import run_uvmsmart

#: every rule-based cell the tables read
STANDARD_CELLS = Session.STANDARD_CELLS
EXPERIMENTS = MEMO_DIR.parent / "torch"
PAPER_TABLE = PAPER_TABLES[777]
#: Table VII's ``ours`` table: the paper preset's recipe with ``seed0=321``
PAPER_TABLE_S321 = PAPER_TABLES[321]
#: Fig. 11's chain table: the paper preset's recipe with ``seed0=123``
PAPER_TABLE_S123 = PAPER_TABLES[123]
#: the JAX package's initial weights of the fresh slots of Tables VII and
#: VIII and of the figures
PAPER_FRESH = EXPERIMENTS / "init_paper_slots.npz"
TABLES = ("table1", "table2", "table3", "table4", "table6", "table7", "table8", "table9", "table10")
#: the Section V-F pairs of Tables VII and VIII
CONCURRENT_PAIRS = (("StreamTriad", "2DCONV"), ("Hotspot", "Srad-v2"), ("NW", "2DCONV"), ("ATAX", "Srad-v2"))


@dataclasses.dataclass(frozen=True)
class Drift:
    """A phase-changing zoo workload (the reference's
    ``WorkloadSpec.drifting`` of kind ``phase``): ``phases`` spliced by
    :func:`repro_torch.uvm.zoo.phase_trace`, cut to ``cap`` accesses."""

    phases: tuple
    scale: float = 0.4
    cap: int = 6000
    segment: int = 1500
    switch: str = "abrupt"
    mix_window: int = 0
    seed: int = 0

    def build(self) -> T.Trace:
        tr = Z.phase_trace(self.phases, scale=self.scale, seed=self.seed, segment=self.segment, switch=self.switch,
                           mix_window=self.mix_window)
        return tr.slice(0, min(len(tr), self.cap))


def pretrain_corpus(scale: float) -> list[T.Trace]:
    """The reference's Section V-A corpus: benchmark ``i`` of
    ``PRETRAIN_BENCHES`` at ``scale`` with input seed ``777 + i``
    (``PretrainSpec``'s defaults)."""
    return [T.BENCHMARKS[n](scale=scale, seed=777 + i) for i, n in enumerate(PRETRAIN_BENCHES)]


class Context:
    """The cells of one preset on one device, memoised in process.

    ``table`` is the pretrained model table ``ours`` starts from (a
    :class:`ModelTable` or the path of a memo pickle or ``.npz``); it
    defaults to the preset's Section V-A recipe (:meth:`pretrain`:
    ``PAPER_TABLE`` at the ``paper`` preset, the JAX package's memo in
    ``memo_dir`` at ``quick``).  ``table7`` is Table VII's
    (``PAPER_TABLE_S321`` at ``paper``), ``fig11`` Fig. 11's
    (``PAPER_TABLE_S123``); at ``quick`` both raise without an argument.
    ``fresh`` (a mapping slot -> params, or an ``.npz`` of them) gives the
    initial weights of slots a table lacks, of ``protocol``'s fresh tables
    and of the ``offline`` protocol's model (slot ``tcfg.seed``); ``None``
    draws the JAX package's through :mod:`repro_torch.random`.  ``pcfg``
    (the predictor) and ``tcfg`` (the schedule) are the preset's."""

    def __init__(self, preset: str = "paper", *, benches: list | None = None, frozen: bool = False,
                 table: ModelTable | str | Path | None = None, table7: ModelTable | str | Path | None = None,
                 fig11: ModelTable | str | Path | None = None, fresh: dict | str | Path | None = None,
                 memo_dir: str | Path | None = MEMO_DIR, device: str | torch.device = "cuda"):
        self.preset = preset
        self.scale, self.cap = SCALE_PRESETS[preset]
        self.benches = list(benches) if benches is not None else list(ALL_BENCH)
        self.device = resolve_device(device)
        paper = preset == "paper"
        self.pcfg = CONFIG if paper else CONFIG_QUICK
        # the reference's PAPER_TRAIN and its default TrainSpec
        self.train = TrainConfig(2048, 3, 256) if paper else TrainConfig(1024, 2, 128)
        self.tcfg = dataclasses.replace(self.train, epochs=0) if frozen else self.train
        self.memo_dir = memo_dir
        self._tables = {"ours": table, "table7": table7, "fig11": fig11}
        self.fresh = convert.fresh_slots(fresh) if isinstance(fresh, (str, Path)) else fresh
        self._masters: dict = {}
        self._recipes: dict = {}
        self._traces: dict = {}
        self._merges: dict = {}
        self._sims: dict = {}
        self._smart: dict = {}
        self._ours: dict = {}
        self._protocols: dict = {}

    def with_train(self, tcfg: TrainConfig, benches: list | None = None) -> "Context":
        """This context with another schedule for ``ours`` (and optionally
        other benchmarks); traces and rule-based cells stay shared."""
        other = copy.copy(self)
        other.tcfg = tcfg
        other.benches = list(benches) if benches is not None else list(self.benches)
        other._ours = {}
        other._protocols = {}
        return other

    def drifting(self, phases, **kw) -> Drift:
        """A drifting zoo workload of this preset's scale and cap (the
        reference's ``Session.drifting``)."""
        kw.setdefault("scale", self.scale)
        kw.setdefault("cap", self.cap)
        return Drift(tuple(phases), **kw)

    def trace(self, w: str | Drift) -> T.Trace:
        """A benchmark or zoo pattern by name (cut to ``cap``), or a
        :class:`Drift` workload."""
        if w not in self._traces:
            if isinstance(w, Drift):
                self._traces[w] = w.build()
            else:
                tr = Z.get_trace(w, self.scale)
                self._traces[w] = tr.slice(0, min(len(tr), self.cap))
        return self._traces[w]

    def sim(self, w: str | Drift, policy: str, prefetch: str, oversub: float = 1.25) -> dict:
        """One rule-based cell (the port's ``run_batch`` runs cells one
        after another, so a miss runs only this one)."""
        key = (w, policy, prefetch, oversub)
        if key not in self._sims:
            self._sims[key] = S.run_batch(self.trace(w), [(policy, prefetch, oversub)], device=self.device)[0]
        return self._sims[key]

    def ipc(self, w: str | T.Trace, stats: dict, **kw) -> float:
        """The IPC proxy of a cell's stats over its trace's length (the
        reference's ``Session.ipc``)."""
        return timing.ipc(stats, len(self.trace(w) if isinstance(w, str) else w), **kw)

    def sims(self, name: str, oversub: float = 1.25) -> dict:
        """The ``STANDARD_CELLS`` row of one benchmark, by ``policy+prefetch``."""
        return {f"{p}+{f}": self.sim(name, p, f, oversub) for p, f in STANDARD_CELLS}

    def uvmsmart(self, name: str, oversub: float = 1.25) -> dict:
        if (name, oversub) not in self._smart:
            self._smart[(name, oversub)] = run_uvmsmart(self.trace(name), oversubscription=oversub,
                                                        device=self.device)
        return self._smart[(name, oversub)]

    def concurrent(self, tenants, *, slice_len: int = 256, seed: int = 0) -> T.Trace:
        """A Section V-F merge of the tenants' traces (each cut to ``cap``,
        as the reference's ``Session.trace`` cuts the parts; the merge itself
        is not cut)."""
        key = (tuple(tenants), slice_len, seed)
        if key not in self._merges:
            self._merges[key] = T.concurrent([self.trace(t) for t in tenants], seed=seed, slice_len=slice_len)
        return self._merges[key]

    def pretrain(self, pcfg=None, train: TrainConfig | None = None, *, scale: float | None = None,
                 seed0: int = 777) -> ModelTable:
        """A fresh copy of the Section V-A table of a recipe (the reference's
        ``Session.pretrained(PretrainSpec(scale, seed0=seed0), pcfg=,
        train=)``, two rounds; defaults: this preset's predictor and
        schedule, ``0.6 * scale``), as
        :func:`~repro_torch.uvm.api.session.pretrained_table` finds it."""
        pcfg = pcfg if pcfg is not None else self.pcfg
        train = train if train is not None else self.train
        scale = self.scale * 0.6 if scale is None else scale
        key = (pcfg, dataclasses.astuple(train), scale, seed0)
        if key not in self._recipes:
            self._recipes[key] = pretrained_table(PretrainSpec(scale=scale, seed0=seed0), pcfg, train,
                                                  memo_dir=self.memo_dir, fresh=self.fresh, device=self.device)
        return self._recipes[key].clone()

    def pretrained(self, which: str = "ours") -> ModelTable:
        """A fresh copy of a pretrained table (fine-tuning changes it):
        ``ours``'s, ``"table7"``'s or ``"fig11"``'s, the one passed for it or
        else its recipe's (:meth:`pretrain` with ``seed0`` 777, 321 or 123)."""
        src = self._tables[which]
        if src is None:
            if which != "ours" and self.preset != "paper":
                name, seed0 = {"table7": ("Table VII", 321), "fig11": ("Fig. 11", 123)}[which]
                raise NotImplementedError(
                    f"the {self.preset!r} preset's {name} table (the reference's Section V-A pretrain with "
                    f"seed0={seed0}) has no committed copy (ROADMAP A1); pass {which}=")
            return self.pretrain(seed0={"ours": 777, "table7": 321, "fig11": 123}[which])
        if which not in self._masters:
            self._masters[which] = (src if isinstance(src, ModelTable)
                                    else R.load_pretrained(src, self.pcfg, self.device, fresh=self.fresh))
        return self._masters[which].clone()

    def ours(self, w: str | T.Trace, oversub: float = 1.25, tenancy: str = "mux",
             use_thrash_term: bool = True) -> R.LearnedRunResult:
        """The paper's learned runtime on a benchmark or a merge (Section
        IV); ``tenancy`` picks a merge's treatment (``TENANCIES``),
        ``use_thrash_term=False`` drops Eq. 3's thrashing term (Fig. 12)."""
        if tenancy not in TENANCIES:
            raise ValueError(f"unknown tenancy {tenancy!r}; one of {TENANCIES}")
        tr = self.trace(w) if isinstance(w, (str, Drift)) else w
        key = (tr.name, len(tr), oversub, tenancy, use_thrash_term)
        if key not in self._ours:
            self._ours[key] = R.run_ours(tr, self.pcfg, self.tcfg, oversubscription=oversub, table=self.pretrained(),
                                         use_thrash_term=use_thrash_term,
                                         multi_tenant=False if tenancy == "merged" else None,
                                         shared_freq_table=tenancy == "mux-shared", device=self.device)
        return self._ours[key]

    def protocol(self, w: str | T.Trace, mode: str, table: ModelTable | None = None,
                 kind: str = "transformer") -> RunResult:
        """One prediction-accuracy protocol run (strictly causal top-1) at
        the context's predictor and schedule, for a registered predictor
        ``kind``, from ``table`` (used as given, and changed by the run) or
        from fresh weights; a run from fresh weights is memoised.
        ``fresh`` applies to the transformer only."""
        tr = self.trace(w) if isinstance(w, (str, Drift)) else w
        if table is not None:
            return run_protocol(tr, self.pcfg, self.tcfg, mode=mode, kind=kind, table=table, device=self.device)
        key = (tr.name, len(tr), mode, kind)
        if key not in self._protocols:
            seed = self.tcfg.seed
            fresh = self.fresh if kind == "transformer" else None
            init = (convert.params_from_jax(fresh[seed], self.device)
                    if mode == "offline" and fresh and seed in fresh else None)
            self._protocols[key] = run_protocol(
                tr, self.pcfg, self.tcfg, mode=mode, kind=kind, init_params=init, device=self.device,
                table=convert.fresh_table(self.pcfg, self.device, self.tcfg.table_slots, fresh) if fresh else None)
        return self._protocols[key]

    def protocol_chain(self, workloads: list, mode: str, table: ModelTable | None = None) -> list[RunResult]:
        """Protocol runs that share one table, fine-tuned link by link
        (Fig. 11's shape: link i starts from the table links < i left
        behind); without ``table`` each link starts from fresh weights, as
        the reference's ``Session.protocol_chain`` does without a
        pretraining recipe."""
        return [self.protocol(w, mode, table=table) for w in workloads]


def emit(name: str, rows: list[dict], t0: float) -> None:
    """Print the reference's ``name,us_per_call,derived`` line, then one
    JSON object per row."""
    us = (time.time() - t0) * 1e6 / max(len(rows), 1)
    derived = rows[0].get("derived", "") if rows else ""
    print(f"{name},{us:.0f},{derived}")
    for r in rows:
        print(json.dumps(r))


def table1(ctx: Context) -> list[dict]:
    """Baseline / D.+HPE / UVMSmart / D.+Belady pages thrashed @125%."""
    t0 = time.time()
    rows = []
    for b in ctx.benches:
        rows.append({
            "benchmark": b,
            "baseline": ctx.sim(b, "lru", "tree")["pages_thrashed"],
            "d_hpe": ctx.sim(b, "hpe", "demand")["pages_thrashed"],
            "uvmsmart": ctx.uvmsmart(b)["pages_thrashed"],
            "d_belady": ctx.sim(b, "belady", "demand")["pages_thrashed"],
        })
    emit("table1_thrashing", rows, t0)
    # the paper's structural claims
    for r in rows:
        assert r["d_belady"] <= r["d_hpe"] + 1e-9, r
    return rows


def table2(ctx: Context) -> list[dict]:
    """Demand.+HPE vs Tree.+HPE (the interplay collapse)."""
    t0 = time.time()
    rows = []
    for b in ctx.benches:
        d = ctx.sim(b, "hpe", "demand")["pages_thrashed"]
        t = ctx.sim(b, "hpe", "tree")["pages_thrashed"]
        rows.append({"benchmark": b, "demand_hpe": d, "tree_hpe": t, "derived": f"collapse_x{t / max(d, 1):.0f}"})
    emit("table2_hpe_prefetch", rows, t0)
    return rows


def table3(ctx: Context) -> list[dict]:
    """Unique page deltas per program phase (the growing-class problem that
    motivates incremental learning; paper Table III)."""
    t0 = time.time()
    rows = []
    for b in ctx.benches:
        p = unique_deltas_per_phase(ctx.trace(b), 3)
        rows.append({
            "benchmark": b, "phase0": p[0], "phase1": p[1], "phase2": p[2],
            "derived": f"growth_x{p[2] / max(p[0], 1):.1f}",
        })
    emit("table3_delta_growth", rows, t0)
    # NW / Srad must grow; streaming must stay flat (paper's central premise)
    by = {r["benchmark"]: r for r in rows}
    assert by["NW"]["phase2"] > by["NW"]["phase0"]
    assert by["StreamTriad"]["phase2"] <= by["StreamTriad"]["phase0"] + 2
    return rows


def table4(ctx: Context) -> list[dict]:
    """Predictor memory footprint with the paper's accounting (Eq. 4):
    Total = (Params*2 + Activations) * Patterns, 4-bit-ish quantised."""
    t0 = time.time()
    rows = []
    params_mb = param_count(ctx.pcfg) * 4 / 2**20  # fp32
    acti_mb = 1.46  # measured activation budget from the paper's Table IV
    G = ctx.tcfg.group_size
    for b in ctx.benches:
        tr = ctx.trace(b)
        c = PatternClassifier()
        pats = {c.classify(tr.block[lo : lo + G], tr.kernel[lo : lo + G]) for lo in range(0, len(tr), G)}
        total = (params_mb * 2 + acti_mb) * len(pats)
        rows.append({
            "benchmark": b, "params_mb": round(params_mb, 2), "acti_mb": acti_mb,
            "patterns": len(pats), "total_mb": round(total, 2),
        })
    emit("table4_footprint", rows, t0)
    return rows


def table6(ctx: Context) -> list[dict]:
    """Full strategy matrix incl. our solution (the headline table)."""
    t0 = time.time()
    rows = []
    reductions = []
    for b in ctx.benches:
        base = ctx.sim(b, "lru", "tree")["pages_thrashed"]
        ours = ctx.ours(b).stats["pages_thrashed"]
        rows.append({
            "benchmark": b,
            "baseline": base,
            "tree_hpe": ctx.sim(b, "hpe", "tree")["pages_thrashed"],
            "uvmsmart": ctx.uvmsmart(b)["pages_thrashed"],
            "ours": ours,
            "demand_hpe": ctx.sim(b, "hpe", "demand")["pages_thrashed"],
            "demand_belady": ctx.sim(b, "belady", "demand")["pages_thrashed"],
        })
        if base > 0:
            reductions.append(1 - ours / base)
    avg_red = float(np.mean(reductions)) if reductions else 0.0
    rows.insert(0, {"benchmark": "AVG_REDUCTION_VS_BASELINE", "baseline": "", "tree_hpe": "",
                    "uvmsmart": "", "ours": round(avg_red, 3), "demand_hpe": "", "demand_belady": ""})
    emit("table6_thrashing_full", rows, t0)
    return rows


def table7(ctx: Context) -> list[dict]:
    """Concurrent multi-workload page-delta prediction (scalability).
    'Ours' follows the paper's Section V-A protocol: per-pattern models
    pretrained on a (different-input) corpus, then fine-tuned online."""
    t0 = time.time()
    rows = []
    for a, b in CONCURRENT_PAIRS:
        # slices aligned with the training group: each group sees one
        # tenant's coherent stream, which is what the DFA classifies
        w = ctx.concurrent((a, b), slice_len=ctx.tcfg.group_size)
        online = ctx.protocol(w, "online_single")
        ours = ctx.protocol(w, "ours", table=ctx.pretrained("table7"))
        rows.append({
            "workloads": f"{a}+{b}", "online_top1": round(online.top1, 3),
            "ours_top1": round(ours.top1, 3), "derived": f"delta={ours.top1 - online.top1:+.3f}",
        })
    emit("table7_multiworkload", rows, t0)
    return rows


def table8(ctx: Context) -> list[dict]:
    """Section V-F concurrent top-1 through the full runtime (simulator in
    the loop): the multi-tenant ``TenantMux`` (one classifier->predictor
    pipeline per tenant, isolated frequency tables) against one manager
    over the merged stream.  The paper reports +10.2% top-1 on average (up
    to +30.2%) for per-workload specialisation."""
    t0 = time.time()
    rows, deltas = [], []
    for a, b in CONCURRENT_PAIRS:
        w = ctx.concurrent((a, b), slice_len=ctx.tcfg.group_size)
        mux = ctx.ours(w)
        merged = ctx.ours(w, tenancy="merged")
        per = {k: round(v, 3) for k, v in sorted((mux.per_tenant_top1 or {}).items())}
        rows.append({
            "workloads": f"{a}+{b}",
            "merged_top1": round(merged.top1, 3),
            "mux_top1": round(mux.top1, 3),
            "tenant0_top1": per.get("0", ""),
            "tenant1_top1": per.get("1", ""),
            "derived": f"delta={mux.top1 - merged.top1:+.3f}",
        })
        deltas.append(mux.top1 - merged.top1)
    avg = float(np.mean(deltas)) if deltas else 0.0
    rows.insert(0, {
        "workloads": "AVG_MUX_GAIN", "merged_top1": "", "mux_top1": "",
        "tenant0_top1": "", "tenant1_top1": "", "derived": f"delta={avg:+.3f}",
    })
    emit("table8_concurrent_mux", rows, t0)
    # the reference's pin: per-tenant specialisation must not lose to the
    # merged baseline on average; say which pair moved it
    if avg < 0:
        print(f"table8: AVG_MUX_GAIN {avg:+.3f} < 0 — per-pair breakdown:")
        for r in rows[1:]:
            print(f"  {r['workloads']:<24} merged={r['merged_top1']} mux={r['mux_top1']} {r['derived']}")
        raise AssertionError(f"avg mux gain {avg:+.3f} < 0 (see breakdown above)")
    return rows


def table9(ctx: Context) -> list[dict]:
    """Drift: streaming re-classification on the zoo's phase-changing traces
    (the reference's subsystem result beyond the paper's tables).  Each
    trace alternates a learnable streaming phase (StreamTriad) with the
    zoo's RandomScan noise; a frozen-pattern manager (``reclass_interval``
    so large the seed window never expires) trains the noise into the
    streaming model, re-classifying managers (256 and 512 faults,
    hysteresis 2) quarantine it.  ``hpe`` + ``tree`` is the no-learning
    floor.  Geometry pinned to quick (scale 0.4, ``CONFIG_QUICK``, group
    256) whatever the context's preset, from the reference's
    ``PretrainSpec(scale=0.24)`` table at that schedule; no file is
    written."""
    t0 = time.time()
    frozen = 1 << 30  # the seed window never expires: the frozen-pattern manager
    tcfg = TrainConfig(256, 2, 128)

    def learned(tr, oversub, **kw):
        mgr = R.manager_for(tr, CONFIG_QUICK, tcfg, oversubscription=oversub,
                            table=ctx.pretrain(CONFIG_QUICK, tcfg, scale=0.24), device=ctx.device, **kw)
        res = R.run_ours(tr, CONFIG_QUICK, tcfg, oversubscription=oversub, manager=mgr)
        return res, mgr.n_pattern_switches

    rows, d_top1, d_thrash = [], [], []
    for w, oversub in TABLE9_SUITE:
        tr = ctx.trace(w)
        froz, _ = learned(tr, oversub, reclass_interval=frozen)
        r256, switches = learned(tr, oversub, reclass_interval=256, reclass_hysteresis=2)
        r512, _ = learned(tr, oversub, reclass_interval=512, reclass_hysteresis=2)
        rule = ctx.sim(w, "hpe", "tree", oversub)
        rows.append({
            "trace": tr.name.replace("drift:", ""), "oversub": oversub,
            "frozen_top1": round(froz.top1, 3), "frozen_thrash": froz.stats["pages_thrashed"],
            "reclass256_top1": round(r256.top1, 3), "reclass256_thrash": r256.stats["pages_thrashed"],
            "switches": switches,
            "reclass512_top1": round(r512.top1, 3), "reclass512_thrash": r512.stats["pages_thrashed"],
            "rule_thrash": rule["pages_thrashed"],
            "derived": f"dtop1={r256.top1 - froz.top1:+.3f}",
        })
        d_top1.append(r256.top1 - froz.top1)
        d_thrash.append(r256.stats["pages_thrashed"] - froz.stats["pages_thrashed"])
        # re-classification must fire (noise in, noise out, back), and the
        # learned manager must stay below the no-learning floor
        assert switches >= 2, rows
        assert r256.stats["pages_thrashed"] < rule["pages_thrashed"], rows
    avg_t1, avg_thr = float(np.mean(d_top1)), float(np.mean(d_thrash))
    rows.insert(0, {
        "trace": "AVG_RECLASS_VS_FROZEN", "oversub": "", "frozen_top1": "", "frozen_thrash": "",
        "reclass256_top1": "", "reclass256_thrash": "", "switches": "", "reclass512_top1": "",
        "reclass512_thrash": "", "rule_thrash": "", "derived": f"dtop1={avg_t1:+.3f} dthrash={avg_thr:+.0f}",
    })
    emit("table9_drift_reclass", rows, t0)
    # the reference's drift claim: re-classification beats the frozen-pattern
    # manager on both metrics, never worse on a trace, better on average
    assert all(d >= 0 for d in d_top1) and avg_t1 > 0, rows
    assert all(d <= 0 for d in d_thrash) and avg_thr < 0, rows
    return rows


#: Table IX's drifting workloads (the reference's ``suite``), each with its
#: oversubscription: StreamTriad and RandomScan phases at scale 0.4
TABLE9_SUITE = (
    (Drift(("StreamTriad", "RandomScan", "StreamTriad"), scale=0.4, cap=6000, segment=1024), 1.25),
    (Drift(("StreamTriad", "RandomScan") * 2 + ("StreamTriad",), scale=0.4, cap=6400, segment=1280), 1.2),
    (Drift(("StreamTriad", "RandomScan") * 2 + ("StreamTriad",), scale=0.4, cap=6000, segment=1024), 1.3),
)

#: Table X's scenarios: the well-behaved tenant and the oversubscription at
#: which the shared pool visibly hurts it (the reference's quick pin)
TABLE10_SCENARIOS = (("StreamTriad", 2.5), ("Hotspot", 1.6))


def table10_qos(good: str) -> QosSpec:
    """Table X's budgets: the well-behaved tenant's floor 0.5, the
    scanner's 0.05, equal shares, percentile stability."""
    return QosSpec(tiers=(QosTierSpec(good, floor=0.5, share=1.0), QosTierSpec("RandomScan", floor=0.05, share=1.0)))


def table10_traces(good: str) -> tuple[T.Trace, T.Trace]:
    """Table X's solo trace and its merge with RandomScan (scale 0.4, each
    part cut to 3,000 accesses, slices of 256)."""
    cut = lambda tr: tr.slice(0, min(len(tr), 3000))
    solo = cut(T.get_trace(good, scale=0.4))
    merged = T.concurrent([cut(T.get_trace(good, scale=0.4)), cut(Z.get_trace("RandomScan", scale=0.4))],
                          seed=0, slice_len=256)
    return solo, merged


def table10(ctx: Context, scenarios=TABLE10_SCENARIOS) -> list[dict]:
    """QoS fairness: per-tenant pages thrashed and IPC under an adversarial
    co-tenant (RandomScan), budgeted mux against the shared pool (the
    reference's subsystem result beyond the paper's tables).  Per scenario:
    ``solo`` (the well-behaved tenant alone), ``shared`` (the mux over the
    merge, one capacity pool) and ``budgeted`` (the same mux under
    :func:`table10_qos`, its budgets the leading victim key), all from fresh
    weights.  Per-tenant IPC is the timing model's on per-tenant counters
    (migrations approximated by demand faults); ``ipc_spread`` is max/min
    across tenants.  Geometry pinned to quick (scale 0.4, ``CONFIG_QUICK``,
    group 256) whatever the preset; no file is written."""
    t0 = time.time()
    tcfg = TrainConfig(256, 2, 128)

    def tenant_ipc(stats):
        return timing.ipc({"faults": stats["faults"], "pages_thrashed": stats["pages_thrashed"],
                           "migrated_blocks": stats["faults"], "zero_copy": 0}, stats["accesses"])

    rows, checks = [], []
    for good, oversub in scenarios:
        solo_tr, merged = table10_traces(good)
        run = lambda tr, **kw: R.run_ours(tr, CONFIG_QUICK, tcfg, oversubscription=oversub, device=ctx.device, **kw)
        solo, shared, budgeted = run(solo_tr), run(merged), run(merged, qos=table10_qos(good))
        for name, res in (("shared", shared), ("budgeted", budgeted)):
            g, sc = res.per_tenant_stats["0"], res.per_tenant_stats["1"]  # concurrent() order: good first
            ipc_g, ipc_s = tenant_ipc(g), tenant_ipc(sc)
            rows.append({
                "scenario": f"{good}+RandomScan", "oversub": oversub, "pool": name,
                "good_thrash": g["pages_thrashed"], "scan_thrash": sc["pages_thrashed"],
                "solo_thrash": solo.stats["pages_thrashed"],
                "good_ipc": round(ipc_g, 4), "scan_ipc": round(ipc_s, 4),
                "ipc_spread": round(max(ipc_g, ipc_s) / max(min(ipc_g, ipc_s), 1e-9), 3),
                "budgets": res.budgets or "",
            })
        checks.append({"scenario": f"{good}+RandomScan", "solo": solo.stats["pages_thrashed"],
                       "shared": shared.per_tenant_stats["0"]["pages_thrashed"],
                       "budgeted": budgeted.per_tenant_stats["0"]["pages_thrashed"]})
    emit("table10_qos_fairness", rows, t0)
    # the reference's fairness claim: budgets keep the well-behaved tenant
    # whole, no worse than alone and than the shared pool gave it
    for c in checks:
        assert c["budgeted"] <= c["solo"], (c, rows)
        assert c["budgeted"] <= c["shared"], (c, rows)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=TABLES, default=list(TABLES))
    ap.add_argument("--scale", choices=sorted(SCALE_PRESETS), default="paper")
    ap.add_argument("--frozen", action="store_true", help="ours without fine-tuning (epochs 0)")
    ap.add_argument("--table", default=None, help="the pretrained table for ours (a memo pickle or .npz)")
    ap.add_argument("--fresh", default=None, help="initial weights of the slots a table lacks (.npz; default: drawn "
                                                  "as the JAX package draws them)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = Context(args.scale, frozen=args.frozen, table=args.table, fresh=args.fresh, device=args.device)
    return {name: globals()[name](ctx) for name in args.only}


if __name__ == "__main__":
    main()
