"""The paper's Tables I-IV and VI on the port (counterpart of
``benchmarks/tables.py``'s ``table1``-``table4`` and ``table6``).

    PYTHONPATH=src python -m repro_torch.bench.tables --only table6 [--scale paper] \\
        [--frozen] [--table PATH] [--device cpu]

Every cell runs on the card unless ``--device cpu`` is given.  Each table
prints the reference's contract line (``name,us_per_call,derived``) and
then one JSON object per row; Table VI's first row is the average
reduction of ``ours`` against the baseline (``lru`` + ``tree``).

A :class:`Context` takes the place of the reference's ``Session``: the same
benchmarks (``ALL_BENCH``), presets (``SCALE_PRESETS``) and rule-based
cells (``STANDARD_CELLS``), each trace cut to its first ``cap`` accesses,
and an in-process memo of traces and cells; it keeps no disk store.  ``ours`` is the paper's learned runtime,
``run_ours`` at the preset's predictor and schedule (``--frozen``: no
fine-tuning), from a pretrained table: at the ``paper`` preset the one
``scripts/export_torch_reference.py`` exports from ``Session.paper()``
(``experiments/torch/pretrain_paper.npz``, optimizer moments left out).
The ``quick`` preset's table has no exported copy, so there ``ours`` needs
``--table``.
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

from repro_torch.configs.predictor_paper import CONFIG, CONFIG_QUICK
from repro_torch.core.features import unique_deltas_per_phase
from repro_torch.core.incremental import TrainConfig
from repro_torch.core.model_table import ModelTable
from repro_torch.core.pattern import PatternClassifier
from repro_torch.core.predictor import param_count
from repro_torch.device import resolve_device
from repro_torch.uvm import runtime as R
from repro_torch.uvm import simulator as S
from repro_torch.uvm import trace as T
from repro_torch.uvm.uvmsmart import run_uvmsmart

ALL_BENCH = list(T.BENCHMARKS)
#: (trace scale, cap on accesses), as ``repro.uvm.api.specs.SCALE_PRESETS``
SCALE_PRESETS = {"quick": (0.4, 6000), "paper": (1.0, 60_000)}
#: every rule-based cell the tables read
STANDARD_CELLS = (
    ("lru", "tree"), ("lru", "demand"), ("hpe", "demand"),
    ("hpe", "tree"), ("belady", "demand"),
)
PAPER_TABLE = Path(__file__).resolve().parents[3] / "experiments" / "torch" / "pretrain_paper.npz"
TABLES = ("table1", "table2", "table3", "table4", "table6")


class Context:
    """The cells of one preset on one device, memoised in process.

    ``table`` is the pretrained model table ``ours`` starts from (a
    :class:`ModelTable` or the path of a memo pickle or ``.npz``); it
    defaults to ``PAPER_TABLE`` at the ``paper`` preset and to none at
    ``quick``, where ``ours`` then raises.  ``pcfg`` (the predictor) and
    ``tcfg`` (the schedule) are the preset's."""

    def __init__(self, preset: str = "paper", *, benches: list | None = None, frozen: bool = False,
                 table: ModelTable | str | Path | None = None, device: str | torch.device = "cuda"):
        self.preset = preset
        self.scale, self.cap = SCALE_PRESETS[preset]
        self.benches = list(benches) if benches is not None else list(ALL_BENCH)
        self.device = resolve_device(device)
        paper = preset == "paper"
        self.pcfg = CONFIG if paper else CONFIG_QUICK
        # the reference's PAPER_TRAIN and its default TrainSpec
        train = TrainConfig(2048, 3, 256) if paper else TrainConfig(1024, 2, 128)
        self.tcfg = dataclasses.replace(train, epochs=0) if frozen else train
        self._table = PAPER_TABLE if table is None and paper else table
        self._master = None
        self._traces: dict = {}
        self._sims: dict = {}
        self._smart: dict = {}
        self._ours: dict = {}

    def with_train(self, tcfg: TrainConfig, benches: list | None = None) -> "Context":
        """This context with another schedule for ``ours`` (and optionally
        other benchmarks); traces and rule-based cells stay shared."""
        other = copy.copy(self)
        other.tcfg = tcfg
        other.benches = list(benches) if benches is not None else list(self.benches)
        other._ours = {}
        return other

    def trace(self, name: str) -> T.Trace:
        if name not in self._traces:
            tr = T.get_trace(name, self.scale)
            self._traces[name] = tr.slice(0, min(len(tr), self.cap))
        return self._traces[name]

    def sim(self, name: str, policy: str, prefetch: str, oversub: float = 1.25) -> dict:
        """One rule-based cell (the port's ``run_batch`` runs cells one
        after another, so a miss runs only this one)."""
        key = (name, policy, prefetch, oversub)
        if key not in self._sims:
            self._sims[key] = S.run_batch(self.trace(name), [(policy, prefetch, oversub)], device=self.device)[0]
        return self._sims[key]

    def sims(self, name: str, oversub: float = 1.25) -> dict:
        """The ``STANDARD_CELLS`` row of one benchmark, by ``policy+prefetch``."""
        return {f"{p}+{f}": self.sim(name, p, f, oversub) for p, f in STANDARD_CELLS}

    def uvmsmart(self, name: str, oversub: float = 1.25) -> dict:
        if (name, oversub) not in self._smart:
            self._smart[(name, oversub)] = run_uvmsmart(self.trace(name), oversubscription=oversub,
                                                        device=self.device)
        return self._smart[(name, oversub)]

    def pretrained(self) -> ModelTable:
        """A fresh copy of the pretrained table (fine-tuning changes it)."""
        if self._master is None:
            if self._table is None:
                raise NotImplementedError(
                    f"the {self.preset!r} preset's pretrained table (the reference's Session().pretrained(): "
                    "pretrain_table over PretrainSpec(scale=0.24)'s corpus at CONFIG_QUICK and "
                    "TrainConfig(1024, 2, 128)) has no exported copy; pass table=")
            self._master = (self._table if isinstance(self._table, ModelTable)
                            else R.load_pretrained(self._table, self.pcfg, self.device))
        return self._master.clone()

    def ours(self, name: str, oversub: float = 1.25) -> R.LearnedRunResult:
        """The paper's learned runtime on one benchmark (Section IV)."""
        if (name, oversub) not in self._ours:
            self._ours[(name, oversub)] = R.run_ours(self.trace(name), self.pcfg, self.tcfg,
                                                     oversubscription=oversub, table=self.pretrained(),
                                                     device=self.device)
        return self._ours[(name, oversub)]


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=TABLES, default=list(TABLES))
    ap.add_argument("--scale", choices=sorted(SCALE_PRESETS), default="paper")
    ap.add_argument("--frozen", action="store_true", help="ours without fine-tuning (epochs 0)")
    ap.add_argument("--table", default=None, help="the pretrained table for ours (a memo pickle or .npz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ctx = Context(args.scale, frozen=args.frozen, table=args.table, device=args.device)
    return {name: globals()[name](ctx) for name in args.only}


if __name__ == "__main__":
    main()
