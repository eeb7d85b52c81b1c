"""The port's figure runner (``repro_torch.bench.figures``) against the
reference's (``benchmarks/figures.py``) on a tiny ``Session``: the ``SMOKE``
predictor, traces at scale 0.1 cut to 768 accesses (three groups of 256),
one epoch.  Both sides start from the same pretrained tables (the ``SMOKE``
memos, moments and all, handed across by ``_table_to_host`` and
``convert.table_from_blob``) and the same fresh weights (the JAX package's
``Trainer.new_params``, handed across by ``fresh=``).

* Every simulator and UVMSmart cell, and the IPC of each, equal; Fig. 3's
  rows equal.
* Every protocol run (Figs. 4, 6 and 11) and every fine-tuned ``ours``
  (Figs. 12-14): top-1 and per-group accuracy within ``ACC_ATOL``, the
  counters within ``STATS_RTOL``, and each row's cells within the same
  distances after the reference's rounding: ``chip_smoke.py``'s phase 7
  (b) limits, which ``scripts/rehearse_training_cpu.py`` sets from correct
  runs at the paper's width that differ only in summation order (0.012 in
  top-1, 0.42 in the counters: each side's trainer rounds its float32 sums
  its own way and the online loop feeds its predictions back, C3 of
  ROADMAP.md).  At this size every row lands equal.
* ``protocol_chain`` fine-tunes one table across its links;
  ``ours(use_thrash_term=False)`` is memoised apart from the default.
* Fig. 10's four predictor kinds, each from the fresh weights its package
  draws: rows within the same limits.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.common as BC
import benchmarks.figures as JFIG
from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.uvm import runtime as JR
from repro.uvm.api.session import FEATURED as J_FEATURED
from repro.uvm.api.session import Session
from repro.uvm.api.specs import ModelSpec, TrainSpec
from repro.uvm.api.store import RunStore
from repro_torch import convert
from repro_torch.bench import figures as PFIG
from repro_torch.bench import tables as PTAB
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import export_torch_reference as E  # noqa: E402

MEMOS = {"default": ROOT / "experiments" / "cache" / "pretrain_e8919be312ea6abc.pkl",
         "fig11": ROOT / "experiments" / "cache" / "pretrain_35a93979a3421338.pkl"}
SCALE, CAP = 0.1, 768
TRAIN = dict(group_size=256, epochs=1, batch_size=64)
BENCHES = ["ATAX", "NW", "Hotspot"]  # Fig. 3's
SHORT = ["ATAX", "Hotspot"]  # Figs. 4, 11, 13 and 14's (Hotspot opens the prefetch gate)
ACC_ATOL, STATS_RTOL = 0.02, 0.4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensors are small: one intra-op thread keeps its work
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_table(path) -> JModelTable:
    blob = JR._load_pretrain_blob(path)
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(**TRAIN))
    table = JModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        table.slots[s] = JEntry(params=e["params"], prev_params=e["prev_params"], opt_state=e["opt_state"],
                                step=e["step"], n_updates=e["n_updates"], last_acc=e["last_acc"])
    return table


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX session (recording every cell the figures read) and the
    port's context, each after running all seven figures, and their rows."""
    jtables = {k: _jax_table(p) for k, p in MEMOS.items()}
    sess = E._recording_session(Session)(scale=SCALE, cap=CAP, benches=BENCHES, store=RunStore(enabled=False),
                                         model=ModelSpec(predictor=JC.SMOKE, train=TrainSpec(**TRAIN)))
    sess.pretrained = lambda pspec=None, **kw: jtables["fig11" if pspec and pspec.seed0 == 123 else "default"].clone()
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(**TRAIN))
    fresh = {s: {k: np.asarray(v) for k, v in trainer.new_params(s).items()} for s in range(8)}
    host = {k: convert.table_from_blob(JR._table_to_host(t), PC.SMOKE, "cpu", fresh) for k, t in jtables.items()}
    ctx = PTAB.Context("quick", benches=BENCHES, table=host["default"], fig11=host["fig11"], fresh=fresh,
                       device="cpu")
    ctx.pcfg, ctx.scale, ctx.cap = PC.SMOKE, SCALE, CAP
    ctx = ctx.with_train(PI.TrainConfig(**TRAIN))
    old_out = BC.OUT_DIR
    BC.OUT_DIR = tmp_path_factory.mktemp("figures")  # the reference's CSVs
    try:
        rows = {}
        for name, kw in (("fig3", {}), ("fig4", {"benches": SHORT}), ("fig6", {}), ("fig10", {"benches": SHORT}),
                         ("fig11", {"benches": SHORT}), ("fig12", {}), ("fig13", {"benches": SHORT}),
                         ("fig14", {"benches": SHORT})):
            rows[name] = (getattr(JFIG, name)(sess, **kw), getattr(PFIG, name)(ctx, **kw))
    finally:
        BC.OUT_DIR = old_out
    return sess, ctx, rows


def _close_rows(want: list, got: list, exact: tuple = ("benchmark",)):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k, v in w.items():
            if k in exact or isinstance(v, str):
                assert g[k] == v, (k, g, w)
            elif isinstance(v, int) and not isinstance(v, bool) and k.endswith("thrash"):
                assert abs(g[k] - v) <= STATS_RTOL * max(v, 1), (k, g, w)
            else:
                assert abs(g[k] - v) <= ACC_ATOL + 1e-3, (k, g, w)  # + the reference's rounding


def test_simulator_and_uvmsmart_cells_and_fig3_equal(both):
    sess, ctx, rows = both
    n = 0
    for key, cell in sess.cells.items():
        kind, b, *rest = key.split("|")
        if kind == "sim":
            (p, f), os_ = rest[0].split("+"), float(rest[1])
            st = ctx.sim(b, p, f, os_)
        elif kind == "uvmsmart":
            st = ctx.uvmsmart(b, float(rest[0]))
        else:
            continue
        assert st == cell["stats"], key
        assert ctx.ipc(b, st) == cell["ipc"], key
        n += 1
    assert n == len(BENCHES) * 4 + 2 * len(SHORT)
    want, got = rows["fig3"]
    assert got == want
    assert any(r["slowdown_1.5"] > 0 for r in got)


def test_protocol_rows_within_limits(both):
    sess, ctx, rows = both
    for name in ("fig4", "fig6", "fig10", "fig11"):
        want, got = rows[name]
        _close_rows(want, got, exact=("benchmark", "n_classes"))
    for key, cell in sess.cells.items():
        kind, b, mode, *rest = key.split("|")
        if kind != "protocol" or (rest and not rest[0].startswith("kind=")):
            continue
        r = ctx.protocol(b, mode, kind=rest[0][len("kind="):] if rest else "transformer")
        assert (r.n_classes, r.n_models, r.n_samples) == (cell["n_classes"], cell["n_models"], cell["n_samples"])
        assert abs(r.top1 - cell["top1"]) <= ACC_ATOL, key
        assert max(abs(a - c) for a, c in zip(r.per_group, cell["per_group"])) <= ACC_ATOL, key


def test_fine_tuned_ours_within_limits(both):
    sess, ctx, rows = both
    n = 0
    for key, cell in sess.cells.items():
        kind, b, *rest = key.split("|")
        if kind != "ours":
            continue
        r = ctx.ours(b, float(rest[0]), use_thrash_term=rest[1] == "thrash=True")
        assert r.n_predictions == cell["n_predictions"] and r.stats["occupancy"] == cell["stats"]["occupancy"], key
        assert abs(r.top1 - cell["top1"]) <= ACC_ATOL, key
        for k in ("pages_thrashed", "faults", "migrated_blocks"):
            assert abs(r.stats[k] - cell["stats"][k]) <= STATS_RTOL * max(cell["stats"][k], 1), (key, k)
        if r.stats == cell["stats"]:  # then the IPC is the reference's to the last bit
            assert {str(us): r.ipc(pred_overhead_us=us) for us in PFIG.FIG13_OVERHEADS_US} == cell["ipc"], key
        n += 1
    assert n == len(set(SHORT) | set(PFIG.FIG12_BENCH)) + len(PFIG.FIG12_BENCH) + len(SHORT)
    for name in ("fig12", "fig13", "fig14"):
        want, got = rows[name]
        _close_rows(want, got)


def test_chain_memo_and_surface(both):
    _, ctx, _ = both
    assert PTAB.FEATURED == J_FEATURED and PFIG.FIG12_BENCH == ["ATAX", "BICG", "NW", "Srad-v2"]
    # one table, fine-tuned link by link: each link updates the table the last one left
    table = ctx.pretrained("fig11")
    before = {s: e.n_updates for s, e in table.slots.items()}
    chain = ctx.protocol_chain(["ATAX", "BICG"], "ours", table=table)
    groups = sum(len(r.per_group) for r in chain)
    assert sum(e.n_updates for e in table.slots.values()) - sum(before.values()) == groups
    alone = ctx.protocol("BICG", "ours", table=ctx.pretrained("fig11"))
    assert alone.per_group != chain[1].per_group
    # fresh-weight protocols are memoised; a chain from fresh weights is per link
    assert ctx.protocol("ATAX", "offline") is ctx.protocol("ATAX", "offline")
    assert [r.top1 for r in ctx.protocol_chain(["ATAX"], "online_single")] == [ctx.protocol("ATAX", "online_single").top1]
    # the thrashing-term ablation is its own cell
    w, wo = ctx.ours("ATAX"), ctx.ours("ATAX", use_thrash_term=False)
    assert w is not wo and ctx.ours("ATAX", use_thrash_term=False) is wo and ctx.ours("ATAX") is w
    # each predictor kind's protocol run is its own memoised cell
    assert ctx.protocol("ATAX", "online_single", kind="mlp") is ctx.protocol("ATAX", "online_single", kind="mlp")
    assert ctx.protocol("ATAX", "online_single", kind="mlp") is not ctx.protocol("ATAX", "online_single")


def test_runner_cli_and_paper_tables():
    # the paper preset's Fig. 11 table is its recipe's committed export (seed0=123)
    got = PTAB.Context("paper", device="cpu").pretrained("fig11")
    want = PTAB.R.load_pretrained(PTAB.PAPER_TABLE_S123, PC.CONFIG, "cpu")
    assert sorted(got.slots) == sorted(want.slots)
    assert all(torch.equal(got.slots[s].params[k], v) for s, e in want.slots.items() for k, v in e.params.items())
    with pytest.raises(NotImplementedError, match="Fig. 11"):
        PTAB.Context("quick", device="cpu").pretrained("fig11")
    with pytest.raises(SystemExit):  # not a figure of the runner
        PFIG.main(["--only", "fig5", "--device", "cpu"])
    assert "fig10" in PFIG.FIGURES
