"""The port's online loop end to end against the JAX package, with the model
frozen (``TrainConfig(epochs=0)``): both sides load the same pretrained
table and must agree exactly on the simulator counters, top-1, prediction
count, per-group accuracy and every round's actions.

* ``SMOKE`` on two quick-scale benchmarks, from a committed JAX pretrain
  memo (``experiments/cache``) read by both sides;
* the paper's width (``CONFIG``) on Hotspot at 150% oversubscription from
  ``experiments/torch/pretrain_paper.npz``, cut to its first 8 groups, and
  also held against the committed reference run of the JAX package
  (``experiments/torch/hotspot_paper_ref.json``).
"""
from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.uvm import runtime as JR
from repro.uvm import trace as JT
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import trace as PT

ROOT = Path(__file__).resolve().parent.parent
SMOKE_MEMO = ROOT / "experiments" / "cache" / "pretrain_e8919be312ea6abc.pkl"
PAPER_NPZ = ROOT / "experiments" / "torch" / "pretrain_paper.npz"
PAPER_REF = ROOT / "experiments" / "torch" / "hotspot_paper_ref.json"


def _jax_table(blob, trainer) -> JModelTable:
    table = JModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        table.slots[s] = JEntry(params={k: jnp.asarray(v) for k, v in e["params"].items()},
                                step=e["step"], n_updates=e["n_updates"], last_acc=e["last_acc"])
    return table


def _record(mgr, log):
    observe = mgr.observe

    def recording(batch):
        a = observe(batch)
        log.append(a)
        return a

    mgr.observe = recording


def _assert_actions_equal(ja, pa):
    assert len(ja) == len(pa)
    for j, p in zip(ja, pa):
        assert (j.pattern, j.accuracy, j.n_samples, j.warm) == (p.pattern, p.accuracy, p.n_samples, p.warm)
        np.testing.assert_array_equal(np.asarray(j.prefetch_blocks, np.int64), p.prefetch_blocks)
        np.testing.assert_array_equal(np.asarray(j.pre_evict_blocks, np.int64), p.pre_evict_blocks)
        assert (j.counters is None) == (p.counters is None)
        if j.counters is not None:
            np.testing.assert_array_equal(np.asarray(j.counters), p.counters.numpy())


def _run_both(trace_j, trace_p, jcfg, pcfg, jtable, ptable, oversub):
    tc = dict(group_size=2048, epochs=0, batch_size=256)
    jt, pt = JI.TrainConfig(**tc), PI.TrainConfig(**tc)
    jm = JR.manager_for(trace_j, jcfg, jt, oversubscription=oversub, table=jtable)
    pm = PR.manager_for(trace_p, pcfg, pt, oversubscription=oversub, table=ptable, device="cpu")
    # slots the memo lacks start fresh: hand the port the JAX package's init
    ptable.init_fn = lambda s: convert.params_from_jax(
        {k: np.asarray(v) for k, v in jm.trainer.new_params(s).items()}, "cpu")
    ja, pa = [], []
    _record(jm, ja)
    _record(pm, pa)
    jr = JR.run_ours(trace_j, jcfg, jt, oversubscription=oversub, manager=jm)
    pr = PR.run_ours(trace_p, pcfg, pt, oversubscription=oversub, manager=pm)
    assert pr.stats == jr.stats
    assert pr.top1 == jr.top1
    assert pr.n_predictions == jr.n_predictions
    assert pr.per_group_acc == jr.per_group_acc
    assert (pr.n_classes, pr.n_models, pr.warm_top1, pr.n_accesses) == \
        (jr.n_classes, jr.n_models, jr.warm_top1, jr.n_accesses)
    assert pr.ipc() == jr.ipc()
    _assert_actions_equal(ja, pa)
    return pr, pa


@pytest.mark.parametrize("name,oversub", [("Hotspot", 1.5), ("ATAX", 1.25)])
def test_frozen_run_ours_smoke_from_memo(name, oversub):
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    jtable = _jax_table(blob, JI.Trainer(JC.SMOKE, JI.TrainConfig()))
    ptable = PR.load_pretrain_memo(SMOKE_MEMO, PC.SMOKE, "cpu")
    assert sorted(ptable.slots) == sorted(blob["slots"])
    for s, e in blob["slots"].items():
        pe = ptable.slots[s]
        assert (pe.step, pe.n_updates, pe.last_acc) == (e["step"], e["n_updates"], e["last_acc"])
        for k, v in e["params"].items():
            np.testing.assert_array_equal(pe.params[k].numpy(), np.asarray(v))
        for k, v in e["opt_state"].m.items():
            np.testing.assert_array_equal(pe.opt_state.m[k].numpy(), np.asarray(v))
    res, actions = _run_both(JT.get_trace(name, 0.4), PT.get_trace(name, 0.4), JC.SMOKE, PC.SMOKE,
                             jtable, ptable, oversub)
    assert res.n_predictions > 0
    if name == "Hotspot":  # the gate opens: the frequency table and prefetches run
        assert sum(a.counters is not None for a in actions) > 0


def test_frozen_run_ours_paper_width_first_8_groups():
    ref = json.loads(PAPER_REF.read_text())
    cut = ref["first_8_groups"]
    blob = convert.blob_from_npz(PAPER_NPZ)
    jtable = _jax_table(blob, JI.Trainer(JC.CONFIG, JI.TrainConfig()))
    ptable = convert.table_from_blob(blob, PC.CONFIG, "cpu")
    n = 8 * ref["train"]["group_size"]
    res, actions = _run_both(JT.get_trace("Hotspot", 1.0).slice(0, n), PT.get_trace("Hotspot", 1.0).slice(0, n),
                             JC.CONFIG, PC.CONFIG, jtable, ptable, ref["oversubscription"])
    assert res.stats == cut["stats"]
    assert res.top1 == cut["top1"]
    assert res.n_predictions == cut["n_predictions"]
    assert res.per_group_acc == cut["per_group_acc"]
    assert sum(a.counters is not None for a in actions) == cut["n_gate_open"] > 0
    assert [a.pattern for a in actions] == cut["patterns"]


def test_npz_and_blob_loaders_agree():
    blob = convert.blob_from_npz(PAPER_NPZ)
    assert blob["n_slots"] == 8 and sorted(blob["slots"]) == [0, 3]
    t1 = PR.load_pretrained(PAPER_NPZ, PC.CONFIG, "cpu")
    t2 = convert.table_from_blob(blob, PC.CONFIG, "cpu")
    for s in (0, 3):
        assert t1.slots[s].n_updates == t2.slots[s].n_updates > 0
        for k, v in t1.slots[s].params.items():
            assert v.dtype == torch.float32 and torch.equal(v, t2.slots[s].params[k])
    assert sum(v.numel() for v in t1.slots[0].params.values()) == 632_066


def test_periodic_reclassification_matches():
    """``reclass_interval > 0``: the classifier runs every N faults (or N
    observed accesses) and a challenger needs ``reclass_hysteresis``
    agreeing windows; both sides make the same switches."""
    tj, tp = JT.get_trace("NW", 1.0), PT.get_trace("NW", 1.0)
    tc = dict(group_size=256, epochs=0)
    jm = JR.manager_for(tj, JC.SMOKE, JI.TrainConfig(**tc), reclass_interval=200, reclass_hysteresis=2)
    pm = PR.manager_for(tp, PC.SMOKE, PI.TrainConfig(**tc), reclass_interval=200, reclass_hysteresis=2,
                        device="cpu")
    rng = np.random.default_rng(0)
    g0, faults = 0, 0
    while g0 < len(tj):
        g1 = min(g0 + int(rng.integers(50, 400)), len(tj))
        faults += int(rng.integers(0, 150))
        for m in (jm, pm):
            m._fault_raw = faults
        assert jm._reclassify(tj.block[g0:g1], tj.kernel[g0:g1]) == pm._reclassify(tp.block[g0:g1], tp.kernel[g0:g1])
        g0 = g1
    names = ("n_reclassifications", "n_pattern_switches", "_cand_pat", "_cand_streak", "_active_pat")
    assert [getattr(pm, k) for k in names] == [getattr(jm, k) for k in names]
    assert jm.n_pattern_switches > 0
