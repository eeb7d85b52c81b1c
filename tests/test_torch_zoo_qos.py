"""The port's drift zoo, QoS budgets, quick-preset memos and ``random``
eviction policy against the JAX package's, on the CPU.

Everything here is integer or host numpy work and is held exactly: the zoo
traces by SHA-256, the budget controller's budgets, scores and leading
victim keys round by round, a frozen budgeted ``run_ours`` counter for
counter (fresh ``CONFIG_QUICK`` weights, drawn by each package, a few
float32 elements one ulp apart, which moves no prediction here), the
pretrain memo keys, and the ``random`` policy's counters and final state.
The quick preset's fine-tuned ``ours`` on ATAX from the committed memo
lands equal to the JAX package's exported run too (float32, one device,
the same operations in the same order at this size).
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core.incremental import TrainConfig as JTrainConfig
from repro.uvm import runtime as JR
from repro.uvm import simulator as JS
from repro.uvm import trace as JT
from repro.uvm import zoo as JZ
from repro.uvm.api.specs import QosSpec as JQosSpec
from repro.uvm.api.specs import QosTierSpec as JQosTierSpec
from repro.uvm.qos import BudgetController as JBudget
from repro.uvm.qos import QosTier as JTier
from repro_torch.bench import tables as PTAB
from repro_torch.configs import predictor_paper as PC
from repro_torch.core.incremental import TrainConfig as PTrainConfig
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import simulator as PS
from repro_torch.uvm import trace as PT
from repro_torch.uvm import zoo as PZ
from repro_torch.uvm.qos import BudgetController as PBudget
from repro_torch.uvm.qos import QosTier as PTier

ROOT = Path(__file__).resolve().parent.parent
MEMOS = ROOT / "experiments" / "cache"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensors are small: one intra-op thread keeps its work
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(tr) -> str:
    h = hashlib.sha256()
    for a in (tr.page, tr.pc, tr.tb, tr.kernel) + (() if tr.tenant is None else (tr.tenant,)):
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    h.update(f"{tr.name}|{tr.n_pages}|{tuple(tr.tenant_names)}".encode())
    return h.hexdigest()


@pytest.mark.parametrize("scale", [0.4, 1.0])
def test_zoo_traces_equal_jax(scale):
    assert sorted(PZ.PATTERNS) == sorted(JZ.PATTERNS) and PZ.workload_names() == JZ.workload_names()
    for name in PZ.workload_names():
        assert _sha(PZ.get_trace(name, scale)) == _sha(JZ.get_trace(name, scale)), name
    phases = ("ATAX", "RandomScan", "StridedNoise", "PtrChase")
    for kw in (dict(segment=700), dict(segment=900, switch="gradual", mix_window=128, seed=3)):
        assert _sha(PZ.phase_trace(phases, scale, **kw)) == _sha(JZ.phase_trace(phases, scale, **kw))
    for kw in (dict(), dict(joins=(0, 500, 900), spans=(1200, 0, 800), slice_len=128, seed=2)):
        assert _sha(PZ.tenant_churn(("NW", "RandomScan", "Hotspot"), scale, **kw)) == \
            _sha(JZ.tenant_churn(("NW", "RandomScan", "Hotspot"), scale, **kw))


def test_table9_drift_traces_equal_jax():
    from repro.uvm.api.session import Session
    from repro.uvm.api.store import RunStore

    sess = Session(store=RunStore(enabled=False))
    ctx = PTAB.Context("quick", device="cpu")
    for w, _oversub in PTAB.TABLE9_SUITE:
        jw = sess.drifting(w.phases, scale=w.scale, cap=w.cap, segment=w.segment)
        assert _sha(ctx.trace(w)) == _sha(sess.trace(jw))
        assert ctx.drifting(w.phases, segment=w.segment, cap=w.cap) == w
    for good, _ in PTAB.TABLE10_SCENARIOS:
        solo, merged = PTAB.table10_traces(good)
        cut = lambda tr: tr.slice(0, min(len(tr), 3000))
        assert _sha(solo) == _sha(cut(JT.get_trace(good, 0.4)))
        assert _sha(merged) == _sha(JT.concurrent([cut(JT.get_trace(good, 0.4)), cut(JZ.get_trace("RandomScan", 0.4))],
                                                  seed=0, slice_len=256))


@pytest.mark.parametrize("stability", ["percentile", "gmr"])
def test_budget_controller_equals_jax_round_by_round(stability):
    """A scripted run: tenants admitted by their blocks, pressure fed every
    round, budgets recomputed every second round, one tenant released."""
    rng = np.random.default_rng(4)
    tiers_j = {"a": JTier(0.5, 1.0), "b": JTier(0.05, 1.0), "c": JTier(0.2, 2.0)}
    tiers_p = {k: PTier(t.floor, t.share) for k, t in tiers_j.items()}
    jb = JBudget(97, 128, tiers=tiers_j, stability=stability, interval=2)
    pb = PBudget(97, 128, tiers=tiers_p, stability=stability, interval=2)
    owners = {"a": np.arange(0, 40), "b": np.arange(40, 100), "c": np.arange(100, 128)}
    for rnd in range(12):
        for t in ("a", "b", "c") if rnd < 8 else ("a", "b"):
            blocks = rng.choice(owners[t], 10)
            jb.observe_blocks(t, blocks)
            pb.observe_blocks(t, blocks)
            pressure = float(rng.random() * (0.9 if t == "b" else 0.1))
            jb.observe_pressure(t, pressure)
            pb.observe_pressure(t, pressure)
        jb.step()
        pb.step()
        if rnd == 8:
            jb.release("c")
            pb.release("c")
        assert pb.budgets == jb.budgets and pb.scores == jb.scores
        resident = rng.random(128) < 0.7
        np.testing.assert_array_equal(pb.evict_pref(resident), jb.evict_pref(resident))
    np.testing.assert_array_equal(pb.block_owner, jb.block_owner)


def test_budgeted_run_ours_equals_jax_and_drives_four_keys():
    """Table X's StreamTriad + RandomScan merge at 2.5, frozen, under its
    budgets: every counter, per-tenant stat and budget equal; the mux's
    leading key makes ``evict_select`` take four keys."""
    from repro_torch.kernels import evict_select as ES

    solo, merged = PTAB.table10_traces("StreamTriad")
    cut = lambda tr: tr.slice(0, min(len(tr), 3000))
    jmerged = JT.concurrent([cut(JT.get_trace("StreamTriad", 0.4)), cut(JZ.get_trace("RandomScan", 0.4))],
                            seed=0, slice_len=256)
    jq = JQosSpec(tiers=(JQosTierSpec("StreamTriad", 0.5, 1.0), JQosTierSpec("RandomScan", 0.05, 1.0)))
    jres = JR.run_ours(jmerged, JC.CONFIG_QUICK, JTrainConfig(256, 0, 128), oversubscription=2.5, qos=jq)
    n_keys = []
    plain = ES.evict_select_plain

    def counting(cand, keys, n_evict):
        n_keys.append(len(keys))
        return plain(cand, keys, n_evict)

    ES.evict_select_plain = counting
    try:
        pres = PR.run_ours(merged, PC.CONFIG_QUICK, PTrainConfig(256, 0, 128), oversubscription=2.5,
                           qos=PTAB.table10_qos("StreamTriad"), device="cpu")
    finally:
        ES.evict_select_plain = plain
    assert pres.stats == jres.stats
    assert pres.per_tenant_stats == jres.per_tenant_stats
    assert pres.budgets == jres.budgets == {"1": 51}
    assert pres.top1 == jres.top1 and pres.n_predictions == jres.n_predictions
    assert set(n_keys) == {4}


def test_memo_keys_equal_jax_and_the_quick_preset_reads_its_memo():
    from repro.uvm.api.specs import PRETRAIN_BENCHES

    def jkey(scale, pcfg, tcfg):
        corpus = [JT.BENCHMARKS[n](scale=scale, seed=777 + i) for i, n in enumerate(PRETRAIN_BENCHES)]
        return JR._pretrain_cache_key(corpus, pcfg, tcfg, "transformer", 0.85, 2)

    assert PTAB.PRETRAIN_BENCHES == tuple(PRETRAIN_BENCHES)
    recipes = [(0.4 * 0.6, "CONFIG_QUICK", (1024, 2, 128), "0e86a9ef3a27bb0d"),  # Session().pretrained()
               (0.24, "CONFIG_QUICK", (256, 2, 128), "78abbd28fc2f0c99"),  # Table IX's
               (1.0 * 0.6, "CONFIG", (2048, 3, 256), "03ac1c3621d0f683")]  # Session.paper()'s
    for scale, cfg, train, key in recipes:
        pk = PR._pretrain_cache_key(PTAB.pretrain_corpus(scale), getattr(PC, cfg), PTrainConfig(*train),
                                    "transformer", 0.85, 2)
        assert pk == jkey(scale, getattr(JC, cfg), JTrainConfig(*train)) == key
    before = sorted(p.name for p in MEMOS.iterdir())
    ctx = PTAB.Context("quick", device="cpu")
    table = ctx.pretrained()
    assert sorted(table.slots) == [0, 3] and ctx.pretrain() is not ctx.pretrain()
    assert sorted(PTAB.Context("quick", device="cpu").pretrain(PC.CONFIG_QUICK, PTrainConfig(256, 2, 128),
                                                                scale=0.24).slots) == [0, 3]
    assert sorted(p.name for p in MEMOS.iterdir()) == before  # read, never written
    assert sorted(ctx.pretrained("table7").slots) == [0, 3]  # the committed export, not a memo
    assert sorted(p.name for p in MEMOS.iterdir()) == before
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        ctx.pretrained("fig11")


def test_quick_preset_ours_equals_the_jax_package_from_the_memo():
    """The quick preset's learned runtime, fine-tuned from the committed
    memo, against the JAX package's run of ``benchmarks/tables.py``'s Table
    VI at quick (``tables_quick_ref.json``)."""
    import json

    want = json.loads((ROOT / "experiments" / "torch" / "tables_quick_ref.json").read_text())
    cell = want["cells"]["ours|ATAX|1.25|thrash=True"]
    res = PTAB.Context("quick", device="cpu").ours("ATAX")
    assert (res.stats, res.top1, res.n_predictions) == (cell["stats"], cell["top1"], cell["n_predictions"])
    assert res.per_group_acc == cell["per_group_acc"]


@pytest.mark.parametrize("name", ["ATAX", "Hotspot"])
def test_random_policy_is_bit_exact(name):
    jt, pt = JT.get_trace(name, 0.4), PT.get_trace(name, 0.4)
    for pf, ov, seed in (("demand", 1.5, 0), ("tree", 1.25, 3)):
        jr = JS.run(jt, policy="random", prefetch=pf, oversubscription=ov, seed=seed)
        pr = PS.run(pt, policy="random", prefetch=pf, oversubscription=ov, seed=seed, device="cpu")
        for f in ("resident", "evicted_once", "last_access", "occupancy", "thrash_events", "faults", "migrations"):
            np.testing.assert_array_equal(getattr(pr.state, f).numpy(), np.asarray(getattr(jr.state, f)), err_msg=f)
        np.testing.assert_array_equal(pr.thrash, jr.thrash)
    cells = [("random", "tree", 1.25), ("random", "demand", 1.1), ("lru", "tree", 1.25)]
    assert PS.run_batch(pt, cells, seeds=[1, 2, 3], device="cpu") == JS.run_batch(jt, cells, seeds=[1, 2, 3])
    assert PS.POLICIES == JS.POLICIES
    st = PS.apply_prefetch(PS.init_state(64, "cpu", seed=5), torch.arange(64) < 40, capacity=16, policy="random")
    jst = JS.apply_prefetch(JS.init_state(64, 5), np.arange(64) < 40, capacity=16, policy="random")
    np.testing.assert_array_equal(st.resident.numpy(), np.asarray(jst.resident))
