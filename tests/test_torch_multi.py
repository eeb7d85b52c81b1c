"""The port's Section V-F path against the JAX package, on the CPU: the
concurrent merge (``trace.concurrent``), ``TenantMux`` round by round, the
tenant path of ``run_ours`` under ``mux``, ``mux-shared`` and ``merged``,
``Trainer.evaluate_many``/``train_group_many`` and the runner's Tables VII
and VIII.

Fresh model-table slots draw their weights from ``jax.random`` in the JAX
package and from ``repro_torch.random`` in the port, which are one ulp
apart in a few elements in a hundred thousand, so every comparison hands
the port the JAX package's initial weights (converted) to start from the
same bits.

Tolerances, each with its reason:

* integers (merges, counters, victim and prefetch sets, dense exports,
  tags) and frozen runs (``epochs=0``: every float is a forward of the same
  weights): equal, bit for bit;
* a fine-tuned run: each of the JAX run's fine-tunes, repeated by the
  port's ``train_group_many`` on the same entry and inputs, within
  ``GROUP_ATOL`` 1e-3 of the JAX package's params (the limit of
  ``tests/test_torch_train.py``: AdamW turns gradient elements at the
  rounding level into full steps); over a whole run the online loop feeds
  its own predictions back, so the runs' top-1 are held within
  ``RUN_TOP1_ATOL`` 0.02 (phase 7 (b)'s limit, ``PERF.md`` §2; a tenant's
  own top-1 over a few groups moves more, so it is not held) and the
  integers the trace alone decides (prediction count, classes, models,
  accesses per tenant) equal;
* ``train_group_many`` at 4 lanes, where the JAX package vmaps and the port
  runs the lanes one by one: params within ``TRAIN_ATOL`` 1e-4, the limit
  of one ``train_group`` in ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as BC
import benchmarks.tables as JTAB
from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.features import DeltaVocab as JVocab
from repro.core.features import FeatureStream as JStream
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.uvm import manager as JM
from repro.uvm import runtime as JR
from repro.uvm import trace as JT
from repro.uvm.api.specs import PretrainSpec
from repro_torch import convert
from repro_torch.bench import tables as PTAB
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core.model_table import Entry as PEntry
from repro_torch.optim import adamw as PA
from repro_torch.uvm import manager as PM
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import trace as PT
from repro_torch.uvm.qos import BudgetController

from test_torch_runtime import SMOKE_MEMO, _jax_table

GROUP_ATOL = 1e-3
TRAIN_ATOL = 1e-4
RUN_TOP1_ATOL = 0.02
SCALE, CAP, G = 0.4, 3000, 512


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def _to_port(tree):
    return None if tree is None else convert.params_from_jax(_np(tree), "cpu")


def _max_diff(jparams, pparams) -> float:
    return max(float(np.abs(np.asarray(jparams[k]) - pparams[k].numpy()).max()) for k in jparams)


def _jax_init() -> dict:
    """The JAX package's initial weights of every slot at ``SMOKE``."""
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig())
    return {s: _np(trainer.new_params(s)) for s in range(8)}


INIT = _jax_init()


def _tables():
    """The SMOKE pretrain memo on both sides; the port's fresh slots start
    from the JAX package's initial weights."""
    jtable = _jax_table(JR._load_pretrain_blob(SMOKE_MEMO), JI.Trainer(JC.SMOKE, JI.TrainConfig()))
    return jtable, PR.load_pretrain_memo(SMOKE_MEMO, PC.SMOKE, "cpu", fresh=INIT)


def _parts(module, names, scale=SCALE, cap=CAP):
    out = []
    for n in names:
        tr = module.get_trace(n, scale)
        out.append(tr.slice(0, min(len(tr), cap)))
    return out


def _merges(names, **kw):
    return JT.concurrent(_parts(JT, names), **kw), PT.concurrent(_parts(PT, names), **kw)


# --- trace.concurrent ---------------------------------------------------------------


def _case_traces(module, case):
    if case == "pair":
        return _parts(module, ("StreamTriad", "Hotspot")), dict(seed=0, slice_len=256)
    if case == "triple":
        return _parts(module, ("ATAX", "NW", "2DCONV")), dict(seed=3, slice_len=512)
    if case == "deferred_joins":  # tenant 0 runs out long before the others join: the clock jumps
        parts = [module.get_trace("AddVectors", 0.1)] + _parts(module, ("Srad-v2", "NW"), 0.2, 2000)
        return parts, dict(seed=1, slice_len=300, starts=[0, 50_000, 52_000])
    if case == "empty_tenant":
        parts = _parts(module, ("Backprop", "MVT"), 0.2, 2000)
        return [parts[0], parts[1].slice(0, 0), parts[1]], dict(seed=2, slice_len=200, starts=[0, 0, 700])
    raise KeyError(case)


@pytest.mark.parametrize("case", ["pair", "triple", "deferred_joins", "empty_tenant"])
def test_concurrent_matches_jax(case):
    jparts, kw = _case_traces(JT, case)
    pparts, _ = _case_traces(PT, case)
    j, p = JT.concurrent(jparts, **kw), PT.concurrent(pparts, **kw)
    assert (p.name, p.n_pages, p.tenant_names) == (j.name, j.n_pages, j.tenant_names)
    for f in ("page", "pc", "tb", "kernel", "tenant"):
        a, b = getattr(j, f), getattr(p, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert len(np.unique(p.tenant)) >= 2
    if case == "deferred_joins":  # the joiners start right after tenant 0, before their nominal start
        assert np.flatnonzero(p.tenant != 0)[0] == np.count_nonzero(p.tenant == 0) < 50_000
    if case == "empty_tenant":
        assert 1 not in set(p.tenant.tolist()) and p.tenant_names[1] == "MVT"
    with pytest.raises(ValueError, match="starts must align"):
        PT.concurrent(pparts, starts=[0])


# --- TenantMux round by round -------------------------------------------------------


def _muxes(merge_j, merge_p, shared: bool, tc: dict):
    jtable, ptable = _tables()
    kw = dict(predictor=None, train=None, n_pages=merge_j.n_pages, n_blocks=256, capacity=96)
    jcfg = JM.ManagerConfig(**{**kw, "predictor": JC.SMOKE, "train": JI.TrainConfig(**tc)})
    pcfg = PM.ManagerConfig(**{**kw, "predictor": PC.SMOKE, "train": PI.TrainConfig(**tc)})
    jm = JM.TenantMux(jcfg, (0, 1), shared_freq_table=shared, auto_create=False, tables=jtable)
    pm = PM.TenantMux(pcfg, (0, 1), shared_freq_table=shared, auto_create=False, tables=ptable, device="cpu")
    return jm, pm


def _assert_tenant_actions_equal(ja, pa):
    assert (ja.pattern, ja.accuracy, ja.n_samples, ja.warm) == (pa.pattern, pa.accuracy, pa.n_samples, pa.warm)
    np.testing.assert_array_equal(pa.prefetch_blocks, np.asarray(ja.prefetch_blocks, np.int64))
    np.testing.assert_array_equal(pa.pre_evict_blocks, np.asarray(ja.pre_evict_blocks, np.int64))
    assert (ja.counters is None) == (pa.counters is None)
    if ja.counters is not None:
        np.testing.assert_array_equal(pa.counters.numpy(), np.asarray(ja.counters))


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_mux_rounds_match_jax(shared):
    """Both muxes fed one merge in groups that mix the tenants, with seeded
    E∪T flags and a fault clock that restarts once (a consumer switch):
    every round's combined and per-tenant actions equal."""
    tj, tp = _merges(("StreamTriad", "Hotspot"), seed=0, slice_len=384)
    tc = dict(group_size=G, epochs=0, batch_size=64)
    jm, pm = _muxes(tj, tp, shared, tc)
    rng = np.random.default_rng(7)
    fc, gates = 0, 0
    for r, g0 in enumerate(range(0, len(tj), G)):
        g1 = min(g0 + G, len(tj))
        ja = jm.observe(JM.FaultBatch(tj.page[g0:g1], tj.pc[g0:g1], tj.tb[g0:g1], tj.kernel[g0:g1],
                                      tenant=tj.tenant[g0:g1]))
        pa = pm.observe(PM.FaultBatch(tp.page[g0:g1], tp.pc[g0:g1], tp.tb[g0:g1], tp.kernel[g0:g1],
                                      tenant=tp.tenant[g0:g1]))
        assert list(pa.per_tenant) == list(ja.per_tenant) and pa.budgets is ja.budgets is None
        np.testing.assert_array_equal(pa.prefetch_blocks, ja.prefetch_blocks)
        np.testing.assert_array_equal(pa.pre_evict_blocks, ja.pre_evict_blocks)
        assert (ja.counters is None) == (pa.counters is None)
        if ja.counters is not None:
            gates += 1
            np.testing.assert_array_equal(pa.counters.numpy(), np.asarray(ja.counters))
        for k in ja.per_tenant:
            _assert_tenant_actions_equal(ja.per_tenant[k], pa.per_tenant[k])
        fc = 30 if r == 4 else fc + int(rng.integers(20, 90))  # round 4: the clock restarts
        we = rng.random(g1 - g0) < 0.3
        jm.feedback(JM.Outcomes(was_evicted=we, fault_count=fc))
        pm.feedback(PM.Outcomes(was_evicted=we, fault_count=fc))
    assert gates >= 3
    assert pm.per_group == jm.per_group and (pm.top1, pm.warm_top1) == (jm.top1, jm.warm_top1)
    assert pm.per_tenant_top1 == jm.per_tenant_top1
    assert (pm.n_predictions, pm.n_classes, pm.n_models) == (jm.n_predictions, jm.n_classes, jm.n_models)
    for k in (0, 1):
        a, b = jm.managers[k], pm.managers[k]
        assert (b._flush_interval, b._interval, b._fault_base) == (a._flush_interval, a._interval, a._fault_base)
        assert b.freq_table.flushes == a.freq_table.flushes > 0
        np.testing.assert_array_equal(b.freq_table.tags.numpy(), np.asarray(a.freq_table.tags))
    if shared:
        assert (pm._flush_interval, pm._fault_base) == (jm._flush_interval, jm._fault_base) and pm._fault_base > 0
        assert pm.managers[0].freq_table._table is pm.managers[1].freq_table._table is pm._shared_freq
    np.testing.assert_array_equal(pm._combined_dense().numpy(), np.asarray(jm._combined_dense()))


def test_mux_feedback_per_tenant_matches_jax():
    """``feedback(tenant=k)`` closes one tenant's batch; the next
    round-level feedback closes the others only, on both sides."""
    tj, tp = _merges(("ATAX", "Srad-v2"), seed=4, slice_len=200)
    tc = dict(group_size=G, epochs=0, batch_size=64)
    jm, pm = _muxes(tj, tp, False, tc)
    paired = 0
    for r, g0 in enumerate(range(0, 4 * G, G)):
        g1 = g0 + G
        jm.observe(JM.FaultBatch(tj.page[g0:g1], tj.pc[g0:g1], tj.tb[g0:g1], tj.kernel[g0:g1],
                                 tenant=tj.tenant[g0:g1]))
        pm.observe(PM.FaultBatch(tp.page[g0:g1], tp.pc[g0:g1], tp.tb[g0:g1], tp.kernel[g0:g1],
                                 tenant=tp.tenant[g0:g1]))
        assert [k for k, *_ in pm._round] == [k for k, *_ in jm._round]
        first, _, n_first = jm._round[0]
        paired += len(jm._round) > 1
        for m, O in ((jm, JM.Outcomes), (pm, PM.Outcomes)):
            m.feedback(O(was_evicted=np.zeros(n_first, bool), fault_count=100 * (r + 1)), tenant=first)
            if m._round is not None:  # the other tenant's batch is still open
                m.feedback(O(was_evicted=np.zeros(g1 - g0, bool), fault_count=100 * (r + 1) + 10))
            assert m._round is None
    assert paired >= 2
    for k in (0, 1):
        a, b = jm.managers[k], pm.managers[k]
        assert b._pending is a._pending is None
        assert (b._flush_interval, b.top1, b.per_group) == (a._flush_interval, a.top1, a.per_group)
        assert sorted((s, e.n_updates) for s, e in b.table.slots.items()) == \
            sorted((s, e.n_updates) for s, e in a.table.slots.items())


def test_mux_misuse_and_unported_options_raise():
    cfg = PM.ManagerConfig(predictor=PC.SMOKE, train=PI.TrainConfig(group_size=64, epochs=0, batch_size=32),
                           n_pages=1024, n_blocks=64, capacity=16)
    mux = PM.TenantMux(cfg, (0, 1), auto_create=False, device="cpu")
    with pytest.raises(RuntimeError):
        mux.feedback(PM.Outcomes(fault_count=1))
    with pytest.raises(KeyError):
        mux.observe(PM.FaultBatch(np.arange(8), tenant=np.full(8, 5)))
    # snapshots are ported (tests/test_torch_fault_tolerance.py): the
    # rejected observe left its round open, which a snapshot refuses, and an
    # empty state is rejected by its version, as in the reference
    with pytest.raises(RuntimeError, match="mid-round"):
        mux.state()
    with pytest.raises(ValueError, match="version"):
        mux.restore({})
    # QoS budgets: the leading victim key on the mux's device; an admitted
    # tenant that owns no block yet leaves every resident block a first victim
    budgeted = PM.TenantMux(cfg, (0,), qos=BudgetController(16, 64), device="cpu")
    assert budgeted.evict_pref(torch.ones(64, dtype=torch.bool)).tolist() == [0] * 64
    budgeted.qos.admit(0)
    pref = budgeted.evict_pref(torch.ones(64, dtype=torch.bool))
    assert pref.dtype == torch.int32 and pref.tolist() == [-1] * 64
    # an unregistered frequency table raises what the reference's registry raises
    with pytest.raises(KeyError, match="unknown freq-table 'lru'"):
        PM.TenantMux(dataclasses.replace(cfg, freq_table="lru"), (0,), device="cpu")
    with pytest.raises(ValueError, match="tenant tags must align"):
        PM.FaultBatch(np.arange(8), tenant=np.zeros(3))
    # an untagged batch goes to the "default" tenant; auto_create admits it
    auto = PM.TenantMux(cfg, device="cpu")
    out = auto.observe(PM.FaultBatch(np.arange(64)))
    assert list(out.per_tenant) == ["default"] and auto.evict_pref(None) is None
    auto.feedback(PM.Outcomes(fault_count=3))
    auto.release("default")
    assert auto.managers == {} and "default" in auto.per_tenant_top1
    assert torch.equal(auto._combined_dense(), torch.full((64,), -1, dtype=torch.int32))


def test_mux_equals_standalone_managers():
    """Demuxing a merge with isolated tables equals each tenant's stream
    run through its own manager (the reference's property), on the port
    alone, fine-tuned."""
    tr = PT.concurrent(_parts(PT, ("StreamTriad", "Hotspot")), seed=0, slice_len=G).slice(0, 5 * G)
    tc = PI.TrainConfig(group_size=G, epochs=1, batch_size=128)
    cfg = PM.ManagerConfig(predictor=PC.SMOKE, train=tc, n_pages=tr.n_pages, n_blocks=256, capacity=64)
    _, master = _tables()
    mux = PM.TenantMux(cfg, (0, 1), auto_create=False, tables=master, device="cpu")
    solo = {t: PM.OversubscriptionManager(cfg, table=master.clone(), device="cpu") for t in (0, 1)}
    fc = 0
    for g0 in range(0, len(tr), G):
        g1 = min(g0 + G, len(tr))
        tags = tr.tenant[g0:g1]
        fc += (g1 - g0) // 4
        mux.observe(PM.FaultBatch(tr.page[g0:g1], tr.pc[g0:g1], tr.tb[g0:g1], tr.kernel[g0:g1], tenant=tags))
        mux.feedback(PM.Outcomes(was_evicted=np.zeros(g1 - g0, bool), fault_count=fc))
        for t in (0, 1):
            idx = np.flatnonzero(tags == t)
            if len(idx):
                solo[t].observe(PM.FaultBatch(tr.page[g0:g1][idx], tr.pc[g0:g1][idx], tr.tb[g0:g1][idx],
                                              tr.kernel[g0:g1][idx]))
                solo[t].feedback(PM.Outcomes(was_evicted=np.zeros(len(idx), bool), fault_count=fc))
    for t in (0, 1):
        m, s = mux.managers[t], solo[t]
        assert m.top1 == s.top1 and m.per_group == s.per_group and m.n_predictions == s.n_predictions > 0
        assert m.vocab.table == s.vocab.table and m._flush_interval == s._flush_interval
        assert torch.equal(m.freq_table.dense(256), s.freq_table.dense(256))
        for slot, e in s.table.slots.items():
            assert all(torch.equal(e.params[k], m.table.slots[slot].params[k]) for k in e.params)


# --- run_ours on a tagged trace -------------------------------------------------------

TENANCY_KW = {"mux": dict(), "mux-shared": dict(shared_freq_table=True), "merged": dict(multi_tenant=False)}


@pytest.mark.parametrize("pair", [("StreamTriad", "Hotspot"), ("ATAX", "Srad-v2")], ids="+".join)
@pytest.mark.parametrize("tenancy", list(TENANCY_KW))
def test_tagged_run_ours_frozen_matches_jax(tenancy, pair):
    tj, tp = _merges(pair, seed=0, slice_len=G)
    tc = dict(group_size=G, epochs=0, batch_size=64)
    jtable, ptable = _tables()
    jr = JR.run_ours(tj, JC.SMOKE, JI.TrainConfig(**tc), table=jtable, **TENANCY_KW[tenancy])
    pr = PR.run_ours(tp, PC.SMOKE, PI.TrainConfig(**tc), table=ptable, device="cpu", **TENANCY_KW[tenancy])
    assert pr.stats == jr.stats
    assert (pr.top1, pr.warm_top1, pr.per_group_acc) == (jr.top1, jr.warm_top1, jr.per_group_acc)
    assert (pr.n_predictions, pr.n_classes, pr.n_models, pr.n_accesses) == \
        (jr.n_predictions, jr.n_classes, jr.n_models, jr.n_accesses)
    assert pr.per_tenant_top1 == jr.per_tenant_top1 and pr.per_tenant_stats == jr.per_tenant_stats
    assert (pr.per_tenant_top1 is None) == (tenancy == "merged") and pr.budgets is None
    assert sum(d["accesses"] for d in pr.per_tenant_stats.values()) == len(tp)
    assert pr.ipc() == jr.ipc()


@pytest.mark.parametrize("tenancy", list(TENANCY_KW))
def test_tagged_run_ours_fine_tuned_matches_jax(tenancy):
    tj, tp = (t.slice(0, 6 * G) for t in _merges(("StreamTriad", "Hotspot"), seed=0, slice_len=G))
    tc = dict(group_size=G, epochs=1, batch_size=64)
    jtable, ptable = _tables()
    build = JR.manager_for if tenancy == "merged" else JR.mux_for
    kw = {} if tenancy == "merged" else dict(shared_freq_table=tenancy == "mux-shared")
    jm = build(tj, JC.SMOKE, JI.TrainConfig(**tc), table=jtable, **kw)
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**tc), device="cpu")
    train_group, diffs = jm.trainer.train_group, []

    def both(entry, fs, n_active, *, in_et=None, use_lucir=False, rng=None):
        opt = None if entry.opt_state is None else PA.OptState(_to_port(entry.opt_state.m), _to_port(entry.opt_state.v))
        pe = PEntry(params=_to_port(entry.params), prev_params=_to_port(entry.prev_params), opt_state=opt,
                    step=entry.step, n_updates=entry.n_updates)
        out = train_group(entry, fs, n_active, in_et=in_et, use_lucir=use_lucir, rng=rng)
        pt.train_group_many([pe], [fs], [n_active], in_et_list=[in_et], use_lucir=use_lucir)
        assert (pe.step, pe.n_updates) == (out.step, out.n_updates)
        diffs.append(_max_diff(out.params, pe.params))
        return out

    jm.trainer.train_group = both
    jr = JR.run_ours(tj, JC.SMOKE, JI.TrainConfig(**tc), manager=jm)
    assert len(diffs) >= 5 and max(diffs) <= GROUP_ATOL, diffs
    pr = PR.run_ours(tp, PC.SMOKE, PI.TrainConfig(**tc), table=ptable, device="cpu", **TENANCY_KW[tenancy])
    assert (pr.n_predictions, pr.n_classes, pr.n_models) == (jr.n_predictions, jr.n_classes, jr.n_models)
    assert {k: d["accesses"] for k, d in pr.per_tenant_stats.items()} == \
        {k: d["accesses"] for k, d in jr.per_tenant_stats.items()}
    assert abs(pr.top1 - jr.top1) <= RUN_TOP1_ATOL, (pr.top1, jr.top1)
    assert (pr.per_tenant_top1 or {}).keys() == (jr.per_tenant_top1 or {}).keys()


# --- evaluate_many and train_group_many -----------------------------------------------


def _lanes(n_lanes: int):
    """Feature groups of different lengths from several benchmarks (one of
    them empty), with a fresh slot's weights each."""
    out = []
    for i, (name, lo, hi) in enumerate((("Hotspot", 0, 450), ("ATAX", 100, 100), ("Srad-v2", 0, 300),
                                        ("StreamTriad", 300, 700))[:n_lanes]):
        vocab = JVocab(JC.SMOKE.delta_vocab)
        stream = JStream(JT.get_trace(name, 0.2), vocab, 10, page_vocab=64, pc_vocab=16, tb_vocab=16)
        fs = stream.windows(lo, hi)
        out.append((fs, max(vocab.n_classes, 2), INIT[i + 1]))
    return out


@pytest.mark.parametrize("n_lanes", [2, 4])
def test_evaluate_many_matches_jax(n_lanes):
    lanes = _lanes(n_lanes)
    jt = JI.Trainer(JC.SMOKE, JI.TrainConfig())
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(), device="cpu")
    want = jt.evaluate_many([{k: jnp.asarray(v) for k, v in p.items()} for _, _, p in lanes],
                            [fs for fs, _, _ in lanes], [na for _, na, _ in lanes])
    got = pt.evaluate_many([convert.params_from_jax(p, "cpu") for _, _, p in lanes], [fs for fs, _, _ in lanes],
                           [na for _, na, _ in lanes])
    assert len(got) == n_lanes and len(got[1][0]) == 0
    for (jc, jp), (pc, pp) in zip(want, got):
        assert pc.dtype == jc.dtype and pp.dtype == jp.dtype
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pp, jp)


@pytest.mark.parametrize("n_lanes", [2, 4])
def test_train_group_many_matches_jax(n_lanes):
    """Lanes with and without a LUCIR target and E∪T flags, one empty: at 2
    lanes the JAX package trains them one by one, at 4 it vmaps a bucket."""
    lanes = _lanes(n_lanes)
    tc = dict(group_size=2048, epochs=1, batch_size=64)
    jt = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc))
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**tc), device="cpu")
    rng = np.random.default_rng(3)
    flags = [rng.random(len(fs)) < 0.3 if i % 2 == 0 else None for i, (fs, _, _) in enumerate(lanes)]
    prev = [INIT[6] if i != 2 else None for i in range(n_lanes)]
    je = [JEntry(params={k: jnp.asarray(v) for k, v in p.items()},
                 prev_params=None if q is None else {k: jnp.asarray(v) for k, v in q.items()}, step=5)
          for (_, _, p), q in zip(lanes, prev)]
    pe = [PEntry(params=convert.params_from_jax(p, "cpu"), prev_params=None if q is None else
                 convert.params_from_jax(q, "cpu"), step=5) for (_, _, p), q in zip(lanes, prev)]
    args = ([fs for fs, _, _ in lanes], [na for _, na, _ in lanes])
    jt.train_group_many(je, *args, in_et_list=flags, use_lucir=True)
    assert pt.train_group_many(pe, *args, in_et_list=flags, use_lucir=True) is pe
    for i, (j, p) in enumerate(zip(je, pe)):
        assert (p.step, p.n_updates) == (j.step, j.n_updates)
        assert (p.opt_state is None) == (j.opt_state is None)
        if i == 1:  # the empty lane: untouched on both sides
            assert (p.step, p.n_updates, p.opt_state) == (5, 0, None)
            continue
        assert p.step > 5 and _max_diff(j.params, p.params) <= TRAIN_ATOL
    # the lanes one by one through the port's serial train_group, bit for bit
    serial = [PEntry(params=convert.params_from_jax(p, "cpu"), prev_params=None if q is None else
                     convert.params_from_jax(q, "cpu"), step=5) for (_, _, p), q in zip(lanes, prev)]
    for e, fs, na, f in zip(serial, *args, flags):
        pt.train_group(e, fs, na, in_et=f, use_lucir=True)
    for a, b in zip(serial, pe):
        assert a.step == b.step and all(torch.equal(a.params[k], b.params[k]) for k in a.params)


# --- the runner's Tables VII and VIII -------------------------------------------------------


class _JaxConcurrentContext:
    """What ``benchmarks/tables.py``'s ``table7`` and ``table8`` read of a
    ``Session``, from the JAX package's primitives at ``SMOKE``."""

    def __init__(self, scale, cap, tcfg, table, table7):
        self.scale, self.cap, self.tcfg, self.table, self.table7 = scale, cap, tcfg, table, table7
        self.default_pretrain = PretrainSpec(scale=0.6)
        self.trainer = JI.Trainer(JC.SMOKE, tcfg)

    def concurrent(self, tenants, *, slice_len=256, seed=0):
        return JT.concurrent(_parts(JT, tenants, self.scale, self.cap), seed=seed, slice_len=slice_len)

    def protocol(self, w, mode, pretrain=None):
        table = (self.table7.clone() if pretrain is not None
                 else JModelTable(lambda s: self.trainer.new_params(s), n_slots=self.tcfg.table_slots))
        return JI.run_protocol(w, JC.SMOKE, self.tcfg, mode=mode, table=table)

    def ours(self, w, tenancy="mux"):
        return JR.run_ours(w, JC.SMOKE, self.tcfg, table=self.table.clone(),
                           multi_tenant=False if tenancy == "merged" else None,
                           shared_freq_table=tenancy == "mux-shared")


def test_tables_7_and_8_match_jax(monkeypatch, tmp_path, capsys):
    """Tables VII and VIII at a tiny scale, frozen, from the SMOKE memo
    (Table VII's ``ours`` from a second copy of it): the port's rows equal
    the reference's row for row."""
    monkeypatch.setattr(BC, "OUT_DIR", tmp_path)  # the reference tables' CSVs
    scale, cap = 0.25, 2500
    tc = dict(group_size=G, epochs=0, batch_size=64)
    jtable, ptable = _tables()
    jctx = _JaxConcurrentContext(scale, cap, JI.TrainConfig(**tc), jtable, jtable)
    pctx = PTAB.Context("quick", table=ptable, table7=ptable.clone(), fresh=INIT, device="cpu")
    pctx.pcfg, pctx.scale, pctx.cap = PC.SMOKE, scale, cap
    pctx = pctx.with_train(PI.TrainConfig(**tc))
    for name in ("table7", "table8"):
        try:
            want = getattr(JTAB, name)(jctx)
        except AssertionError as exc:  # Table VIII's pin, on both sides
            with pytest.raises(AssertionError, match="avg mux gain"):
                getattr(PTAB, name)(pctx)
            want = str(exc)
            continue
        assert getattr(PTAB, name)(pctx) == want, name
    out = capsys.readouterr().out
    assert "table7_multiworkload," in out and "table8_concurrent_mux," in out
    w = pctx.concurrent(PTAB.CONCURRENT_PAIRS[0], slice_len=G)
    assert pctx.ours(w) is pctx.ours(w, tenancy="mux") and pctx.ours(w, tenancy="mux-shared").per_tenant_top1
    with pytest.raises(ValueError, match="tenancy"):
        pctx.ours(w, tenancy="split")


def test_runner_names_the_concurrent_tables():
    assert {"table7", "table8"} <= set(PTAB.TABLES)
    assert [list(p) for p in PTAB.CONCURRENT_PAIRS] == [["StreamTriad", "2DCONV"], ["Hotspot", "Srad-v2"],
                                                         ["NW", "2DCONV"], ["ATAX", "Srad-v2"]]
    ctx = PTAB.Context("quick", device="cpu")
    assert PTAB.QUICK_TABLE_S321.name == "pretrain_quick_s321.npz"
    assert sorted(ctx.pretrained("table7").slots) == [0, 3]
    paper = PTAB.Context("paper", device="cpu")
    w = paper.concurrent(("NW", "2DCONV"), slice_len=2048)
    assert len(w) == len(paper.trace("NW")) + len(paper.trace("2DCONV")) and w.tenant_names == ("NW", "2DCONV")
    assert paper.concurrent(("NW", "2DCONV"), slice_len=2048) is w
