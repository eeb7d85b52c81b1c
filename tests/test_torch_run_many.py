"""The port's many-lane runners against serial runs and the JAX package's
lockstep, on the CPU: ``simulator.run_segments_many`` lane by lane (an empty lane, a lane
whose periodic aggregate faults and reruns on plain run-length events, a
lane with a QoS leading victim key), and ``runtime.run_ours_many``.

Tolerances, each with its reason:

* ``run_segments_many`` and ``run_ours_many`` against the port's own
  single-lane entry points: equal, bit for bit (the lanes run one after
  another through the same code);
* against the JAX package: every simulator lane, and every frozen run
  (``epochs=0``: each float is a forward of the same weights), equal;
  a fine-tuned run within ``tests/test_torch_multi.py``'s limits (top-1
  ``RUN_TOP1_ATOL`` 0.02, the integers the trace alone decides equal).
  The JAX package's lockstep runs 2 lanes one by one and vmaps 4; each
  comparison is made where its lockstep run equals its own serial runs.

The tables are the ``SMOKE`` pretrain memo on both sides, AdamW moments
and all (fine-tuning from unset moments on one side lands a group's
accuracy 0.07 away), the port's fresh slots from the JAX package's initial
weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.uvm import runtime as JR
from repro.uvm import simulator as JS
from repro.uvm import trace as JT
from repro.uvm.api.specs import QosSpec as JQosSpec
from repro.uvm.api.specs import QosTierSpec as JQosTierSpec
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.uvm import runtime as PRUN
from repro_torch.uvm import simulator as PS
from repro_torch.uvm import trace as PT
from repro_torch.uvm.api.specs import QosSpec, QosTierSpec

from test_torch_multi import INIT, RUN_TOP1_ATOL
from test_torch_runtime import SMOKE_MEMO
from test_torch_simulator import _assert_state_equal

SCALE, CAP, G = 0.2, 768, 256
FROZEN = dict(group_size=G, epochs=0, batch_size=64)
TUNED = dict(group_size=G, epochs=1, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread keeps this module from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(module, name, scale=SCALE, cap=CAP):
    tr = module.get_trace(name, scale)
    return tr.slice(0, min(len(tr), cap))


def _merge(module, names, seed=0):
    return module.concurrent([_cut(module, n) for n in names], seed=seed, slice_len=G)


# --- run_segments_many ------------------------------------------------------------


def _segment_lanes(module):
    """Four lanes: a plain segment (lru), an empty one, one whose periodic
    aggregates fault (StreamTriad's first half at a tiny capacity), and one
    under the learned policy with a leading victim key."""
    atax, st, hot = module.get_trace("ATAX", 0.25), module.get_trace("StreamTriad", 0.25), module.get_trace("Hotspot", 0.1)
    lanes = []
    for tr, lo, hi, pol, cap in ((atax, 0, 1500, "lru", None), (atax, 0, 0, "hpe", None),
                                 (st, 0, len(st) // 2, "lru", "tiny"), (hot, 0, 2048, "learned", None)):
        nb = PS.bucket_blocks(tr.n_blocks)
        c = 2 if cap == "tiny" else PS.capacity_for(tr.n_blocks, 1.25)
        nxt = (JS if module is JT else PS).next_use_for(tr)
        lanes.append((tr, nb, c, pol, tr.block[lo:hi].astype(np.int32), nxt[lo:hi]))
    return lanes


def _ep(nb: int) -> np.ndarray:
    return np.random.default_rng(5).integers(-1, 2, nb).astype(np.int32)


def test_run_segments_many_equals_run_segment_and_jax():
    planes, jlanes = _segment_lanes(PT), _segment_lanes(JT)
    states = [PS.init_state(nb, "cpu") for _, nb, *_ in planes]
    eps = [None, None, None, torch.tensor(_ep(planes[3][1]))]
    cells = [(pol, "demand", cap) for _, _, cap, pol, _, _ in planes]
    calls = []
    scan = PS._scan_events

    def counting(state, ev, *a):
        calls.append(len(ev.blk))
        return scan(state, ev, *a)

    PS._scan_events = counting
    try:
        many = PS.run_segments_many(states, [(b, n) for *_, b, n in planes], cells,
                                    [tr.n_blocks for tr, *_ in planes], evict_prefs=eps)
    finally:
        PS._scan_events = scan
    assert len(calls) == 4  # three non-empty lanes, one of them rerun on plain run-length events
    for (tr, nb, cap, pol, b, n), st, ep, (got_st, got) in zip(planes, states, eps, many):
        want_st, want = PS.run_segment(st, b, n, capacity=cap, policy=pol, prefetch="demand", n_valid=tr.n_blocks,
                                       evict_pref=ep)
        for k in ("fault", "thrash", "was_evicted"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert [getattr(got_st, f.name).tolist() for f in dataclasses.fields(got_st)] == \
            [getattr(want_st, f.name).tolist() for f in dataclasses.fields(want_st)]
    assert len(many[1][1]["fault"]) == 0 and many[1][0] is states[1]
    # the JAX package vmaps these four lanes in one bucket where their shapes agree
    jstates = [JS.init_state(nb) for _, nb, *_ in jlanes]
    jcells = [(JS.POLICY_IDS[pol], JS.PREFETCH_IDS[pf], cap) for pol, pf, cap in cells]
    jmany = JS.run_segments_many(jstates, [(b, n) for *_, b, n in jlanes], jcells,
                                 [tr.n_blocks for tr, *_ in jlanes], evict_prefs=[None, None, None, _ep(jlanes[3][1])])
    for (js, jo), (ps, po) in zip(jmany, many):
        _assert_state_equal(js, ps)
        for k in ("fault", "thrash", "was_evicted"):
            np.testing.assert_array_equal(np.asarray(jo[k]), po[k], err_msg=k)


# --- run_ours_many ------------------------------------------------------------------


def _fields(res) -> dict:
    return dataclasses.asdict(res)


def smoke_tables():
    """The ``SMOKE`` memo as a JAX table with every slot's moments, and the
    same table in the port (``convert.table_from_blob`` of its host form)."""
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig())
    jtable = JModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        jtable.slots[s] = JEntry(params=e["params"], prev_params=e["prev_params"], opt_state=e["opt_state"],
                                 step=e["step"], n_updates=e["n_updates"], last_acc=e["last_acc"])
    return jtable, convert.table_from_blob(JR._table_to_host(jtable), PC.SMOKE, "cpu", INIT)


@pytest.fixture(scope="module")
def tables():
    return smoke_tables()


LANES = ("ATAX", "NW", "Hotspot", "AddVectors")
PAIR, PAIR2 = ("StreamTriad", "2DCONV"), ("ATAX", "NW")


@pytest.mark.parametrize("train", ["frozen", "tuned"])
def test_run_ours_many_equals_serial_with_a_tagged_lane(tables, train):
    """Five lanes, one of them a tenant-tagged merge (through a TenantMux),
    each equal to its own serial run_ours bit for bit."""
    _, ptable = tables
    tcfg = PI.TrainConfig(**(FROZEN if train == "frozen" else TUNED))
    traces = [_cut(PT, n) for n in LANES] + [_merge(PT, PAIR)]
    many = PRUN.run_ours_many(traces, PC.SMOKE, tcfg, tables=[ptable.clone() for _ in traces], device="cpu")
    for tr, got in zip(traces, many):
        want = PRUN.run_ours(tr, PC.SMOKE, tcfg, table=ptable.clone(), device="cpu")
        assert _fields(got) == _fields(want), tr.name
    assert many[-1].per_tenant_top1 is not None and many[0].per_tenant_top1 is None
    assert any(r.n_predictions for r in many)


@pytest.mark.parametrize("train", ["frozen", "tuned"])
def test_run_ours_many_qos_over_two_tagged_lanes(tables, train):
    """qos= applies to every tagged lane, each with its own controller:
    equal to serial budgeted runs; an untagged lane raises."""
    _, ptable = tables
    tcfg = PI.TrainConfig(**(FROZEN if train == "frozen" else TUNED))
    qos = QosSpec(tiers=(QosTierSpec(PAIR[0], floor=0.3), QosTierSpec(PAIR2[1], floor=0.2, share=2.0)))
    traces = [_merge(PT, PAIR), _merge(PT, PAIR2, seed=1)]
    many = PRUN.run_ours_many(traces, PC.SMOKE, tcfg, tables=[ptable.clone() for _ in traces], qos=qos, device="cpu")
    for tr, got in zip(traces, many):
        want = PRUN.run_ours(tr, PC.SMOKE, tcfg, table=ptable.clone(), qos=qos, device="cpu")
        assert _fields(got) == _fields(want), tr.name
        assert got.budgets is not None
    with pytest.raises(ValueError, match="tenant-tagged"):
        PRUN.run_ours_many([_cut(PT, "ATAX")] + traces, PC.SMOKE, tcfg, qos=qos, device="cpu")


def _jax_many(jtable, traces, tcfg, **kw):
    return JR.run_ours_many(traces, JC.SMOKE, tcfg, tables=[jtable.clone() for _ in traces], **kw)


@pytest.mark.parametrize("n_lanes", [2, 4])
@pytest.mark.parametrize("train", ["frozen", "tuned"])
def test_run_ours_many_against_jax(tables, n_lanes, train):
    """2 lanes (the JAX package runs them one by one) and 4 (it vmaps them),
    one tagged under qos=None: frozen runs equal, fine-tuned ones within
    the limits, wherever the JAX lockstep run equals its serial runs."""
    jtable, ptable = tables
    names = LANES[: n_lanes - 1]
    jtraces = [_cut(JT, n) for n in names] + [_merge(JT, PAIR)]
    ptraces = [_cut(PT, n) for n in names] + [_merge(PT, PAIR)]
    kw = FROZEN if train == "frozen" else TUNED
    jmany = _jax_many(jtable, jtraces, JI.TrainConfig(**kw))
    pmany = PRUN.run_ours_many(ptraces, PC.SMOKE, PI.TrainConfig(**kw), tables=[ptable.clone() for _ in ptraces],
                             device="cpu")
    held = 0
    for jt, j, p in zip(jtraces, jmany, pmany):
        jserial = JR.run_ours(jt, JC.SMOKE, JI.TrainConfig(**kw), table=jtable.clone())
        if _fields(jserial) != _fields(j):
            continue  # the JAX package's vmapped lanes round apart from its serial run here
        held += 1
        if train == "frozen":
            assert _fields(p) == _fields(j), jt.name
        else:
            assert abs(p.top1 - j.top1) <= RUN_TOP1_ATOL, (jt.name, p.top1, j.top1)
            assert (p.n_predictions, p.n_classes, p.n_models, p.n_accesses) == \
                (j.n_predictions, j.n_classes, j.n_models, j.n_accesses), jt.name
    assert held >= n_lanes - 1


def test_run_ours_many_qos_against_jax(tables):
    """qos= over two tagged lanes, frozen: budgets and every field equal to
    the JAX package's lockstep run."""
    jtable, ptable = tables
    tiers = ((PAIR[0], 0.3, 1.0), (PAIR2[1], 0.2, 2.0))
    jq = JQosSpec(tiers=tuple(JQosTierSpec(t, floor=f, share=s) for t, f, s in tiers))
    pq = QosSpec(tiers=tuple(QosTierSpec(t, floor=f, share=s) for t, f, s in tiers))
    jmany = _jax_many(jtable, [_merge(JT, PAIR), _merge(JT, PAIR2, seed=1)], JI.TrainConfig(**FROZEN), qos=jq)
    pmany = PRUN.run_ours_many([_merge(PT, PAIR), _merge(PT, PAIR2, seed=1)], PC.SMOKE, PI.TrainConfig(**FROZEN),
                             tables=[ptable.clone(), ptable.clone()], qos=pq, device="cpu")
    for j, p in zip(jmany, pmany):
        assert _fields(p) == _fields(j)

