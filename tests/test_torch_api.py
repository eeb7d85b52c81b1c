"""The port's experiment API (``repro_torch.uvm.api``) against the JAX
package's, on the CPU: every spec's content key, JSON and reconstruction,
the run store (either package reads the other's records), and a tiny
``SMOKE`` ``Session`` against the JAX package's.

Tolerances, each with its reason:

* keys, JSON, records, simulator and UVMSmart cells, frozen ``ours``
  (``epochs=0``: every float is a forward of the same weights), counters of
  the cache: equal, character for character or bit for bit;
* a fine-tuned ``ours`` or protocol: top-1 within ``RUN_TOP1_ATOL`` 0.02
  and the integers the trace alone decides equal, the limits of
  ``tests/test_torch_multi.py`` (each framework's trainer rounds its float32
  sums its own way, and the online loop feeds its predictions back).

Both sessions start every ``ours`` from the same ``SMOKE`` pretrain memo,
moments and all (``tests/test_torch_run_many.py``'s ``smoke_tables``).
"""
from __future__ import annotations

import dataclasses
import os

import pytest
import torch

import repro.uvm.api as J
import repro_torch.uvm.api as P
from repro.configs import predictor_paper as JC
from repro.uvm import registry as JREG
from repro.uvm.sweeps import EQUIV_CELLS as J_EQUIV
from repro_torch.configs import predictor_paper as PC
from repro_torch.uvm import registry as PREG
from repro_torch.uvm import runtime as PRUN
from repro_torch.uvm.api import session as PSESS
from repro_torch.uvm.sweeps import EQUIV_CELLS as P_EQUIV

from test_torch_multi import RUN_TOP1_ATOL
from test_torch_run_many import smoke_tables

SCALE, CAP = 0.1, 768
TRAIN = dict(group_size=256, epochs=1, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread keeps this module from
    oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- specs ---------------------------------------------------------------------


def _specs(A, C) -> list:
    """The same specs built through one package's API (``A``) and configs
    (``C``): every class, nested models at the three widths, pretrain
    recipes (one computed as the session computes it), QoS tiers, phase and
    churn drift, a concurrent workload and an experiment with extra cells."""
    w = A.WorkloadSpec("ATAX", 0.4, 6000)
    conc = A.WorkloadSpec.concurrent(("StreamTriad", "2DCONV"), scale=1.0, cap=60_000, slice_len=2048)
    drift = A.WorkloadSpec.drifting(("StreamTriad", "PtrChase"), switch="gradual", mix_window=64)
    churn = A.WorkloadSpec.drifting(("StreamTriad", "2DCONV"), kind="churn", joins=(0, 512), spans=(0, 1024))
    qos = A.QosSpec(tiers=(A.QosTierSpec("StreamTriad", floor=0.3), A.QosTierSpec("2DCONV", 0.1, 2.0)),
                    stability="gmr", interval=2)
    paper_train = A.TrainSpec(group_size=2048, epochs=3, batch_size=256)
    models = [
        A.ModelSpec(),
        A.ModelSpec(predictor=C.CONFIG, train=paper_train, pretrain=A.PretrainSpec(scale=1.0 * 0.6)),
        A.ModelSpec(predictor=C.SMOKE, train=A.TrainSpec(**TRAIN), pretrain=A.PretrainSpec(scale=0.4 * 0.6),
                    tenancy="mux-shared", reclass_interval=64, health=True, latency_budget_ms=2.5, qos=qos),
        A.ModelSpec(predictor=C.CONFIG_QUICK, kind="lstm", use_thrash_term=False, use_lucir=False,
                    pretrain=A.PretrainSpec(benchmarks=("ATAX", "NW"), scale=0.15, seed0=123, max_rounds=1),
                    tenancy="merged"),
    ]
    cells = [
        A.CellSpec(w),
        A.CellSpec(w, "sim", A.PolicySpec("hpe"), A.PrefetchSpec("demand"), 1.5, None, 3),
        A.CellSpec(conc, "ours", A.PolicySpec("learned"), A.PrefetchSpec("none"), 1.25, models[2]),
        A.CellSpec(drift, "uvmsmart", A.PolicySpec("adaptive"), A.PrefetchSpec("adaptive"), 2.0),
    ]
    exp = A.ExperimentSpec(name="x", workloads=(w, conc, churn), strategy="ours", oversubscriptions=(1.25, 1.5),
                           model=models[1], seed=1, extra_cells=tuple(cells))
    sim_exp = A.ExperimentSpec(workloads=(w, drift), policies=(A.PolicySpec("lru"), A.PolicySpec("belady")),
                               prefetchers=(A.PrefetchSpec("tree"), A.PrefetchSpec("demand")), extra_cells=(cells[3],))
    return [w.drift, drift.drift, churn.drift, w, conc, drift, churn, A.PolicySpec(), A.PrefetchSpec("demand"),
            A.TrainSpec(), paper_train, A.PretrainSpec(), *qos.tiers, qos, *models, *cells,
            A.ProtocolSpec(w, "ours", models[1], prior=(w.key, conc.key)), A.ProtocolSpec(drift, "offline"),
            exp, sim_exp]


def test_every_spec_key_and_json_equal_the_jax_package_s():
    jspecs, pspecs = _specs(J, JC), _specs(P, PC)
    assert jspecs[0] is None and pspecs[0] is None
    for j, p in zip(jspecs[1:], pspecs[1:]):
        kind = type(j).__name__
        assert type(p).__name__ == kind
        assert p.key == j.key, kind
        assert p.to_json() == j.to_json(), kind
        assert P.spec_key(p) == J.spec_key(j)
        # each package rebuilds the other's payload to the same spec
        assert P.spec_from_dict(kind, j.to_dict()) == p and J.spec_from_dict(kind, p.to_dict()) == j
        assert type(p).from_json(j.to_json()).key == j.key
    kinds = {type(s).__name__ for s in pspecs[1:]}
    assert kinds == set(P.specs._SPEC_KINDS)
    for j, p in zip(jspecs[-2:], pspecs[-2:]):
        assert [c.key for c in p.cells()] == [c.key for c in j.cells()]
        assert len(p.cells()) == len(j.cells()) > len(j.extra_cells)


def test_session_recipes_and_presets_equal_the_jax_package_s(tmp_path):
    """``default_pretrain`` computes 0.4 * 0.6 (not 0.24), as the reference
    does; the presets, the training schedule and ``parse_scale`` agree."""
    store = P.RunStore(tmp_path, enabled=False)
    assert P.Session(store=store, device="cpu").default_pretrain.key == J.Session(
        store=J.RunStore(tmp_path, enabled=False)).default_pretrain.key
    assert P.Session.paper(store=store, device="cpu").model.key == J.Session.paper(
        store=J.RunStore(tmp_path, enabled=False)).model.key
    assert (P.specs.SCALE_PRESETS, P.specs.PAPER_TRAIN.key, P.specs.SCHEMA) == \
        (J.specs.SCALE_PRESETS, J.specs.PAPER_TRAIN.key, J.specs.SCHEMA)
    for arg, cap in (("quick", None), ("paper", None), ("0.25", None), ("paper", 500)):
        assert P.specs.parse_scale(arg, cap) == J.specs.parse_scale(arg, cap)
    assert (P.ALL_BENCH, P.FEATURED, P.Session.STANDARD_CELLS) == (J.ALL_BENCH, J.FEATURED, J.Session.STANDARD_CELLS)
    with pytest.raises(ValueError, match="tenancy"):
        P.ModelSpec(tenancy="shared")
    with pytest.raises(ValueError, match="needs a ModelSpec"):
        P.CellSpec(P.WorkloadSpec("ATAX"), "ours")
    assert P.ModelSpec(health=True, latency_budget_ms=3.0).health_config().latency_budget_ms == 3.0


# --- the run store ---------------------------------------------------------------


def test_run_store_round_trip_torn_record_and_disabled(tmp_path, monkeypatch):
    store = P.RunStore(tmp_path / "runs")
    spec = P.CellSpec(P.WorkloadSpec("ATAX"))
    assert store.get(spec) is None
    p = store.put(spec, {"faults": 3})
    assert p == tmp_path / "runs" / spec.key[:2] / f"{spec.key}.json"
    assert store.get(spec) == {"faults": 3} and (store.hits, store.misses, store.writes) == (1, 1, 1)
    whole = p.read_text()
    for cut in (1, len(whole) // 2, len(whole) - 2):  # torn at any offset: a miss everywhere
        p.write_text(whole[:cut])
        assert store.get(spec) is None and list(store.records()) == []
    other = P.CellSpec(P.WorkloadSpec("BICG"))  # a record under the wrong key is not served
    store.put(other, {"faults": 9})
    os.replace(store.path(other.key), p)
    assert store.get(spec) is None
    assert store.put(spec, {"faults": 3}) == p  # the heal: a byte-identical record
    assert p.read_text() == whole and store.get(spec) == {"faults": 3}
    # a writer killed between its temporary file and the rename leaves a turd nobody adopts
    turd = p.with_suffix(".tmp.99999")
    turd.write_text('{"schema": 3, "key": "' + spec.key + '", "result": {"faults":')
    assert store.get(spec) == {"faults": 3} and [k for k, _ in store.records()] == [spec.key]
    assert store.put(spec, {"faults": 4}) == p and store.get(spec) == {"faults": 4} and turd.exists()
    # disabled: by argument, and by the reference's environment switch
    off = P.RunStore(tmp_path / "off", enabled=False)
    assert off.put(spec, {"x": 1}) is None and off.get(spec) is None
    monkeypatch.setenv("REPRO_RUN_STORE", "0")
    assert P.RunStore(tmp_path / "off").put(spec, {"x": 1}) is None and not (tmp_path / "off").exists()
    assert str(P.RunStore().root) == os.path.join("experiments", "runs_torch")


def test_run_store_records_cross_packages(tmp_path):
    """A record written by either package's store is read by the other's
    at the same key, byte-identical files for equal payloads."""
    jstore, pstore = J.RunStore(tmp_path / "j"), P.RunStore(tmp_path / "p")
    jspec = J.CellSpec(J.WorkloadSpec("NW", 0.25, 1500), "sim", J.PolicySpec("hpe"), J.PrefetchSpec("tree"))
    pspec = P.CellSpec(P.WorkloadSpec("NW", 0.25, 1500), "sim", P.PolicySpec("hpe"), P.PrefetchSpec("tree"))
    payload = {"pages_thrashed": 16, "faults": 2, "migrated_blocks": 3, "zero_copy": 0, "occupancy": 3}
    jp, pp = jstore.put(jspec, payload), pstore.put(pspec, payload)
    assert jp.read_bytes() == pp.read_bytes()
    assert P.RunStore(tmp_path / "j").get(pspec) == payload == J.RunStore(tmp_path / "p").get(jspec)
    assert [k for k, _ in P.RunStore(tmp_path / "j").records()] == [jspec.key]


# --- Session against the JAX package's -------------------------------------------------


def _plain_json(x) -> bool:
    """Whether ``x`` holds Python ints, floats, strings, bools, None, lists
    and dicts only (a numpy scalar would make the store's ``json.dumps``
    raise, or print other digits)."""
    if isinstance(x, dict):
        return all(isinstance(k, str) and _plain_json(v) for k, v in x.items())
    if isinstance(x, list):
        return all(_plain_json(v) for v in x)
    return type(x) in (int, float, str, bool, type(None))


def _sessions(tmp_path, name, train=TRAIN):
    """A JAX and a port session on stores of their own, both at SMOKE and
    both handed clones of the same pretrained table by ``pretrained``."""
    jtable, ptable = smoke_tables()
    js = J.Session(scale=SCALE, cap=CAP, store=J.RunStore(tmp_path / f"{name}_j"),
                   model=J.ModelSpec(predictor=JC.SMOKE, train=J.TrainSpec(**train)))
    ps = P.Session(scale=SCALE, cap=CAP, store=P.RunStore(tmp_path / f"{name}_p"), device="cpu",
                   model=P.ModelSpec(predictor=PC.SMOKE, train=P.TrainSpec(**train)))
    js.pretrained = lambda pspec=None, **kw: jtable.clone()
    ps.pretrained = lambda pspec=None, **kw: ptable.clone()
    return js, ps


def _sim_experiment(A):
    return A.ExperimentSpec(
        workloads=(A.WorkloadSpec("ATAX", SCALE, CAP), A.WorkloadSpec("Hotspot", SCALE, CAP),
                   A.WorkloadSpec.concurrent(("ATAX", "NW"), scale=SCALE, cap=CAP)),
        policies=(A.PolicySpec("lru"), A.PolicySpec("hpe"), A.PolicySpec("belady")),
        prefetchers=(A.PrefetchSpec("demand"), A.PrefetchSpec("tree")), oversubscriptions=(1.25, 1.5),
        extra_cells=(A.CellSpec(A.WorkloadSpec("NW", SCALE, CAP), "uvmsmart", A.PolicySpec("adaptive"),
                                A.PrefetchSpec("adaptive"), 1.5),))


def test_session_sweep_uvmsmart_and_the_cache_across_sessions(tmp_path):
    js, ps = _sessions(tmp_path, "a")
    jexp, pexp = _sim_experiment(J), _sim_experiment(P)
    assert pexp.key == jexp.key
    want, got = js.sweep(jexp), ps.sweep(pexp)
    assert got == want and len(got) == 3 * 3 * 2 * 2 + 1
    assert all(_plain_json(r) for r in got)
    assert ps.counters == {"memory_hits": 0, "store_hits": 0, "computed": len(got)}
    assert ps.uvmsmart("ATAX") == js.uvmsmart("ATAX")
    assert P_EQUIV == J_EQUIV and ps.sims("NW", P_EQUIV) == js.sims("NW", J_EQUIV)  # the equivalence matrix
    assert ps.sim("BICG", "lru", "tree") == js.sim("BICG", "lru", "tree")
    # a second session on the same store computes nothing; the JAX package's store serves the port too
    for store in (P.RunStore(tmp_path / "a_p"), P.RunStore(tmp_path / "a_j")):
        again = P.Session(scale=SCALE, cap=CAP, store=store, device="cpu")
        assert again.sweep(pexp) == want
        assert again.counters == {"memory_hits": 0, "store_hits": len(got), "computed": 0}
        again.sweep(pexp)
        assert again.counters["memory_hits"] == len(got)


def test_random_and_plugin_cells_are_not_persisted(tmp_path):
    ps = P.Session(scale=SCALE, cap=CAP, store=P.RunStore(tmp_path / "runs"), device="cpu")
    with PREG.scoped():
        PREG.register_policy("mru", lambda st, i, t: (-st.last_access,))
        ps.sims("ATAX", [("random", "demand", 1.25), ("lru", "demand", 1.25), ("mru", "demand", 1.25)])
        assert ps.counters["computed"] == 3
        names = [rec["spec"]["policy"]["name"] for _, rec in ps.store.records()]
        assert names == ["lru"]
        again = P.Session(scale=SCALE, cap=CAP, store=P.RunStore(tmp_path / "runs"), device="cpu")
        again.sims("ATAX", [("random", "demand", 1.25), ("mru", "demand", 1.25)])
        assert again.counters["computed"] == 2
    with JREG.scoped():  # the reference's rule, for the same cells
        JREG.register_policy("mru", lambda st, i, t: (-st.last_access,))
        cells = [P.CellSpec(P.WorkloadSpec("ATAX"), "sim", P.PolicySpec(n), P.PrefetchSpec("demand"))
                 for n in ("random", "lru", "mru")]
        assert [P.Session._persistable(c) for c in cells] == [J.Session._persistable(
            J.CellSpec.from_json(c.to_json())) for c in cells]


@pytest.mark.parametrize("epochs", [0, 1])
def test_session_ours_against_the_jax_package(tmp_path, epochs):
    """Frozen ``ours`` equal, fine-tuned within the limits, a tagged
    workload through the mux; a second session serves them from its store
    bit for bit, and the payload is plain JSON."""
    js, ps = _sessions(tmp_path, f"o{epochs}", train={**TRAIN, "epochs": epochs})
    names = ["Hotspot", "ATAX", ("StreamTriad", "2DCONV")]
    jw = [n if isinstance(n, str) else js.concurrent(n) for n in names]
    pw = [n if isinstance(n, str) else ps.concurrent(n) for n in names]
    want = js.sweep([js.ours_cell(w) for w in jw])
    got = ps.sweep([ps.ours_cell(w) for w in pw])
    assert [c.key for c in (ps.ours_cell(w) for w in pw)] == [c.key for c in (js.ours_cell(w) for w in jw)]
    for w, j, p in zip(names, want, got):
        if epochs == 0:
            assert dataclasses.asdict(p) == dataclasses.asdict(j), w
        else:
            assert abs(p.top1 - j.top1) <= RUN_TOP1_ATOL, (w, p.top1, j.top1)
            assert (p.n_predictions, p.n_classes, p.n_models, p.n_accesses) == \
                (j.n_predictions, j.n_classes, j.n_models, j.n_accesses), w
    assert got[2].per_tenant_top1 is not None
    again = P.Session(scale=SCALE, cap=CAP, store=P.RunStore(tmp_path / f"o{epochs}_p"), device="cpu",
                      model=ps.model)
    assert [dataclasses.asdict(r) for r in again.sweep([again.ours_cell(w) for w in pw])] == \
        [dataclasses.asdict(r) for r in got]
    assert again.counters["store_hits"] == 3
    for _, rec in ps.store.records():
        assert _plain_json(rec["result"])
    # the cell equals a direct run_ours from the same table
    direct = PRUN.run_ours(ps.trace("Hotspot"), PC.SMOKE, ps.tcfg, table=ps.pretrained(), device="cpu")
    assert dataclasses.asdict(direct) == dataclasses.asdict(got[0])


def test_protocols_and_chain_cached_link_by_link(tmp_path):
    """From fresh weights (each package draws its own) and through a shared
    table: top-1 within the limits; the chain is served from the store only
    when every link hits, and another prefix is another spec."""
    js, ps = _sessions(tmp_path, "p")
    for mode in ("online_single", "online_multi"):
        j, p = js.protocol("ATAX", mode), ps.protocol("ATAX", mode)
        assert abs(p.top1 - j.top1) <= RUN_TOP1_ATOL and (p.n_samples, p.n_models) == (j.n_samples, j.n_models)
    pre = dict(scale=0.06, seed0=123, benchmarks=("ATAX", "Hotspot"))
    jchain = js.protocol_chain(["ATAX", "Hotspot"], "ours", pretrain=J.PretrainSpec(**pre))
    pchain = ps.protocol_chain(["ATAX", "Hotspot"], "ours", pretrain=P.PretrainSpec(**pre))
    for j, p in zip(jchain, pchain):
        assert abs(p.top1 - j.top1) <= RUN_TOP1_ATOL and p.n_samples == j.n_samples
    again = P.Session(scale=SCALE, cap=CAP, store=P.RunStore(tmp_path / "p_p"), device="cpu", model=ps.model)
    again.pretrained = ps.pretrained
    assert [r.top1 for r in again.protocol_chain(["ATAX", "Hotspot"], "ours", pretrain=P.PretrainSpec(**pre))] == \
        [r.top1 for r in pchain]
    assert again.counters == {"memory_hits": 0, "store_hits": 2, "computed": 0}
    assert all(_plain_json(rec["result"]) for _, rec in ps.store.records())
    again.protocol_chain(["Hotspot", "ATAX"], "ours", pretrain=P.PretrainSpec(**pre))
    assert again.counters["computed"] == 2


def test_pretrained_loads_the_committed_tables(tmp_path):
    """At the paper preset the recipe's table is the committed export (params
    and moments); at the quick preset the JAX package's memo; each use a
    clone."""
    store = P.RunStore(tmp_path, enabled=False)
    ps = P.Session.paper(store=store, device="cpu")
    got = ps.pretrained()
    want = PRUN.load_pretrained(PSESS.PAPER_TABLES[777], PC.CONFIG, "cpu")
    assert sorted(got.slots) == sorted(want.slots)
    for s, e in want.slots.items():
        assert all(torch.equal(got.slots[s].params[k], v) for k, v in e.params.items())
        assert all(torch.equal(got.slots[s].opt_state.m[k], v) for k, v in e.opt_state.m.items())
    got.slots[next(iter(got.slots))].params = {}
    assert ps.pretrained().slots[next(iter(got.slots))].params  # the master is untouched
    quick = P.Session(store=store, device="cpu").pretrained()
    memo = PSESS.MEMO_DIR / "pretrain_0e86a9ef3a27bb0d.pkl"
    ref = PRUN.load_pretrain_memo(memo, PC.CONFIG_QUICK, "cpu")
    assert sorted(quick.slots) == sorted(ref.slots)
    assert all(torch.equal(quick.slots[s].params[k], v) for s, e in ref.slots.items() for k, v in e.params.items())


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Session()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Session.paper()
