"""The port's fault-tolerance layer against the JAX package, on the CPU:
snapshots of the manager, the mux, the QoS controller and the KV offload
(``state``/``restore``, ``SnapshotStore``), a JAX snapshot carried into the
port (``convert.manager_state_from_jax``), the degraded-mode health
machine, the seeded chaos injector and the fault log.

Most cases run the same stub trainer (pure numpy, deterministic) under both
packages' managers, so every decision the manager makes is compared
exactly: prefetch and pre-evict blocks, dense counters, patterns,
accuracies, health states and fallbacks, and the health counters.  The
cases with the real predictor (``SMOKE``) are frozen (``epochs=0``) where
they compare a run, so every float is a forward of the same weights and
equal bit for bit; the fine-tuned snapshot case compares the restored
arrays, which are copies.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pickle
import types

import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.serving import offload as JO
from repro.uvm import manager as JM
from repro.uvm import runtime as JR
from repro.uvm import trace as JT
from repro.uvm.manager import core as JCore
from repro.uvm.qos import BudgetController as JBudget
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.serving import offload as PO
from repro_torch.uvm import manager as PM
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import trace as PT
from repro_torch.uvm.manager import core as PCore
from repro_torch.uvm.qos import BudgetController as PBudget

from test_torch_runtime import SMOKE_MEMO, _jax_table

SIDES = {"jax": (JM, JC, JI, {}), "port": (PM, PC, PI, {"device": "cpu"})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensors are small: one intra-op thread keeps its work
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the stub predictor stack (pure numpy: the plumbing under test is the manager's) ---


class _StubTrainer:
    def new_params(self, seed: int = 0):
        return np.zeros(1)

    def evaluate(self, params, fs, n_active: int):
        pred = fs.delta[:, -1] % max(n_active, 1)
        return pred == fs.label, pred

    def evaluate_many(self, params_list, fs_list, n_active_list):
        return [self.evaluate(p, f, n) for p, f, n in zip(params_list, fs_list, n_active_list)]

    def train_group(self, entry, fs, n_active, *, in_et=None, use_lucir=False, rng=None):
        entry.n_updates += 1
        return entry

    def train_group_many(self, entries, fs_list, n_active_list, *, in_et_list=None, use_lucir=False):
        for e in entries:
            e.n_updates += 1
        return entries


class _FlakyTrainer(_StubTrainer):
    """Raises on a scripted set of evaluate calls."""

    def __init__(self, fail_on=()):
        self.calls = 0
        self.fail_on = set(fail_on)

    def evaluate(self, params, fs, n_active: int):
        self.calls += 1
        if self.calls in self.fail_on:
            raise RuntimeError(f"flaky dispatch #{self.calls}")
        return super().evaluate(params, fs, n_active)

    def evaluate_many(self, params_list, fs_list, n_active_list):
        self.calls += 1
        if self.calls in self.fail_on:
            raise RuntimeError(f"flaky batched dispatch #{self.calls}")
        return [_StubTrainer.evaluate(self, p, f, n) for p, f, n in zip(params_list, fs_list, n_active_list)]


class _NaNTrainer(_StubTrainer):
    def evaluate(self, params, fs, n_active):
        return np.full(len(fs.label), np.nan), np.full(len(fs.label), np.nan)


class _TrainBomb(_StubTrainer):
    def train_group(self, entry, fs, n_active, **kw):
        raise RuntimeError("train boom")


def _cfg(side: str, **kw):
    M, C, I, _ = SIDES[side]
    kw.setdefault("predictor", C.SMOKE)
    kw.setdefault("train", I.TrainConfig(group_size=64, epochs=1, batch_size=32))
    kw.setdefault("n_pages", 1024)
    kw.setdefault("n_blocks", 64)
    kw.setdefault("capacity", 16)
    kw.setdefault("use_lucir", False)
    kw.setdefault("use_thrash_term", False)
    if isinstance(kw.get("health"), dict):
        kw["health"] = M.HealthConfig(**kw["health"])
    return M.ManagerConfig(**kw)


def _mgr(side: str, trainer=None, **kw):
    M, _, _, dev = SIDES[side]
    return M.OversubscriptionManager(_cfg(side, **kw), trainer=trainer or _StubTrainer(), **dev)


def _mux(side: str, trainer=None, qos=None, **kw):
    M, _, _, dev = SIDES[side]
    shared = kw.pop("shared", False)
    return M.TenantMux(_cfg(side, **kw), [0, 1], shared_freq_table=shared, auto_create=False,
                       trainer=trainer or _StubTrainer(), qos=qos, **dev)


def _actions(a) -> tuple:
    return (tuple(np.asarray(a.prefetch_blocks).tolist()), tuple(np.asarray(a.pre_evict_blocks).tolist()),
            None if a.counters is None else tuple(np.asarray(a.counters).tolist()),
            a.pattern, a.accuracy, a.warm, a.health, a.fallback)


def _drive(side: str, mgr, rng, rounds: int, clock_step: int = 128, start_clock: int = 0) -> list:
    """``rounds`` observe/feedback rounds of random pages; the decision
    stream (every action tuple)."""
    M = SIDES[side][0]
    out, clock = [], start_clock
    for _ in range(rounds):
        b = M.FaultBatch(rng.integers(0, 1024, 64))
        a = mgr.observe(b)
        clock += clock_step
        mgr.feedback(M.Outcomes(was_evicted=np.zeros(len(b), bool), fault_count=clock))
        out.append(_actions(a))
    return out


def _health(m) -> tuple:
    return m.n_health_faults, m.n_fallbacks, m.n_recoveries, m.health_state, m.last_health_error


def _no_tensor(obj, path="state") -> None:
    """Fail if a torch tensor sits anywhere in ``obj``, pickled blobs
    included (they must load without any class of ``torch``)."""

    class NoTorch(pickle.Unpickler):
        def find_class(self, module, name):
            assert module.split(".")[0] != "torch", f"{path}: pickles {module}.{name}"
            return super().find_class(module, name)

    assert not isinstance(obj, torch.Tensor), f"{path} is a tensor"
    if isinstance(obj, bytes):
        import io

        obj = NoTorch(io.BytesIO(obj)).load() if obj[:1] == b"\x80" else obj
        if not isinstance(obj, bytes):
            _no_tensor(obj.__getstate__() if hasattr(obj, "__getstate__") else obj, path + "<pickle>")
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_tensor(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_tensor(v, f"{path}[{i}]")


# --- manager snapshots ---------------------------------------------------------------


def test_stub_snapshot_split_at_round_5():
    """A 12-round drive split at round 5 (snapshot -> bytes -> a fresh
    manager) gives the uninterrupted stream, which is JAX's."""
    ref = _drive("jax", _mgr("jax"), np.random.default_rng(0), 12)
    whole = _mgr("port")
    assert _drive("port", whole, np.random.default_rng(0), 12) == ref
    m1, rng = _mgr("port"), np.random.default_rng(0)
    head = _drive("port", m1, rng, 5)
    m2 = _mgr("port")
    m2.restore(pickle.loads(pickle.dumps(m1.state())))
    assert head + _drive("port", m2, rng, 7, start_clock=5 * 128) == ref
    assert (m2.top1, m2.n_predictions, m2.vocab.table) == (whole.top1, whole.n_predictions, whole.vocab.table)
    assert torch.equal(m2.freq_table.tags, whole.freq_table.tags)
    np.testing.assert_array_equal(m2._chain_li, whole._chain_li)


def test_snapshot_rejects_pending_version_and_config_drift():
    m = _mgr("port")
    m.observe_begin(PM.FaultBatch(np.random.default_rng(1).integers(0, 1024, 64)))
    with pytest.raises(RuntimeError, match="pending"):
        m.state()
    m.observe_finish(None, None)
    m.feedback(PM.Outcomes(np.zeros(64, bool), 64))
    st = m.state()
    with pytest.raises(ValueError, match="version"):
        _mgr("port").restore(dict(st, version=PM.STATE_VERSION + 1))
    with pytest.raises(ValueError, match="different ManagerConfig"):
        _mgr("port", capacity=8).restore(st)
    pending = _mgr("port")
    pending.observe_begin(PM.FaultBatch(np.arange(64)))
    with pytest.raises(RuntimeError, match="pending"):
        pending.restore(st)
    # enabling the health machine on resume is legitimate: health is not signed
    healthy = _mgr("port", health={})
    healthy.restore(st)
    assert healthy.health_state == "healthy" and healthy.cfg.health is not None


@pytest.mark.parametrize("name", ["SMOKE", "CONFIG_QUICK", "CONFIG"])
def test_cfg_signature_is_the_references(name):
    """The config signature (what a snapshot is checked against) is the JAX
    package's digest for the same configuration."""
    for tcfg in ((2048, 0, 256), (64, 1, 32)):
        j = JM.ManagerConfig(predictor=getattr(JC, name), train=JI.TrainConfig(*tcfg), n_blocks=128, capacity=100)
        p = PM.ManagerConfig(predictor=getattr(PC, name), train=PI.TrainConfig(*tcfg), n_blocks=128, capacity=100)
        assert PCore._cfg_signature(p) == JCore._cfg_signature(j)
        assert PCore._cfg_signature(dataclasses.replace(p, health=PM.HealthConfig())) == PCore._cfg_signature(p)


def _smoke_trace(name="Hotspot", scale=0.4, cap=3000):
    j, p = JT.get_trace(name, scale), PT.get_trace(name, scale)
    return j.slice(0, min(len(j), cap)), p.slice(0, min(len(p), cap))


def _smoke_pair(tcfg):
    """A JAX and a port manager over Hotspot's geometry at ``SMOKE`` from the
    committed memo's table, the port's fresh slots from JAX's weights."""
    jtr, ptr = _smoke_trace()
    jtrainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(*tcfg))
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    fresh = {s: {k: np.asarray(v) for k, v in jtrainer.new_params(s).items()} for s in range(blob["n_slots"])}
    jm = JR.manager_for(jtr, JC.SMOKE, JI.TrainConfig(*tcfg), table=_jax_table(blob, jtrainer))
    pm = PR.manager_for(ptr, PC.SMOKE, PI.TrainConfig(*tcfg), device="cpu",
                        table=PR.load_pretrain_memo(SMOKE_MEMO, PC.SMOKE, "cpu", fresh=fresh))
    return jtr, ptr, jm, pm


def _feed(M, mgr, trace, groups, g_size):
    """Observe/feedback ``groups`` (indices) of ``trace``; the actions."""
    out = []
    for g in groups:
        g0, g1 = g * g_size, min((g + 1) * g_size, len(trace))
        a = mgr.observe(M.FaultBatch(trace.page[g0:g1], trace.pc[g0:g1], trace.tb[g0:g1], trace.kernel[g0:g1]))
        mgr.feedback(M.Outcomes(was_evicted=(trace.page[g0:g1] % 7 == 0), fault_count=40 * g1 // g_size))
        out.append(_actions(a))
    return out


def test_state_holds_no_tensor():
    """A port snapshot, fine-tuned so that moments and the LUCIR snapshot
    exist, holds no tensor and loads without any torch class; restoring it
    puts the model and the frequency table back on the manager's device."""
    _, ptr, _, pm = _smoke_pair((256, 1, 128))
    _feed(PM, pm, ptr, range(3), 256)
    assert any(e.opt_state is not None for e in pm.table.slots.values())
    st = pm.state()
    _no_tensor(st)
    m2 = PR.manager_for(ptr, PC.SMOKE, PI.TrainConfig(256, 1, 128), device="cpu")
    m2.restore(pickle.loads(pickle.dumps(st)))
    assert m2.freq_table.tags.dtype == torch.int32 and m2.freq_table.device.type == "cpu"
    for s, e in pm.table.slots.items():
        for k, v in e.params.items():
            assert torch.equal(m2.table.slots[s].params[k], v)


def test_jax_snapshot_continues_in_the_port_frozen():
    """A JAX manager's snapshot at round 5, carried across by
    ``convert.manager_state_from_jax``: the port's next rounds equal JAX's
    tail bit for bit (frozen model)."""
    tcfg = (256, 0, 128)
    jtr, ptr, jm, pm = _smoke_pair(tcfg)
    n = (len(jtr) + 255) // 256
    _feed(JM, jm, jtr, range(5), 256)
    jstate = pickle.loads(pickle.dumps(jm.state()))
    jtail = _feed(JM, jm, jtr, range(5, n), 256)
    pm.restore(convert.manager_state_from_jax(jstate, PC.SMOKE, "cpu"))
    assert pm.freq_table.tags.dtype == torch.int32
    ptail = _feed(PM, pm, ptr, range(5, n), 256)
    assert ptail == jtail
    assert (pm.top1, pm.warm_top1, pm.per_group, pm.n_predictions) == (jm.top1, jm.warm_top1, jm.per_group,
                                                                       jm.n_predictions)
    assert any(a[2] is not None for a in jtail)  # the gate opened: the frequency table carried across


def test_jax_snapshot_restores_params_and_moments_fine_tuned():
    """With fine-tuning, the restored params, moments and LUCIR snapshots
    equal the JAX snapshot's arrays bit for bit."""
    jtr, _, jm, _ = _smoke_pair((256, 1, 128))
    _feed(JM, jm, jtr, range(5), 256)
    jstate = jm.state()
    pm = PR.manager_for(_smoke_trace()[1], PC.SMOKE, PI.TrainConfig(256, 1, 128), device="cpu")
    pm.restore(convert.manager_state_from_jax(jstate, PC.SMOKE, "cpu"))
    n_opt = 0
    for s, e in jstate["table"]["slots"].items():
        pe = pm.table.slots[s]
        assert (pe.step, pe.n_updates, pe.last_acc) == (e["step"], e["n_updates"], e["last_acc"])
        for tree, ptree in ((e["params"], pe.params), (e["prev_params"], pe.prev_params)):
            if tree is not None:
                for k, v in tree.items():
                    np.testing.assert_array_equal(ptree[k].numpy(), np.asarray(v))
        if e["opt_state"] is not None:
            n_opt += 1
            for k in e["opt_state"].m:
                np.testing.assert_array_equal(pe.opt_state.m[k].numpy(), np.asarray(e["opt_state"].m[k]))
                np.testing.assert_array_equal(pe.opt_state.v[k].numpy(), np.asarray(e["opt_state"].v[k]))
    assert n_opt > 0
    # the continuation equals what the same state gives restored into a port snapshot and back
    again = PR.manager_for(_smoke_trace()[1], PC.SMOKE, PI.TrainConfig(256, 1, 128), device="cpu")
    again.restore(pickle.loads(pickle.dumps(pm.state())))
    assert again.vocab.table == jm.vocab.table and again._chain_li.tolist() == jm._chain_li.tolist()


@pytest.mark.parametrize("shared", [False, True])
def test_jax_mux_snapshot_continues_in_the_port(shared):
    """A JAX ``TenantMux`` snapshot (real ``SMOKE`` predictor, frozen)
    carried across by ``convert.mux_state_from_jax``: the port mux's next
    rounds equal JAX's tail bit for bit, per tenant."""
    tcfg = (256, 0, 128)
    parts = [("AddVectors", 900), ("Hotspot", 1100)]
    jw = JT.concurrent([JT.get_trace(n, 0.3).slice(0, k) for n, k in parts], slice_len=128)
    pw = PT.concurrent([PT.get_trace(n, 0.3).slice(0, k) for n, k in parts], slice_len=128)
    jtrainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(*tcfg))
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    fresh = {s: {k: np.asarray(v) for k, v in jtrainer.new_params(s).items()} for s in range(blob["n_slots"])}
    jm = JR.mux_for(jw, JC.SMOKE, JI.TrainConfig(*tcfg), table=_jax_table(blob, jtrainer), shared_freq_table=shared)
    pm = PR.mux_for(pw, PC.SMOKE, PI.TrainConfig(*tcfg), shared_freq_table=shared, device="cpu",
                    table=convert.fresh_table(PC.SMOKE, "cpu", blob["n_slots"], fresh))

    def feed(M, mux, w, groups):
        out = []
        for g in groups:
            g0, g1 = g * 256, min((g + 1) * 256, len(w))
            a = mux.observe(M.FaultBatch(w.page[g0:g1], w.pc[g0:g1], w.tb[g0:g1], w.kernel[g0:g1],
                                         tenant=w.tenant[g0:g1]))
            mux.feedback(M.Outcomes(was_evicted=(w.page[g0:g1] % 5 == 0), fault_count=30 * g1 // 256))
            out.append((a.prefetch_blocks.tolist(), a.pre_evict_blocks.tolist(),
                        None if a.counters is None else np.asarray(a.counters).tolist(),
                        {str(k): _actions(t) for k, t in a.per_tenant.items()}))
        return out

    n = (len(jw) + 255) // 256
    feed(JM, jm, jw, range(3))
    jstate = pickle.loads(pickle.dumps(jm.state()))
    jtail = feed(JM, jm, jw, range(3, n))
    pm.restore(convert.mux_state_from_jax(jstate, PC.SMOKE, "cpu"))
    assert feed(PM, pm, pw, range(3, n)) == jtail
    assert (pm.top1, pm.per_tenant_top1, pm.per_group) == (jm.top1, jm.per_tenant_top1, jm.per_group)
    assert len(jtail) >= 4 and any(r[2] is not None for r in jtail)  # the gate opened after the restore


def test_snapshot_store_roundtrip_gc_and_corruption(tmp_path):
    store = PM.SnapshotStore(tmp_path / "ckpt", keep=3)
    assert store.latest_step() is None
    with pytest.raises(FileNotFoundError):
        store.restore()
    for step in range(1, 6):
        store.save(step, {"n": step}, extra={"batches": step * 10})
    assert store.steps() == [3, 4, 5]
    assert store.restore() == (5, {"n": 5}, {"batches": 50})
    assert store.restore(step=3)[1] == {"n": 3}
    manifest = json.loads((store.dir / f"snap_{5:09d}" / "manifest.json").read_text())
    blob = (store.dir / f"snap_{5:09d}" / "state.pkl").read_bytes()
    assert manifest["sha256"] == hashlib.sha256(blob).hexdigest() and manifest["format"] == 1
    payload = store.dir / f"snap_{4:09d}" / "state.pkl"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="content-hash"):
        store.restore(step=4)
    turd = tmp_path / "ckpt" / "snap_000000099.tmp"
    turd.mkdir()
    (turd / "state.pkl").write_bytes(b"half")
    assert store.clean_tmp() == [turd]
    assert not turd.exists() and store.latest_step() == 5
    # the JAX package's store reads the port's layout
    assert JM.SnapshotStore(tmp_path / "ckpt").restore() == (5, {"n": 5}, {"batches": 50})


# --- the health machine, against the JAX package's counters --------------------------


def _both(fn):
    """``fn(side)`` on both sides; their results, asserted equal."""
    j, p = fn("jax"), fn("port")
    assert p == j
    return p


def test_health_off_fails_hard():
    for side in SIDES:
        m = _mgr(side, trainer=_FlakyTrainer(fail_on={1}))
        with pytest.raises(RuntimeError, match="flaky dispatch"):
            m.observe(SIDES[side][0].FaultBatch(np.random.default_rng(0).integers(0, 1024, 64)))


def test_health_state_machine_walk():
    def run(side):
        m = _mgr(side, trainer=_FlakyTrainer(fail_on={1, 2}), health={"recovery_successes": 2})
        return _drive(side, m, np.random.default_rng(0), 10), _health(m)

    acts, health = _both(run)
    assert [a[6] for a in acts] == ["degraded"] * 5 + ["recovering", "healthy"] + ["healthy"] * 3
    assert [a[7] for a in acts] == [True] * 5 + [False] * 5
    assert health[:4] == (2, 5, 1, "healthy") and "flaky" in health[4]


def test_fallback_actions_are_rule_based_floor():
    def run(side):
        M = SIDES[side][0]
        m = _mgr(side, trainer=_FlakyTrainer(fail_on={1}), health={})
        pages = np.tile([0, 16, 320], 22)
        a = m.observe(M.FaultBatch(pages))
        m.feedback(M.Outcomes(np.zeros(len(pages), bool), 64))
        return _actions(a), _health(m)

    a, health = _both(run)
    assert a[7] and a[6] == "degraded" and a[2] is None and not a[5] and a[4] is None
    assert set(a[0]) == {0, 1, 21} and health[1] == 1


def test_nan_params_quarantined_and_reinitialized():
    def run(side):
        m = _mgr(side, health={"recovery_successes": 1})
        rng = np.random.default_rng(2)
        _drive(side, m, rng, 1)
        slot = next(iter(m.table.slots))
        m.table.slots[slot].params = np.full(1, np.nan) if side == "jax" else torch.full((1,), float("nan"))
        acts = _drive(side, m, rng, 3)
        assert np.all(np.isfinite(np.asarray(m.table.slots[slot].params)))
        return acts, _health(m)

    acts, health = _both(run)
    assert [a[6] for a in acts] == ["degraded", "degraded", "healthy"]
    assert health[0] == 1 and "non-finite model params" in health[4]


def test_nan_output_and_latency_budget_demote(monkeypatch):
    def nan(side):
        m = _mgr(side, trainer=_NaNTrainer(), health={"recovery_successes": 1})
        return _drive(side, m, np.random.default_rng(0), 3), _health(m)

    acts, health = _both(nan)
    assert acts[0][7] and health[0] >= 1 and "non-finite predictor output" in health[4]

    # a stubbed clock: every dispatch takes 20 ms against a 1 ms budget
    def slow(side):
        ticks = iter(np.arange(0, 100, 0.02))
        mod = JCore if side == "jax" else PCore
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
        m = _mgr(side, health={"latency_budget_ms": 1.0})
        return _drive(side, m, np.random.default_rng(0), 4), _health(m)

    acts, health = _both(slow)
    assert acts[0][7] and "budget" in health[4] and health[0] >= 2


def test_train_failure_closes_round_without_update():
    def run(side):
        M = SIDES[side][0]
        m = _mgr(side, trainer=_TrainBomb(), health={})
        rng = np.random.default_rng(0)
        b = M.FaultBatch(rng.integers(0, 1024, 64))
        m.observe(b)
        m.feedback(M.Outcomes(np.zeros(len(b), bool), 64))
        assert m._pending is None
        m2 = _mgr(side, trainer=_TrainBomb())
        m2.observe(M.FaultBatch(rng.integers(0, 1024, 64)))
        with pytest.raises(RuntimeError, match="train boom"):
            m2.feedback(M.Outcomes(np.zeros(64, bool), 64))
        return _health(m), [e.n_updates for e in m.table.slots.values()]

    health, updates = _both(run)
    assert health[0] == 1 and updates == [0]


def test_mux_batched_dispatch_failure_degrades_all_tenants():
    def run(side):
        M = SIDES[side][0]
        mux = _mux(side, trainer=_FlakyTrainer(fail_on={1}), health={"recovery_successes": 1})
        pages, tags = np.arange(48) * 16, np.tile([0, 1], 24)
        states = []
        for _ in range(4):
            out = mux.observe(M.FaultBatch(pages, tenant=tags))
            mux.feedback(M.Outcomes(np.zeros(48, bool), 64))
            states.append((dict(mux.health_states), {k: (a.health, a.fallback) for k, a in out.per_tenant.items()}))
        return states, (mux.n_health_faults, mux.n_fallbacks, mux.n_recoveries)

    states, counts = _both(run)
    assert set(states[0][0].values()) == {"degraded"} and set(states[-1][0].values()) == {"healthy"}
    assert counts[0] == 2 and counts[2] == 2
    # without the health machine the batched failure is raised again
    mux = _mux("port", trainer=_FlakyTrainer(fail_on={1}))
    with pytest.raises(RuntimeError, match="flaky batched"):
        mux.observe(PM.FaultBatch(np.arange(48) * 16, tenant=np.tile([0, 1], 24)))


# --- the chaos harness --------------------------------------------------------------


def test_chaos_schedule_parse_and_validation(tmp_path):
    s = PM.ChaosSchedule.parse("trainer_exc=0.3,nan_output=0.1,seed=7")
    assert (s.trainer_exc, s.nan_output, s.seed) == (0.3, 0.1, 7)
    assert s.to_dict() == JM.ChaosSchedule.parse("trainer_exc=0.3,nan_output=0.1,seed=7").to_dict()
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"drop_batch": 0.5, "seed": 9}))
    s2 = PM.ChaosSchedule.parse(f"@{plan}")
    assert s2.drop_batch == 0.5 and s2.seed == 9
    assert PM.ChaosSchedule.parse("") == PM.ChaosSchedule()
    with pytest.raises(ValueError, match="unknown chaos keys"):
        PM.ChaosSchedule.parse("typo_key=0.5")
    with pytest.raises(ValueError, match="not key=value"):
        PM.ChaosSchedule.parse("trainer_exc")
    with pytest.raises(ValueError, match=r"outside \[0, 1\]"):
        PM.ChaosSchedule(trainer_exc=1.5)
    inj = PM.FaultInjector(PM.ChaosSchedule(seed=0, trainer_exc=1.0))
    m = _mgr("port", trainer=inj.wrap_trainer(_StubTrainer()))
    with pytest.raises(PM.ChaosError):
        m.observe(PM.FaultBatch(np.random.default_rng(0).integers(0, 1024, 64)))


def test_chaos_injection_is_seed_deterministic_and_the_references():
    sched = dict(seed=11, trainer_exc=0.3, nan_output=0.2, train_exc=0.3, nan_params=0.2, drop_freq_update=0.3)

    def run(side):
        M = SIDES[side][0]
        inj = M.FaultInjector(M.ChaosSchedule(**sched))
        m = _mgr(side, trainer=inj.wrap_trainer(_StubTrainer()), health={"recovery_successes": 1})
        m.freq_table = inj.wrap_freq_table(m.freq_table)
        acts = _drive(side, m, np.random.default_rng(5), 24)
        return dict(inj.counts), acts, _health(m), m.top1

    counts, acts, health, _ = _both(run)
    assert run("port")[:3] == (counts, acts, health)
    assert counts["trainer_exc"] > 0 and counts["train_exc"] > 0 and health[2] > 0


def test_chaos_nan_params_poisons_tensors_and_the_freq_table_drops():
    from repro_torch.core.model_table import Entry

    class TorchStub(_StubTrainer):
        def new_params(self, seed: int = 0):
            return {"w": torch.ones(3), "i": torch.arange(3)}

    inj = PM.FaultInjector(PM.ChaosSchedule(seed=0, nan_params=1.0, drop_freq_update=1.0))
    tr = inj.wrap_trainer(TorchStub())
    entry = tr.train_group(Entry(params=tr.new_params(0)), None, 2)
    assert torch.isnan(entry.params["w"]).all() and torch.equal(entry.params["i"], torch.arange(3))
    assert not PCore._tree_finite(entry.params) and PCore._tree_finite(tr.new_params(0))
    t = inj.wrap_freq_table(PM.OversubscriptionManager(_cfg("port"), device="cpu").freq_table)
    t.update(np.asarray([1, 2, 3]))
    assert t.lookup(1) == -1 and int(t.counters.sum()) == 0
    assert dict(inj.counts) == {"nan_params": 1, "drop_freq_update": 1}


def test_chaos_transform_lines_equal_the_references():
    rng = np.random.default_rng(4)
    lines = []
    for i in range(40):
        lines.append(json.dumps({"pages": rng.integers(0, 99, 3).tolist()}))
        if i % 3 == 0:
            lines.append(json.dumps({"feedback": {"fault_count": i}}))
        if i % 7 == 0:
            lines += ["# comment", ""]
    for sched in (dict(seed=0), dict(seed=3, drop_batch=0.2, dup_batch=0.2, reorder_batch=0.2, lose_feedback=0.3,
                                    delay_feedback=0.3)):
        got = list(PM.FaultInjector(PM.ChaosSchedule(**sched)).transform_lines(lines))
        assert got == list(JM.FaultInjector(JM.ChaosSchedule(**sched)).transform_lines(lines))
    assert got != lines


# --- the mux ----------------------------------------------------------------------------


def _mux_drive(side, mux, rng, rounds, start_clock=0):
    M = SIDES[side][0]
    clock, out = start_clock, []
    for _ in range(rounds):
        pages, tags = rng.integers(0, 1024, 48), rng.integers(0, 2, 48)
        a = mux.observe(M.FaultBatch(pages, tenant=tags))
        clock += 96
        mux.feedback(M.Outcomes(np.asarray(pages % 5 == 0), clock))
        out.append((tuple(a.prefetch_blocks.tolist()), tuple(a.pre_evict_blocks.tolist()),
                    None if a.counters is None else tuple(np.asarray(a.counters).tolist()), a.budgets))
    return out


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("budgeted", [False, True])
def test_mux_snapshot_restore_bit_identical(shared, budgeted):
    """A tenant-tagged drive snapshotted at round 4 and restored into a
    fresh mux gives the uninterrupted stream, which is JAX's; the shared
    table is serialised once and rebound to every tenant; a budgeted mux
    carries its ``BudgetController``."""
    qos = {"jax": lambda: JBudget(16, 64) if budgeted else None, "port": lambda: PBudget(16, 64) if budgeted else None}
    ref = _mux_drive("jax", _mux("jax", shared=shared, qos=qos["jax"]()), np.random.default_rng(3), 10)
    m1, rng = _mux("port", shared=shared, qos=qos["port"]()), np.random.default_rng(3)
    head = _mux_drive("port", m1, rng, 4)
    st = m1.state()
    _no_tensor(st)
    m2 = _mux("port", shared=shared, qos=qos["port"]())
    m2.restore(pickle.loads(pickle.dumps(st)))
    if shared:
        assert m2.managers[0].freq_table._table is m2.managers[1].freq_table._table
    if budgeted:
        assert m2.qos.state()["block_owner"].tolist() == m1.qos.state()["block_owner"].tolist()
    assert head + _mux_drive("port", m2, rng, 6, start_clock=4 * 96) == ref


def test_mux_snapshot_rejects_mid_round_and_topology():
    mux = _mux("port")
    mux.observe(PM.FaultBatch(np.arange(32), tenant=np.zeros(32, np.int64)))
    with pytest.raises(RuntimeError, match="mid-round"):
        mux.state()
    mux.feedback(PM.Outcomes(np.zeros(32, bool), 64))
    with pytest.raises(ValueError, match="topology"):
        _mux("port", shared=True).restore(mux.state())


def test_budget_controller_state_restore_is_the_references():
    j, p = JBudget(40, 128, interval=2), PBudget(40, 128, interval=2)
    rng = np.random.default_rng(1)
    for _ in range(5):
        for t in ("a", "b", "c"):
            blocks, pressure = rng.integers(0, 128, 9), float(rng.random())
            for c in (j, p):
                c.observe_blocks(t, blocks)
                c.observe_pressure(t, pressure)
        j.step()
        p.step()
    js, ps = j.state(), p.state()
    assert {k: v for k, v in ps.items() if k != "block_owner"} == {k: v for k, v in js.items() if k != "block_owner"}
    np.testing.assert_array_equal(ps["block_owner"], js["block_owner"])
    # restoring rebuilds the scorer by name and recomputes the budgets, as in the reference
    q, jq = PBudget(40, 128, stability="gmr"), JBudget(40, 128, stability="gmr")
    q.restore(pickle.loads(pickle.dumps(ps)))
    jq.restore(js)
    assert (q.budgets, q.scores, q.stability) == (jq.budgets, jq.scores, "percentile")
    assert q.evict_pref(np.ones(128, bool)).tolist() == jq.evict_pref(np.ones(128, bool)).tolist()


# --- the KV offload ----------------------------------------------------------------------


def test_offload_manager_checkpoint_resume(tmp_path):
    def drive(mgr, steps, rng):
        for _ in range(steps):
            touched = rng.integers(0, 64, 16)
            mass = np.zeros(64)
            mass[touched] = 1.0
            mgr.on_attention(mass, touched)

    ref = PO.LearnedOffloadManager(64, 16, group=32, device="cpu")
    drive(ref, 20, np.random.default_rng(9))
    m1 = PO.LearnedOffloadManager(64, 16, group=32, checkpoint_dir=tmp_path / "ck", checkpoint_every=2,
                                  device="cpu")
    rng = np.random.default_rng(9)
    drive(m1, 10, rng)
    store = PM.SnapshotStore(tmp_path / "ck")
    assert (store.latest_step(), m1._observed_batches) == (4, 5)  # 160 touches, a snapshot every 2 batches
    m2 = PO.LearnedOffloadManager(64, 16, group=32, checkpoint_dir=tmp_path / "ck", resume=True, device="cpu")
    assert m2._observed_batches == store.latest_step() <= m1._observed_batches
    m2.restore(m1.state())
    drive(m2, 10, rng)
    assert dataclasses.asdict(m2.stats) == dataclasses.asdict(ref.stats)
    np.testing.assert_array_equal(m2.resident, ref.resident)
    assert m2.manager.top1 == ref.manager.top1
    # the reference's drive, for the record: the same stats
    jref = JO.LearnedOffloadManager(64, 16, group=32)
    drive(jref, 20, np.random.default_rng(9))
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(jref.stats)


# --- the fault log -------------------------------------------------------------------------


def _tagged(tr_mod):
    a, b = tr_mod.get_trace("AddVectors", 0.1), tr_mod.get_trace("NW", 0.1)
    return tr_mod.concurrent([a.slice(0, 900), b.slice(0, 700)], slice_len=128)


@pytest.mark.parametrize("kind", ["untagged", "tagged"])
def test_fault_log_round_trip_and_bytes(tmp_path, kind):
    pt = PT.get_trace("Hotspot", 0.2).slice(0, 2000) if kind == "untagged" else _tagged(PT)
    jt = JT.get_trace("Hotspot", 0.2).slice(0, 2000) if kind == "untagged" else _tagged(JT)
    n = PT.to_fault_log(pt, tmp_path / "p.jsonl", batch=100)
    assert n == JT.to_fault_log(jt, tmp_path / "j.jsonl", batch=100)
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    back = PT.from_fault_log(tmp_path / "p.jsonl")
    for f in ("page", "pc", "tb", "kernel"):
        np.testing.assert_array_equal(getattr(back, f), getattr(pt, f))
    assert (back.name, back.n_pages, back.tenant_names) == (pt.name, pt.n_pages, pt.tenant_names)
    if kind == "tagged":
        np.testing.assert_array_equal(back.tenant, pt.tenant)
    else:
        assert back.tenant is None
    import io

    buf = io.StringIO()
    PT.to_fault_log(pt, buf, batch=100)
    assert buf.getvalue().encode() == (tmp_path / "p.jsonl").read_bytes()


def test_fault_log_bad_headers(tmp_path):
    bad = {"v2": '# uvm-fault-log v2 {}\n{"pages":[1]}\n', "none": '{"pages":[1]}\n', "empty": "",
           "mixed": '# uvm-fault-log v1 {}\n{"pages":[1],"tenant":0}\n{"pages":[2]}\n'}
    for name, text in bad.items():
        (tmp_path / name).write_text(text)
        with pytest.raises(ValueError) as pe:
            PT.from_fault_log(tmp_path / name)
        with pytest.raises(ValueError) as je:
            JT.from_fault_log(tmp_path / name)
        assert str(pe.value) == str(je.value)
    (tmp_path / "hand").write_text('# uvm-fault-log v1 {"name":"x"}\n\n# note\n{"pages":[3,5]}\n')
    t = PT.from_fault_log(tmp_path / "hand")
    assert (t.name, t.n_pages, t.page.tolist(), t.pc.tolist()) == ("x", 6, [3, 5], [0, 0])


def test_run_ours_from_a_read_log_is_the_references(tmp_path):
    """A log written by the port, read back by both packages, drives a
    frozen ``run_ours`` at ``SMOKE`` to JAX's counters and accuracies."""
    jtr, ptr = _smoke_trace("Hotspot", 0.4, 2500)
    PT.to_fault_log(ptr, tmp_path / "h.jsonl")
    jback, pback = JT.from_fault_log(tmp_path / "h.jsonl"), PT.from_fault_log(tmp_path / "h.jsonl")
    tcfg = (512, 0, 128)
    jtrainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(*tcfg))
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    fresh = {s: {k: np.asarray(v) for k, v in jtrainer.new_params(s).items()} for s in range(blob["n_slots"])}
    jres = JR.run_ours(jback, JC.SMOKE, JI.TrainConfig(*tcfg), oversubscription=1.5,
                       table=_jax_table(blob, jtrainer))
    pres = PR.run_ours(pback, PC.SMOKE, PI.TrainConfig(*tcfg), oversubscription=1.5, device="cpu",
                       table=PR.load_pretrain_memo(SMOKE_MEMO, PC.SMOKE, "cpu", fresh=fresh))
    assert (pres.stats, pres.top1, pres.per_group_acc, pres.n_predictions) == \
        (jres.stats, jres.top1, jres.per_group_acc, jres.n_predictions)
