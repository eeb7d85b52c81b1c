"""The port's plug-in registry against the JAX package, on the CPU: the
builtin ids, single-owner names and ``scoped()``, registered policies and
prefetchers through ``run``/``run_batch``/``run_segment`` (a clone of a
builtin equal to it, a new policy equal to the JAX package's counters),
the whole-state tree mask, and registered classifiers and frequency
tables in the manager.  Every simulator counter is an integer, held equal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.uvm import registry as JREG
from repro.uvm import simulator as JS
from repro.uvm import trace as JT
from repro_torch.configs import predictor_paper as PC
from repro_torch.core.pattern import PatternClassifier
from repro_torch.core.policy import PredictionFrequencyTable
from repro_torch.uvm import api as PAPI
from repro_torch.uvm import registry as PREG
from repro_torch.uvm import simulator as PS
from repro_torch.uvm import trace as PT
from repro_torch.uvm.manager import FaultBatch, ManagerConfig, Outcomes, OversubscriptionManager


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensors are small: one intra-op thread keeps its work
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traces(name: str, n: int = 1500):
    return JT.get_trace(name, 0.25).slice(0, n), PT.get_trace(name, 0.25).slice(0, n)


def test_registry_duplicate_name_rejected():
    with pytest.raises(ValueError):
        PAPI.register_policy("lru", lambda st, i, t: (st.last_access,))
    with pytest.raises(ValueError):
        PAPI.register_prefetcher("tree", lambda r, b, v, n: r)
    with pytest.raises(ValueError):
        PAPI.register_predictor("transformer", lambda cfg: None)
    with pytest.raises(ValueError):
        PAPI.register_classifier("dfa", PatternClassifier)
    with pytest.raises(ValueError):
        PAPI.register_freq_table("setassoc", PredictionFrequencyTable)
    with pytest.raises(ValueError, match="either mask_fn or alias_of"):
        PAPI.register_prefetcher("x", lambda r, b, v, n: r, alias_of="tree")
    with pytest.raises(ValueError, match="not a registered prefetcher"):
        PAPI.register_prefetcher("x", alias_of="nope")
    v0 = PREG.registry_version()
    with PREG.scoped():
        PAPI.register_policy("tmp_policy", lambda st, i, t: (st.last_access,))
        PAPI.register_classifier("tmp_cls", PatternClassifier)
        PAPI.register_freq_table("tmp_ft", PredictionFrequencyTable)
        PAPI.register_prefetcher("tmp_alias", alias_of="tree")
        assert PREG.PREFETCH_IDS["tmp_alias"] == PREG.PREFETCH_IDS["tree"]
        with pytest.raises(ValueError):
            PAPI.register_policy("tmp_policy", lambda st, i, t: (st.last_access,))
    assert "tmp_policy" not in PAPI.policy_names() and "tmp_cls" not in PAPI.classifier_names()
    assert "tmp_ft" not in PAPI.freq_table_names() and "tmp_alias" not in PREG.PREFETCH_IDS
    assert PREG.registry_version() > v0  # monotonic across a scope


def test_builtin_ids_stable():
    assert PS.POLICY_IDS == {"lru": 0, "random": 1, "belady": 2, "hpe": 3, "learned": 4} == dict(JS.POLICY_IDS)
    assert PS.PREFETCH_IDS == {"demand": 0, "tree": 1, "none": 0} == dict(JS.PREFETCH_IDS)
    assert PREG.POLICY_IDS is PS.POLICY_IDS  # the simulator holds the registry's dict objects
    assert set(PAPI.predictor_names()) >= {"transformer", "lstm", "cnn", "mlp"}
    assert (PAPI.classifier_names(), PAPI.freq_table_names()) == (("dfa",), ("setassoc",))
    assert PAPI.stability_names() == ("percentile", "gmr")
    assert len(PREG.prefetch_branches()) == 2 and PREG.prefetch_branches()[0] is None


def test_registered_policy_rides_run_batch():
    """A builtin clone equals the builtin in the same sweep; a new policy
    equals its own single-cell run and the JAX package's counters."""
    jtr, ptr = _traces("ATAX")
    cells = [("lru", "tree", 1.25), ("lru_clone", "tree", 1.25), ("mru", "tree", 1.25), ("mru", "demand", 1.5)]
    with PREG.scoped(), JREG.scoped():
        for REG in (PREG, JREG):
            REG.register_policy("lru_clone", lambda st, i, t: (st.last_access,))
            REG.register_policy("mru", lambda st, i, t: (-st.last_access,))
        out = PS.run_batch(ptr, cells, device="cpu")
        assert out == JS.run_batch(jtr, cells)
        assert out[0] == out[1] and out[2] != out[0]
        for cell, got in zip(cells[2:], out[2:]):
            assert got == PS.run(ptr, policy=cell[0], prefetch=cell[1], oversubscription=cell[2], device="cpu").stats
    assert PS.run_batch(ptr, [("lru", "tree", 1.25)], device="cpu")[0] == \
        PS.run(ptr, policy="lru", prefetch="tree", device="cpu").stats
    with pytest.raises(AssertionError):
        PS.run_batch(ptr, [("mru", "tree", 1.25)], device="cpu")


@pytest.mark.parametrize("policy", ["lru", "learned"])
def test_registered_prefetcher_rides_run_batch(policy):
    """``tree_clone`` (the whole-state ``_tree_mask``, through the generic
    mask path) equals the builtin ``tree`` (the chunk-sliced step) bit for
    bit: counters, per-access outputs and the state arrays."""
    jtr, ptr = _traces("Hotspot")
    with PREG.scoped():
        PAPI.register_prefetcher("tree_clone", PS._tree_mask)
        out = PS.run_batch(ptr, [(policy, "tree", 1.25), (policy, "tree_clone", 1.25)], device="cpu")
        assert out[0] == out[1] == JS.run_batch(jtr, [(policy, "tree", 1.25)])[0]
        a = PS.run(ptr, policy=policy, prefetch="tree", oversubscription=1.5, device="cpu")
        b = PS.run(ptr, policy=policy, prefetch="tree_clone", oversubscription=1.5, device="cpu")
        for f in ("resident", "evicted_once", "last_access", "last_interval"):
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
        np.testing.assert_array_equal(a.was_evicted, b.was_evicted)
        np.testing.assert_array_equal(a.thrash, b.thrash)


def test_tree_mask_is_the_references():
    rng = np.random.default_rng(3)
    for _ in range(20):
        nb = 128
        res = rng.random(nb) < rng.random()
        blk = int(rng.integers(0, nb))
        res[blk] = True
        valid = np.arange(nb) < int(rng.integers(1, nb + 1))
        want = np.asarray(JS._tree_mask(jnp.asarray(res), blk, jnp.asarray(valid), nb))
        got = PS._tree_mask(torch.tensor(res), blk, torch.tensor(valid), nb)
        np.testing.assert_array_equal(got.numpy(), want)


def test_registered_strategies_ride_run_segment_and_apply_prefetch():
    """A three-key policy and a mask prefetcher through ``run_segment``
    (with a QoS leading key) and ``apply_prefetch``, against the JAX
    package's."""
    jtr, ptr = _traces("NW", 1200)

    def keys(st, interval_now, t_now):
        return (st.next_use % 7, -st.last_access, st.freq)

    def stride_mask(r, b, v, n):
        M = torch if isinstance(r, torch.Tensor) else jnp
        iota = M.arange(n)
        return ((iota == b + 2) | (iota == b + 4)) & v & ~r

    with PREG.scoped(), JREG.scoped():
        for REG in (PREG, JREG):
            REG.register_policy("mod7", keys)
            REG.register_prefetcher("stride", stride_mask)
        nb = PS.bucket_blocks(ptr.n_blocks)
        pref = np.where(np.arange(nb) % 3 == 0, -1, 0).astype(np.int32)
        pst, pouts = PS.run_segment(PS.init_state(nb, "cpu"), ptr.block.astype(np.int32), PS.next_use_for(ptr),
                                    capacity=40, policy="mod7", prefetch="stride", n_valid=ptr.n_blocks,
                                    evict_pref=torch.tensor(pref))
        jst, jouts = JS.run_segment(JS.init_state(nb), jtr.block.astype(np.int32), JS.next_use_for(jtr),
                                    capacity=40, policy="mod7", prefetch="stride", n_valid=jtr.n_blocks,
                                    evict_pref=pref)
        assert PS.state_stats(pst) == {"pages_thrashed": int(jst.thrash_events) * 16, "faults": int(jst.faults),
                                       "migrated_blocks": int(jst.migrations), "zero_copy": int(jst.zero_copy),
                                       "occupancy": int(jst.occupancy)}
        for k in ("fault", "thrash", "was_evicted"):
            np.testing.assert_array_equal(pouts[k], np.asarray(jouts[k]))
        mask = np.arange(nb) % 5 == 1
        pa = PS.apply_prefetch(pst, torch.tensor(mask), capacity=30, policy="mod7")
        ja = JS.apply_prefetch(jst, jnp.asarray(mask), capacity=30, policy="mod7")
        np.testing.assert_array_equal(pa.resident.numpy(), np.asarray(ja.resident))
        with pytest.raises(ValueError, match="1-3 keys"):
            PREG.register_policy("four", lambda st, i, t: (st.freq,) * 4)
            PS.run_segment(PS.init_state(nb, "cpu"), ptr.block.astype(np.int32), PS.next_use_for(ptr),
                           capacity=4, policy="four", prefetch="demand", n_valid=ptr.n_blocks)


def test_registered_classifier_and_freq_table_in_the_manager():
    """The manager builds its classifier and frequency table through the
    registry (the frequency table on the manager's device); a registered
    pair rides the stepwise protocol."""
    calls = []

    class Linear(PatternClassifier):
        def classify(self, blocks, kernels):
            calls.append(len(blocks))
            return 0

    with PREG.scoped():
        PAPI.register_classifier("always0", Linear)
        PAPI.register_freq_table("small", lambda device="cuda": PredictionFrequencyTable(64, 4, device=device))
        cfg = ManagerConfig(predictor=PC.SMOKE, classifier="always0", freq_table="small", n_blocks=64, capacity=16)
        m = OversubscriptionManager(cfg, device="cpu")
        assert isinstance(m.classifier, Linear) and m.freq_table.n_sets == 64 and m.freq_table.device.type == "cpu"
        a = m.observe(FaultBatch(np.arange(100) * 3))
        m.feedback(Outcomes(np.zeros(100, bool), 10))
        assert a.pattern == 0 and calls == [100]
    with pytest.raises(KeyError, match="unknown classifier"):
        OversubscriptionManager(ManagerConfig(predictor=PC.SMOKE, classifier="always0"), device="cpu")
    with pytest.raises(KeyError, match="unknown freq-table"):
        OversubscriptionManager(ManagerConfig(predictor=PC.SMOKE, freq_table="small"), device="cpu")
