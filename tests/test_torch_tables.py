"""The port's Table VI path against the JAX package, bit for bit, on the
CPU: the ``tree`` prefetcher under every ported policy (counters,
per-access outputs and state arrays), ``run_batch``, UVMSmart (its pinning
branch on a trace made for it), Table III's delta counts, and the rows of
the port's table runner (Tables I-IV and VI) against the rows that
``benchmarks/tables.py`` builds from the JAX package's cells."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as BC
import benchmarks.tables as JTAB
from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.features import unique_deltas_per_phase as j_unique_deltas
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.core.pattern import PatternClassifier as JPatternClassifier
from repro.uvm import runtime as JR
from repro.uvm import simulator as JS
from repro.uvm import trace as JT
from repro.uvm.uvmsmart import run_uvmsmart as j_run_uvmsmart
from repro_torch import convert
from repro_torch.bench import tables as PTAB
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core.features import unique_deltas_per_phase as p_unique_deltas
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import simulator as PS
from repro_torch.uvm import trace as PT
from repro_torch.uvm.uvmsmart import run_uvmsmart as p_run_uvmsmart

ROOT = Path(__file__).resolve().parent.parent
SMOKE_MEMO = ROOT / "experiments" / "cache" / "pretrain_e8919be312ea6abc.pkl"
FIELDS = [f.name for f in dataclasses.fields(PS.SimState)]


def _assert_state_equal(j, p):
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(p, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _states(nb: int, policy: str, seed: int):
    """Fresh JAX and port states; under ``learned`` both carry the same
    random prediction-frequency counters (the manager's export)."""
    js, ps = JS.init_state(nb), PS.init_state(nb, "cpu")
    if policy == "learned":
        freq = np.random.default_rng(seed).integers(-1, 64, nb).astype(np.int32)
        js = js._replace(freq=jnp.asarray(freq))
        ps = dataclasses.replace(ps, freq=torch.tensor(freq))
    return js, ps


# (trace, scale, oversubscription): Srad-v2 has periodic windows; ATAX's 24
# blocks at 0.1 end inside a chunk, so the tree meets padding blocks
TREE_CELLS = [("Hotspot", 0.1, 1.25), ("Srad-v2", 0.1, 1.25), ("ATAX", 0.1, 1.25), ("Backprop", 0.1, 1.5)]


@pytest.mark.parametrize("policy", ["lru", "hpe", "belady", "learned"])
@pytest.mark.parametrize("name,scale,oversub", TREE_CELLS)
def test_tree_run_equals_jax(name, scale, oversub, policy):
    tj, tp = JT.get_trace(name, scale), PT.get_trace(name, scale)
    js, ps = _states(PS.bucket_blocks(tp.n_blocks), policy, len(tp))
    jr = JS.run(tj, policy=policy, prefetch="tree", oversubscription=oversub, state=js)
    pr = PS.run(tp, policy=policy, prefetch="tree", oversubscription=oversub, state=ps)
    assert pr.stats == jr.stats
    assert pr.pages_thrashed == jr.pages_thrashed
    _assert_state_equal(jr.state, pr.state)
    for k in ("fault", "thrash", "was_evicted"):
        assert getattr(jr, k).dtype == getattr(pr, k).dtype, k
        np.testing.assert_array_equal(getattr(jr, k), getattr(pr, k), err_msg=k)
    # the tree fetched more than the faults did
    assert pr.stats["migrated_blocks"] > pr.stats["faults"]


def test_tree_cells_cover_periodic_windows_and_padding():
    seen_periodic = seen_padding = False
    for name, scale, _ in TREE_CELLS:
        t = PT.get_trace(name, scale)
        ev = PS.compress_events(t.block.astype(np.int32), PS.next_use_for(t), periodic=True)
        seen_periodic |= bool((ev.stride > 1).any())
        seen_padding |= t.n_blocks % PS.CHUNK_BLOCKS != 0
    assert seen_periodic and seen_padding


def test_run_batch_equals_run_and_jax():
    tj, tp = JT.get_trace("StreamTriad", 0.25), PT.get_trace("StreamTriad", 0.25)
    # capacity 2 < the period 3 at x40: periodic aggregates fault and rerun
    cells = [("lru", "tree", 1.25), ("hpe", "demand", 40.0), ("belady", "demand", 1.25), ("learned", "tree", 1.5),
             ("lru", "none", 1.25), ("hpe", "tree", 40.0)]
    got = PS.run_batch(tp, cells, device="cpu")
    assert got == JS.run_batch(tj, cells)
    assert got == [PS.run(tp, policy=p, prefetch=f, oversubscription=o, device="cpu").stats for p, f, o in cells]


def _pinning_trace(pkg, seed: int = 0):
    """Three epochs of 2,048 accesses over 64 blocks: uniform random
    (classified random: UVMSmart pins its coldest blocks), a walk that steps
    to the next block 45% of the time (mixed reuse: the tree prefetcher,
    among pinned blocks), then a sequential sweep."""
    rng = np.random.default_rng(seed)
    n, nb = 2048, 64
    walk = np.empty(n, np.int64)
    walk[0] = 0
    for i in range(1, n):
        walk[i] = (walk[i - 1] + 1) % nb if rng.random() < 0.45 else rng.integers(0, nb)
    blocks = np.concatenate([rng.integers(0, nb, n), walk, np.arange(n) % nb])
    page = (blocks * 16 + rng.integers(0, 16, len(blocks))).astype(np.int32)
    kernel = np.repeat(np.arange(3), n).astype(np.int32)
    pc, tb = (rng.integers(0, 32, len(blocks)).astype(np.int32) for _ in range(2))
    return pkg.Trace("pinning", page, pc, tb, kernel, nb * 16)


def test_pinning_trace_reaches_the_pinning_branch():
    t = _pinning_trace(PT)
    c = JPatternClassifier()
    pats = [c.classify(t.block[lo:lo + 2048], t.kernel[lo:lo + 2048]) for lo in range(0, len(t), 2048)]
    assert pats[0] in (1, 4) and pats[1] not in (0, 1, 4)  # pin, then the tree


@pytest.mark.parametrize("name,scale", [("Hotspot", 0.1), ("ATAX", 0.4), ("Backprop", 0.4), ("pinning", None)])
def test_uvmsmart_equals_jax(name, scale):
    if name == "pinning":
        tj, tp = _pinning_trace(JT), _pinning_trace(PT)
    else:
        tj, tp = JT.get_trace(name, scale), PT.get_trace(name, scale)
    got = p_run_uvmsmart(tp, oversubscription=1.25, device="cpu")
    assert got == j_run_uvmsmart(tj, oversubscription=1.25)
    if name == "pinning":
        assert got["zero_copy"] > 0


@pytest.mark.parametrize("name", ["NW", "Srad-v2", "StreamTriad"])
def test_unique_deltas_per_phase_equal(name):
    assert p_unique_deltas(PT.get_trace(name, 0.4), 3) == j_unique_deltas(JT.get_trace(name, 0.4), 3)


class _JaxContext:
    """What ``benchmarks/tables.py`` reads of a ``Session``, from the JAX
    package's primitives: the standard cells through ``run_batch``,
    UVMSmart, and a frozen ``run_ours`` from the SMOKE memo."""

    def __init__(self, benches, scale, cap, tcfg, table):
        self.benches, self.scale, self.cap, self.tcfg, self.table = benches, scale, cap, tcfg, table
        self.pcfg = JC.SMOKE
        self._traces, self._sims = {}, {}

    def trace(self, b):
        if b not in self._traces:
            tr = JT.get_trace(b, self.scale)
            self._traces[b] = tr.slice(0, min(len(tr), self.cap))
        return self._traces[b]

    def sim(self, b, policy, prefetch, oversub=1.25):
        if b not in self._sims:
            cells = PTAB.STANDARD_CELLS
            stats = JS.run_batch(self.trace(b), [(p, f, oversub) for p, f in cells])
            self._sims[b] = dict(zip(cells, stats))
        return self._sims[b][(policy, prefetch)]

    def uvmsmart(self, b, oversub=1.25):
        return j_run_uvmsmart(self.trace(b), oversubscription=oversub)

    def uvmsmart_many(self, names, oversub=1.25):
        return [self.uvmsmart(n, oversub) for n in names]

    def ours(self, b, oversub=1.25):
        return JR.run_ours(self.trace(b), JC.SMOKE, self.tcfg, oversubscription=oversub, table=self.table.clone())

    def ours_many(self, names, oversub=1.25):
        return [self.ours(n, oversub) for n in names]


def _jax_smoke_table(blob, trainer) -> JModelTable:
    table = JModelTable(lambda s: trainer.new_params(s), n_slots=blob["n_slots"])
    for s, e in blob["slots"].items():
        table.slots[s] = JEntry(params={k: jnp.asarray(v) for k, v in e["params"].items()},
                                step=e["step"], n_updates=e["n_updates"], last_acc=e["last_acc"])
    return table


def test_table_runner_rows_equal_jax(monkeypatch, tmp_path, capsys):
    """Tables I-IV and VI at the quick preset's scale on three benchmarks
    (table3 asserts on NW and StreamTriad), ``ours`` frozen from the SMOKE
    memo: the port's rows equal the reference's row for row."""
    monkeypatch.setattr(BC, "OUT_DIR", tmp_path)  # the reference tables' CSVs
    benches = ["NW", "StreamTriad", "ATAX"]
    scale, cap = PTAB.SCALE_PRESETS["quick"]
    tc = dict(group_size=2048, epochs=0, batch_size=256)
    jtrainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc))
    jtable = _jax_smoke_table(JR._load_pretrain_blob(SMOKE_MEMO), jtrainer)
    ptable = PR.load_pretrain_memo(SMOKE_MEMO, PC.SMOKE, "cpu")
    # slots the memo lacks start fresh: hand the port the JAX package's init
    ptable.init_fn = lambda s: convert.params_from_jax(
        {k: np.asarray(v) for k, v in jtrainer.new_params(s).items()}, "cpu")
    jctx = _JaxContext(benches, scale, cap, JI.TrainConfig(**tc), jtable)
    pctx = PTAB.Context("quick", benches=benches, table=ptable, device="cpu")
    pctx.pcfg = PC.SMOKE  # the memo's predictor
    pctx = pctx.with_train(PI.TrainConfig(**tc))
    assert (pctx.scale, pctx.cap, pctx.tcfg.epochs) == (scale, cap, 0)
    for name in ("table1", "table2", "table3", "table4", "table6"):  # VII and VIII: tests/test_torch_multi.py
        want = getattr(JTAB, name)(jctx)
        got = getattr(PTAB, name)(pctx)
        assert got == want, name
    assert got[0]["benchmark"] == "AVG_REDUCTION_VS_BASELINE"
    assert any(pctx.ours(b).n_predictions > 0 for b in benches)
    out = capsys.readouterr().out
    assert "table6_thrashing_full," in out and '"AVG_REDUCTION_VS_BASELINE"' in out


def test_runner_presets_and_quick_ours_raises():
    assert PTAB.ALL_BENCH == list(JT.BENCHMARKS)
    from repro.uvm.api.session import Session
    from repro.uvm.api.specs import SCALE_PRESETS

    assert PTAB.SCALE_PRESETS == SCALE_PRESETS
    assert PTAB.STANDARD_CELLS == Session.STANDARD_CELLS
    ctx = PTAB.Context("quick", device="cpu")
    assert ctx.pcfg == PC.CONFIG_QUICK and (ctx.tcfg.group_size, ctx.tcfg.epochs, ctx.tcfg.batch_size) == (1024, 2, 128)
    with pytest.raises(NotImplementedError, match="pretrained table"):
        ctx.ours("ATAX")
    paper = PTAB.Context("paper", frozen=True, device="cpu")
    assert paper.pcfg == PC.CONFIG and (paper.tcfg.group_size, paper.tcfg.epochs) == (2048, 0)
    assert paper.with_train(PI.TrainConfig()).tcfg.epochs == 3
