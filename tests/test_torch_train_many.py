"""The port's stacked ``Trainer.train_group_many`` on the CPU: a bucket of
``MIN_VMAP_LANES`` or more transformer lanes runs each step's forward and
backward once for the lanes that have that step, and every lane's params,
AdamW moments, ``step`` and ``n_updates`` are bit for bit its serial
``train_group``'s.  The lanes start from the JAX package's initial weights
(converted).

Tolerances, each with its reason:

* stacked against serial: equal (``torch.equal``): each lane keeps its own
  GEMMs, loss and optimizer calls on its own tensors, and the shared
  attention computes every row on its own;
* against the JAX package's ``train_group_many``, which vmaps a bucket of
  four lanes: ``TRAIN_ATOL`` 1e-4, the limit of one ``train_group`` in
  ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.features import DeltaVocab as JVocab
from repro.core.features import FeatureStream as JStream
from repro.core.model_table import Entry as JEntry
from repro.uvm import trace as JT
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core import losses as PL
from repro_torch.core.model_table import Entry, clone_tree
from repro_torch.kernels import flash_attention as FA
from repro_torch.uvm.manager import ChaosError, ChaosSchedule, FaultInjector

TRAIN_ATOL = 1e-4
TC = dict(group_size=2048, epochs=1, batch_size=64)
# (benchmark, first access, last access): groups of 0 to 790 windows, 1 to
# 12 steps of 64
SPANS = (("Hotspot", 0, 450), ("Srad-v2", 0, 300), ("StreamTriad", 300, 700), ("BICG", 50, 330),
         ("Hotspot", 500, 1300), ("ATAX", 100, 260), ("NW", 0, 140), ("BICG", 0, 200), ("ATAX", 100, 100),
         ("ATAX", 400, 480))
# id: (lanes (indices into SPANS), use_lucir, which lanes carry E∪T flags)
CASES = {
    "4": ((0, 1, 2, 3), True, "all"),
    "5": ((0, 1, 2, 3, 5), True, "none"),
    "8-two-buckets": ((0, 1, 2, 3, 4, 5, 6, 7), False, "even"),
    "steps-1-to-12": ((9, 7, 0, 4), False, "none"),
    "lucir-flags": ((1, 3, 5, 6), True, "all"),
    "lucir": ((1, 3, 5, 6), True, "none"),
    "flags": ((1, 3, 5, 6), False, "all"),
    "plain": ((1, 3, 5, 6), False, "none"),
    "mixed-empty-and-three": ((8, 0, 1, 2, 3, 5, 6, 7), True, "first-five"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(**TC))
    return {s: {k: np.asarray(v) for k, v in trainer.new_params(s).items()} for s in range(2 * len(SPANS))}


def _lanes(idx, flags: str):
    """(feature group, n_active, E∪T flags or None) per lane."""
    rng = np.random.default_rng(3)
    out = []
    for j, i in enumerate(idx):
        name, lo, hi = SPANS[i]
        vocab = JVocab(JC.SMOKE.delta_vocab)
        stream = JStream(JT.get_trace(name, 0.2), vocab, JC.SMOKE.history, page_vocab=64, pc_vocab=16, tb_vocab=16)
        fs = stream.windows(lo, hi)
        on = {"all": True, "none": False, "even": j % 2 == 0, "first-five": j < 5}[flags]
        out.append((fs, max(vocab.n_classes, 2), rng.random(len(fs)) < 0.3 if on else None))
    return out


def _entries(jax_init, n: int, lucir: bool) -> list:
    return [Entry(params=convert.params_from_jax(jax_init[k], "cpu"),
                  prev_params=convert.params_from_jax(jax_init[len(SPANS) + k], "cpu") if lucir else None, step=5)
            for k in range(n)]


class _Counting:
    """Counts the attention calls (the CPU's plain version; the kernel's
    launches on the card) while it is patched in."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = FA.flash_attention

        def counted(*a, **kw):
            self.calls += 1
            return inner(*a, **kw)

        monkeypatch.setattr(FA, "flash_attention", counted)


def _buckets(trainer, lanes, lucir: bool) -> list:
    """Each bucket's lanes' step counts, and whether the bucket stacks."""
    out: dict = {}
    for fs, _, et in lanes:
        if len(fs):
            n_steps = len(trainer._train_schedule(len(fs), np.random.default_rng(0)))
            key = (PI.pow2_bucket(len(fs), 1024), PI.pow2_bucket(n_steps, 16), lucir, et is not None)
            out.setdefault(key, []).append(n_steps)
    return [(steps, len(steps) >= trainer.MIN_VMAP_LANES) for steps in out.values()]


def _assert_entries_equal(a: Entry, b: Entry) -> None:
    assert (a.step, a.n_updates) == (b.step, b.n_updates)
    assert (a.opt_state is None) == (b.opt_state is None)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        if a.opt_state is not None:
            assert torch.equal(a.opt_state.m[k], b.opt_state.m[k]) and torch.equal(a.opt_state.v[k], b.opt_state.v[k])


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_buckets_equal_serial(case, jax_init, monkeypatch):
    """Every lane of a stacked bucket equals its serial ``train_group`` bit
    for bit, lanes leave the stack when their own steps are done, and the
    attention runs once per block, layer and step of a stacked bucket (and
    again under LUCIR for the previous models' features)."""
    idx, lucir, flags = CASES[case]
    lanes = _lanes(idx, flags)
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**TC), device="cpu")
    buckets = _buckets(pt, lanes, lucir)
    assert any(stacks for _, stacks in buckets)
    count = _Counting(monkeypatch)
    serial = _entries(jax_init, len(lanes), lucir)
    for e, (fs, na, et) in zip(serial, lanes):
        if len(fs):
            pt.train_group(e, fs, na, in_et=et, use_lucir=lucir)
    count.calls = 0
    many = _entries(jax_init, len(lanes), lucir)
    assert pt.train_group_many(many, *map(list, zip(*[(fs, na) for fs, na, _ in lanes])),
                               in_et_list=[et for *_, et in lanes], use_lucir=lucir) is many
    for a, b in zip(serial, many):
        _assert_entries_equal(a, b)
    for (fs, *_), e in zip(lanes, many):
        assert (e.step, e.n_updates, e.opt_state is None) == ((5, 0, True) if len(fs) == 0 else (e.step, 1, False))
    per_step = 2 * PC.SMOKE.num_layers * (2 if lucir else 1)
    want = sum(per_step * (max(steps) if stacks else sum(steps)) for steps, stacks in buckets)
    assert count.calls == want


def test_four_lanes_against_jax(jax_init):
    """The JAX package vmaps a bucket of four lanes (LUCIR and the thrashing
    term on); the port's stacked lanes are within ``TRAIN_ATOL`` of it."""
    idx, lucir, flags = CASES["4"]
    lanes = _lanes(idx, flags)
    args = ([fs for fs, *_ in lanes], [na for _, na, _ in lanes])
    flags = [et for *_, et in lanes]
    jt = JI.Trainer(JC.SMOKE, JI.TrainConfig(**TC))
    je = [JEntry(params={k: jnp.asarray(v) for k, v in jax_init[k].items()},
                 prev_params={k: jnp.asarray(v) for k, v in jax_init[len(SPANS) + k].items()}, step=5)
          for k in range(len(lanes))]
    jt.train_group_many(je, *args, in_et_list=flags, use_lucir=True)
    pe = _entries(jax_init, len(lanes), True)
    PI.Trainer(PC.SMOKE, PI.TrainConfig(**TC), device="cpu").train_group_many(pe, *args, in_et_list=flags,
                                                                              use_lucir=True)
    for j, p in zip(je, pe):
        assert (p.step, p.n_updates) == (j.step, j.n_updates) and p.step > 5
        diff = max(float(np.abs(np.asarray(j.params[k]) - p.params[k].numpy()).max()) for k in p.params)
        assert diff <= TRAIN_ATOL, diff


def test_repeated_entry_raises(jax_init):
    """One Entry twice in a stacked bucket raises before any lane trains."""
    lanes = _lanes(CASES["plain"][0], "none")
    entries = _entries(jax_init, len(lanes), False)
    entries[2] = entries[0]
    before = [clone_tree(e.params) for e in entries]
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**TC), device="cpu")
    with pytest.raises(ValueError, match="twice"):
        pt.train_group_many(entries, [fs for fs, *_ in lanes], [na for _, na, _ in lanes])
    for e, p in zip(entries, before):
        assert e.step == 5 and e.n_updates == 0 and e.opt_state is None
        assert all(torch.equal(e.params[k], p[k]) for k in p)


@pytest.mark.parametrize("where", ["chaos", "mid-bucket"])
def test_a_raising_lane_leaves_its_bucket_unchanged(where, jax_init, monkeypatch):
    """A chaos ``train_exc`` before the dispatch, or a lane whose loss raises
    at the third stacked step: every entry of the bucket keeps its params,
    its (unset) moments, ``step`` and ``n_updates``."""
    lanes = _lanes(CASES["4"][0], "all")
    entries = _entries(jax_init, len(lanes), True)
    before = [clone_tree(e.params) for e in entries]
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**TC), device="cpu")
    if where == "chaos":
        pt = FaultInjector(ChaosSchedule(train_exc=1.0)).wrap_trainer(pt)
        exc = ChaosError
    else:
        inner, calls = PL.train_loss, []

        def failing(*a, **kw):
            calls.append(1)
            if len(calls) == 2 * len(lanes) + 2:
                raise FloatingPointError("a lane's loss failed")
            return inner(*a, **kw)

        monkeypatch.setattr(PL, "train_loss", failing)
        exc = FloatingPointError
    with pytest.raises(exc):
        pt.train_group_many(entries, [fs for fs, *_ in lanes], [na for _, na, _ in lanes],
                            in_et_list=[et for *_, et in lanes], use_lucir=True)
    for e, p in zip(entries, before):
        assert (e.step, e.n_updates, e.opt_state) == (5, 0, None)
        assert all(torch.equal(e.params[k], p[k]) for k in p)



_NO_SYMPY_CHILD = """
import json, sys
import torch
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core.features import DeltaVocab, FeatureStream
from repro_torch.core.model_table import Entry
from repro_torch.uvm import trace as T
torch.set_num_threads(1)
pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(group_size=2048, epochs=1, batch_size=64), device="cpu")
vocab = DeltaVocab(PC.SMOKE.delta_vocab)
fs = FeatureStream(T.get_trace("Hotspot", 0.2), vocab, PC.SMOKE.history, page_vocab=64, pc_vocab=16,
                   tb_vocab=16).windows(0, 200)
na = max(vocab.n_classes, 2)
es = [Entry(params=pt.new_params(s), prev_params=pt.new_params(s + 5)) for s in range(5)]
pt.train_group(es[0], fs, na, use_lucir=True)
pt.train_group_many(es[1:], [fs] * 4, [na] * 4, use_lucir=True)
print(json.dumps({"steps": [e.step for e in es],
                  "loaded": sorted({"sympy", "torch.fx.experimental.symbolic_shapes"} & set(sys.modules))}))
"""


def test_fine_tunes_import_no_symbolic_shapes():
    """One ``train_group`` and one stacked bucket, in a fresh process, load
    neither ``torch.fx.experimental.symbolic_shapes`` nor sympy.  A tensor in
    ``autograd.grad``'s ``grad_outputs`` loads both at the first step, a
    cost that the host-bound fine-tune on the card pays once and then in
    every later step; the lanes' upstream gradients come from the sum of
    their losses instead."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent / "src")}
    out = subprocess.run([sys.executable, "-c", _NO_SYMPY_CHILD], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert min(res["steps"]) > 0 and res["loaded"] == []
