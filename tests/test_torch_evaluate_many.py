"""The port's stacked ``Trainer.evaluate_many`` on the CPU: a bucket of
``MIN_VMAP_LANES`` or more transformer lanes runs one attention call per
block and layer per schedule row for the whole bucket, and every lane's
``correct`` and ``pred`` are bit for bit its serial ``evaluate``'s and the
JAX package's ``evaluate_many`` (which vmaps such a bucket).  The lanes
start from the JAX package's initial weights (converted), so both packages
see the same bits; the comparisons are exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core import predictor as JP
from repro.core.features import DeltaVocab as JVocab
from repro.core.features import FeatureStream as JStream
from repro.uvm import trace as JT
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core import predictor as PP
from repro_torch.kernels import flash_attention as FA

BATCH = 64
# (benchmark, first access, last access): groups of 0 to 800 windows
SPANS = (("Hotspot", 0, 450), ("ATAX", 100, 260), ("Srad-v2", 0, 300), ("StreamTriad", 300, 700),
         ("NW", 0, 64), ("BICG", 50, 330), ("ATAX", 400, 401), ("Hotspot", 500, 1300),
         ("BICG", 0, 200), ("ATAX", 100, 100))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(batch_size=BATCH))
    return {s: {k: np.asarray(v) for k, v in trainer.new_params(s).items()} for s in range(len(SPANS))}


def _lanes(idx):
    out = []
    for i in idx:
        name, lo, hi = SPANS[i]
        vocab = JVocab(JC.SMOKE.delta_vocab)
        stream = JStream(JT.get_trace(name, 0.2), vocab, JC.SMOKE.history, page_vocab=64, pc_vocab=16, tb_vocab=16)
        out.append((stream.windows(lo, hi), max(vocab.n_classes, 2)))
    return out


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


@pytest.mark.parametrize("idx", [(0, 2, 3, 5), (0, 1, 2, 3, 4), (0, 1, 2, 3, 4, 5, 6, 7), (0, 7, 8, 9, 3, 6)],
                         ids=["4", "5", "8", "mixed"])
def test_stacked_buckets_equal_serial_and_jax(idx, jax_init, monkeypatch):
    """4, 5 and 8 lanes (one or two buckets of the JAX package's shapes,
    groups of 1 to 13 schedule rows), and a mix with an empty lane and a
    bucket of a single lane."""
    lanes = _lanes(idx)
    fs_list, na = [fs for fs, _ in lanes], [n for _, n in lanes]
    params = [convert.params_from_jax(jax_init[k], "cpu") for k in range(len(lanes))]
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(batch_size=BATCH), device="cpu")
    count = _Counting(monkeypatch)
    serial = [pt.evaluate(p, fs, n) for p, fs, n in zip(params, fs_list, na)]
    n_serial, count.calls = count.calls, 0
    got = pt.evaluate_many(params, fs_list, na)
    jt = JI.Trainer(JC.SMOKE, JI.TrainConfig(batch_size=BATCH))
    want = jt.evaluate_many([{k: jnp.asarray(v) for k, v in jax_init[k].items()} for k in range(len(lanes))],
                            fs_list, na)
    for (sc, sp), (gc, gp), (jc, jp) in zip(serial, got, want):
        assert gc.dtype == sc.dtype == jc.dtype and gp.dtype == sp.dtype == jp.dtype
        np.testing.assert_array_equal(gc, sc)
        np.testing.assert_array_equal(gp, sp)
        np.testing.assert_array_equal(gc, jc)
        np.testing.assert_array_equal(gp, jp)
    # the attention calls: one per block and layer and row per stacked
    # bucket, one per lane and row for the lanes that run alone
    rows = [-(-len(fs) // BATCH) for fs in fs_list]
    buckets: dict = {}
    for i, (fs, r) in enumerate(zip(fs_list, rows)):
        if r:
            buckets.setdefault((PI.pow2_bucket(len(fs), 1024), PI.pow2_bucket(r, 8)), []).append(i)
    per_row = 2 * PC.SMOKE.num_layers
    want_calls = sum(per_row * (max(rows[i] for i in b) if len(b) >= pt.MIN_VMAP_LANES else sum(rows[i] for i in b))
                     for b in buckets.values())
    assert count.calls == want_calls and n_serial == per_row * sum(rows)
    assert any(len(b) >= pt.MIN_VMAP_LANES for b in buckets.values())


def test_forward_many_is_forward_bit_for_bit(jax_init):
    """A lane stacked with others gives the bits it gives alone (``forward``
    is ``forward_many`` of one lane), and both hold the JAX package's
    ``forward`` of that lane within 1e-5."""
    rng = np.random.default_rng(0)
    cfg = PC.SMOKE
    params = [convert.params_from_jax(jax_init[k], "cpu") for k in range(5)]
    batches = []
    for b in (8, 3, 8, 1, 5):
        batches.append({k: rng.integers(0, v, (b, cfg.history))
                        for k, v in (("page", cfg.page_vocab), ("delta", cfg.delta_vocab), ("pc", cfg.pc_vocab),
                                     ("tb", cfg.tb_vocab))})
    tb = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    for k, ((lg, fg), p, b) in enumerate(zip(PP.forward_many(params, tb, cfg), params, tb)):
        ls, fsr = PP.forward(p, b, cfg)
        assert torch.equal(lg, ls) and torch.equal(fg, fsr)
        jl, jf = JP.forward({n: jnp.asarray(v) for n, v in jax_init[k].items()},
                            {n: jnp.asarray(v) for n, v in batches[k].items()}, JC.SMOKE)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(fg.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_other_kinds_run_lane_by_lane(kind, monkeypatch):
    """Kinds without attention are never stacked; their lanes are their
    serial runs."""
    lanes = _lanes((0, 2, 3, 5))
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(batch_size=BATCH), kind=kind, device="cpu")

    inner = pt._evaluate_bucket

    def one_lane(params_list, *a):
        assert len(params_list) == 1, "lanes of a kind without attention were stacked"
        return inner(params_list, *a)

    monkeypatch.setattr(pt, "_evaluate_bucket", one_lane)
    params = [pt.new_params(s) for s in range(4)]
    got = pt.evaluate_many(params, [fs for fs, _ in lanes], [n for _, n in lanes])
    for (gc, gp), p, (fs, n) in zip(got, params, lanes):
        sc, sp = pt.evaluate(p, fs, n)
        np.testing.assert_array_equal(gc, sc)
        np.testing.assert_array_equal(gp, sp)
