"""The port's training path against the JAX package's, on the CPU: the
functional AdamW, the fine-tune schedule, one ``Trainer.train_group``, the
fine-tuned ``run_ours``, Section V-A pretraining, the ``manager`` KV
offload (``LearnedOffloadManager``) and the serve entry point with it.

Fresh model-table slots draw their weights from ``jax.random`` in the JAX
package and from ``repro_torch.random`` in the port, which are one ulp
apart in a few elements in a hundred thousand, so every comparison hands
the port the JAX package's initial weights (converted) to start from the
same bits.

Tolerances, each with its reason:

* AdamW: rtol 1e-5, atol 1e-8 on updates, moments and params, rtol 1e-6
  on the global norm: the same float32 operations in the same order
  (``b**stepf`` in float32 on the host where XLA takes it on its device),
  but XLA may contract ``b * m + (1 - b) * g`` into one fused multiply-add
  where PyTorch rounds twice, and where the two terms nearly cancel an
  ulp of difference is 2e-6 of the result.
* one ``train_group`` at ``SMOKE`` (30 steps from a fresh slot, LUCIR and
  the thrashing term on): params within atol ``TRAIN_ATOL`` 1e-4 of the JAX
  package's (4e-6 measured); AdamW normalises each step, so a gradient
  element near zero whose sign its float32 rounding sets moves its weight
  by up to 2 * lr per step either way.  Each defect below moves some
  weight by more than 1e-2.
* the fine-tuned ``run_ours``: the pretrained ``SMOKE`` memo's Hotspot run
  over its first groups equal exactly, and every group's fine-tune, fed
  the JAX run's own inputs, within ``GROUP_ATOL`` 1e-3 (3e-4 measured: the
  pretrained entries are confident, so more of their gradient elements sit
  at the rounding level than a fresh slot's; a defective step moves some
  weight by more than 1e-2).  The online loop feeds its own predictions
  back, so later groups of a whole run diverge the way two summation orders
  do; ``PERF.md`` measures how far.
* ``LearnedOffloadManager`` on a seeded stream, and pretraining with one
  round: equal stats and accuracies; the trained params within
  ``TRAIN_ATOL``.
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import incremental as JI
from repro.core.features import DeltaVocab as JVocab
from repro.core.features import FeatureStream as JStream
from repro.core.model_table import Entry as JEntry
from repro.core.model_table import ModelTable as JModelTable
from repro.launch import serve as JServe
from repro.optim import adamw as JA
from repro.serving.offload import LearnedOffloadManager as JLearned
from repro.uvm import runtime as JR
from repro.uvm import trace as JT
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import incremental as PI
from repro_torch.core import losses as PL
from repro_torch.core.model_table import Entry as PEntry
from repro_torch.core.model_table import ModelTable as PModelTable
from repro_torch.launch import serve as PServe
from repro_torch.optim import adamw as PA
from repro_torch.serving import offload as PO
from repro_torch.uvm import runtime as PR
from repro_torch.uvm import trace as PT

from test_torch_runtime import SMOKE_MEMO, _jax_table
from test_torch_serving import _stream

TRAIN_ATOL = 1e-4
GROUP_ATOL = 1e-3


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def _to_port(tree):
    return None if tree is None else convert.params_from_jax(_np(tree), "cpu")


def _max_diff(jparams, pparams) -> float:
    return max(float(np.abs(np.asarray(jparams[k]) - pparams[k].numpy()).max()) for k in jparams)


# --- AdamW ---------------------------------------------------------------------


def test_adamw_matches_jax_over_three_steps_with_a_clipped_one():
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 6), "b": (6,), "c/w": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt, popt = JA.adamw(3e-3, weight_decay=0.01), PA.adamw(3e-3, weight_decay=0.01)
    jp, pp = {k: jnp.asarray(v) for k, v in params.items()}, convert.params_from_jax(params, "cpu")
    js, ps = jopt.init(jp), popt.init(pp)
    norms = []
    for step, scale in enumerate((0.01, 5.0, 0.2)):  # the second step's norm exceeds clip_norm 1.0
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        ju, js, jn = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp, 7 + step)
        pu, ps, pn = popt.update(convert.params_from_jax(grads, "cpu"), ps, pp, 7 + step)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        norms.append(float(jn))
        for k in shapes:
            for got, want in ((pu[k], ju[k]), (ps.m[k], js.m[k]), (ps.v[k], js.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)
        jp, pp = JA.apply_updates(jp, ju), PA.apply_updates(pp, pu)
        for k in shapes:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-8)
    assert norms[1] > 1.0 > norms[0]


def test_adamw_helpers_match_jax():
    rng = np.random.default_rng(1)
    tree = {k: rng.standard_normal((5, 3)).astype(np.float32) for k in ("z", "a", "m")}
    jn = JA.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    pt = convert.params_from_jax(tree, "cpu")
    np.testing.assert_allclose(float(PA.global_norm(pt)), float(jn), rtol=1e-7)
    clipped, n = PA.clip_by_global_norm(pt, 0.5)
    jc, _ = JA.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, 0.5)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jc[k]), rtol=1e-6)
    for step in (0, 5, 50, 99, 200):
        np.testing.assert_allclose(PA.cosine_schedule(1e-3, 10, 100)(step),
                                   float(JA.cosine_schedule(1e-3, 10, 100)(step)), rtol=1e-6)
        assert PA.constant_schedule(3e-3)(step) == float(JA.constant_schedule(3e-3)(step))


# --- the fine-tune schedule and one group -----------------------------------------


@pytest.mark.parametrize("n,batch,epochs", [(2048, 256, 3), (700, 64, 3), (23, 32, 1), (300, 256, 2), (500, 32, 0)])
def test_train_schedule_matches_jax_rows(n, batch, epochs):
    tc = dict(group_size=2048, epochs=epochs, batch_size=batch)
    jrng, prng = np.random.default_rng(5), np.random.default_rng(5)
    idx_mat, valid, n_steps = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc))._train_schedule(n, jrng)
    rows = PI.Trainer(PC.SMOKE, PI.TrainConfig(**tc), device="cpu")._train_schedule(n, prng)
    assert rows.shape == (n_steps, batch) and valid.sum() == n_steps
    np.testing.assert_array_equal(rows, idx_mat[:n_steps])
    assert jrng.integers(1 << 30) == prng.integers(1 << 30)  # the same rng calls were made


def _group(name="Hotspot", scale=0.1, lo=0, hi=700):
    vocab = JVocab(JC.SMOKE.delta_vocab)
    stream = JStream(JT.get_trace(name, scale), vocab, 10, page_vocab=64, pc_vocab=16, tb_vocab=16)
    fs = stream.windows(lo, hi)
    return fs, max(vocab.n_classes, 2)


def _defect(name, monkeypatch):
    """A defective training step: the thrashing term's mu left unscaled by
    B / |S|, the LUCIR term dropped, or AdamW without its bias correction."""
    if name == "mu_unscaled":
        orig = PL.train_loss
        monkeypatch.setattr(PL, "train_loss", lambda *a, n_et=0, **kw: orig(*a, n_et=a[0].shape[0], **kw))
    elif name == "no_lucir":
        orig = PL.train_loss
        monkeypatch.setattr(PL, "train_loss", lambda *a, f_old=None, **kw: orig(*a, **kw))
    elif name == "no_bias_correction":
        orig = PA.adamw

        def adamw(lr, **kw):
            opt = orig(lr, **kw)
            return PA.Optimizer(opt.init, lambda g, s, p, step: opt.update(g, s, p, 10 ** 6))  # 1 - b**stepf == 1
        monkeypatch.setattr(PA, "adamw", adamw)


@pytest.mark.parametrize("defect", [None, "mu_unscaled", "no_lucir", "no_bias_correction"])
def test_one_train_group_matches_jax(defect, monkeypatch):
    """30 steps at ``SMOKE`` from a fresh slot, LUCIR on (the previous model
    another slot's weights) and the thrashing term on; the limit rejects
    each defective training step."""
    fs, n_active = _group()
    tc = dict(group_size=2048, epochs=3, batch_size=64)
    jt = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc))
    p0, prev = jt.new_params(3), jt.new_params(5)
    et = np.random.default_rng(0).random(len(fs)) < 0.3
    je = jt.train_group(JEntry(params=p0, prev_params=prev), fs, n_active, in_et=et, use_lucir=True)
    _defect(defect, monkeypatch)
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**tc), device="cpu")
    pe = pt.train_group(PEntry(params=_to_port(p0), prev_params=_to_port(prev)), fs, n_active, in_et=et,
                        use_lucir=True)
    assert (pe.step, pe.n_updates) == (je.step, je.n_updates) == (30, 1)
    diff = _max_diff(je.params, pe.params)
    if defect is None:
        assert diff <= TRAIN_ATOL
        for k, v in je.opt_state.m.items():
            np.testing.assert_allclose(pe.opt_state.m[k].numpy(), np.asarray(v), atol=TRAIN_ATOL)
    else:
        assert diff > 100 * TRAIN_ATOL


def test_train_group_reports_loss_and_grad_norm_and_old_features():
    fs, n_active = _group(lo=0, hi=300)
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(epochs=1, batch_size=64), device="cpu")
    seen = []
    step = pt._train_step

    def recording(*a):
        out = step(*a)
        seen.append(out[2])
        return out

    pt._train_step = recording
    p = pt.new_params(1)
    pt.train_group(PEntry(params=p, prev_params=pt.new_params(2)), fs, n_active, use_lucir=True)
    assert len(seen) == len(fs) // 64 and all(float(m["grad_norm"]) > 0 for m in seen)
    f = pt.old_features(p, fs, np.arange(5))
    assert f.shape == (5, PC.SMOKE.d_model) and pt.old_features(None, fs, np.arange(5)) is None


# --- the fine-tuned online loop -------------------------------------------------------


def _fine_tuned_managers(trace_j, trace_p, tc, table_p=None):
    blob = JR._load_pretrain_blob(SMOKE_MEMO)
    jtable = _jax_table(blob, JI.Trainer(JC.SMOKE, JI.TrainConfig()))
    ptable = PR.load_pretrain_memo(SMOKE_MEMO, PC.SMOKE, "cpu")
    jm = JR.manager_for(trace_j, JC.SMOKE, JI.TrainConfig(**tc), oversubscription=1.5, table=jtable)
    pm = PR.manager_for(trace_p, PC.SMOKE, PI.TrainConfig(**tc), oversubscription=1.5, table=ptable, device="cpu")
    ptable.init_fn = lambda s: _to_port(jm.trainer.new_params(s))
    return jm, pm


def test_fine_tuned_run_ours_matches_jax_over_its_first_groups():
    tc = dict(group_size=512, epochs=3, batch_size=64)
    tj, tp = JT.get_trace("Hotspot", 0.4).slice(0, 4 * 512), PT.get_trace("Hotspot", 0.4).slice(0, 4 * 512)
    jm, pm = _fine_tuned_managers(tj, tp, tc)
    jr = JR.run_ours(tj, JC.SMOKE, JI.TrainConfig(**tc), oversubscription=1.5, manager=jm)
    pr = PR.run_ours(tp, PC.SMOKE, PI.TrainConfig(**tc), oversubscription=1.5, manager=pm)
    assert pr.stats == jr.stats and pr.top1 == jr.top1 and pr.per_group_acc == jr.per_group_acc
    assert pr.n_predictions == jr.n_predictions > 0
    steps = sorted((s, e.step, e.n_updates) for s, e in jm.table.slots.items())
    assert sorted((s, e.step, e.n_updates) for s, e in pm.table.slots.items()) == steps
    assert any(e.step > 0 for e in pm.table.slots.values())


def test_fine_tuned_run_ours_trains_every_group_as_jax_does():
    """The JAX package's fine-tuned run, each of its fine-tunes repeated by the
    port's trainer on the same entry and inputs (flags, LUCIR target,
    moments, step): every group's params within ``GROUP_ATOL``."""
    tc = dict(group_size=512, epochs=3, batch_size=64)
    tj, tp = JT.get_trace("Hotspot", 0.1), PT.get_trace("Hotspot", 0.1)
    jm, _ = _fine_tuned_managers(tj, tp, tc)
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**tc), device="cpu")
    train_group, diffs, flagged = jm.trainer.train_group, [], []

    def both(entry, fs, n_active, *, in_et=None, use_lucir=False, rng=None):
        opt = None if entry.opt_state is None else PA.OptState(_to_port(entry.opt_state.m), _to_port(entry.opt_state.v))
        pe = PEntry(params=_to_port(entry.params), prev_params=_to_port(entry.prev_params), opt_state=opt,
                    step=entry.step, n_updates=entry.n_updates)
        out = train_group(entry, fs, n_active, in_et=in_et, use_lucir=use_lucir, rng=rng)
        pe = pt.train_group(pe, fs, n_active, in_et=in_et, use_lucir=use_lucir, rng=rng)
        assert (pe.step, pe.n_updates) == (out.step, out.n_updates)
        diffs.append(_max_diff(out.params, pe.params))
        flagged.append(0 if in_et is None else int(np.sum(in_et)))
        return out

    jm.trainer.train_group = both
    JR.run_ours(tj, JC.SMOKE, JI.TrainConfig(**tc), oversubscription=1.5, manager=jm)
    assert len(diffs) >= 10 and sum(f > 0 for f in flagged) >= 3
    assert max(diffs) <= GROUP_ATOL, diffs


@pytest.mark.parametrize("mode", ["online_single", "ours", "offline"])
def test_run_protocol_matches_jax(mode, monkeypatch):
    """The training protocols of Figs. 4/6/11 on a short Hotspot trace, both
    sides from the JAX package's initial weights, with E∪T flags for the
    thrashing term under ``ours``."""
    tc = dict(group_size=512, epochs=1, batch_size=64)
    tj, tp = JT.get_trace("Hotspot", 0.1).slice(0, 2048), PT.get_trace("Hotspot", 0.1).slice(0, 2048)
    flags = np.random.default_rng(1).random(len(tj)) < 0.2
    jr = JI.run_protocol(tj, JC.SMOKE, JI.TrainConfig(**tc), mode=mode, in_et_flags=flags)
    jtrainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc))
    monkeypatch.setattr(PI.Trainer, "new_params", lambda self, s=0: _to_port(jtrainer.new_params(s)))
    pr = PI.run_protocol(tp, PC.SMOKE, PI.TrainConfig(**tc), mode=mode, in_et_flags=flags, device="cpu")
    assert (pr.top1, pr.per_group, pr.n_classes, pr.n_models, pr.n_samples) == \
        (jr.top1, jr.per_group, jr.n_classes, jr.n_models, jr.n_samples)
    np.testing.assert_array_equal(pr.predictions, jr.predictions)
    np.testing.assert_array_equal(pr.t_index, jr.t_index)


# --- pretraining ------------------------------------------------------------------------


def test_pretrain_table_matches_jax_on_one_trace(monkeypatch):
    monkeypatch.setenv("REPRO_PRETRAIN_CACHE", "0")
    tc = dict(group_size=512, epochs=1, batch_size=64)
    corpus_j, corpus_p = [JT.get_trace("ATAX", 0.2)], [PT.get_trace("ATAX", 0.2)]
    jtab = JR.pretrain_table(corpus_j, JC.SMOKE, JI.TrainConfig(**tc), max_rounds=1)
    jtrainer = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc))
    monkeypatch.setattr(PI.Trainer, "new_params", lambda self, s=0: _to_port(jtrainer.new_params(s)))
    ptab = PR.pretrain_table(corpus_p, PC.SMOKE, PI.TrainConfig(**tc), max_rounds=1, device="cpu")
    assert sorted(ptab.slots) == sorted(jtab.slots) and len(ptab.slots) > 0
    for s, je in jtab.slots.items():
        pe = ptab.slots[s]
        assert (pe.step, pe.n_updates, pe.last_acc) == (je.step, je.n_updates, je.last_acc)
        assert pe.step > 0 and _max_diff(je.params, pe.params) <= TRAIN_ATOL


# --- the manager KV offload ----------------------------------------------------------------


def _jax_initial_slots():
    trainer = JI.Trainer(JC.SMOKE, JI.TrainConfig())
    return {s: _np(trainer.new_params(s)) for s in range(8)}


@pytest.mark.parametrize("n_pages,cap", [(32, 16), (12, 3)])
def test_learned_offload_manager_matches_jax(n_pages, cap):
    """Both managers fed one seeded mass/touch stream (300 steps, several
    fine-tuned rounds), the port's from the JAX package's initial slots."""
    jm = JLearned(n_pages, cap)
    for mass, touched in _stream(np.random.default_rng(n_pages + cap), 300, n_pages):
        jm.on_attention(mass, touched)
    init = _jax_initial_slots()
    table = PModelTable(lambda s: convert.params_from_jax(init[s], "cpu"), n_slots=8)
    pm = PO.LearnedOffloadManager(n_pages, cap, manager=PO._default_serving_manager(n_pages, cap, table=table,
                                                                                      device="cpu"))
    for mass, touched in _stream(np.random.default_rng(n_pages + cap), 300, n_pages):
        pm.on_attention(mass, touched)
    assert dataclasses.asdict(pm.stats) == dataclasses.asdict(jm.stats)
    assert pm.manager.per_group == jm.manager.per_group and len(pm.manager.per_group) > 3
    assert (pm.manager.top1, pm.manager.n_predictions) == (jm.manager.top1, jm.manager.n_predictions)
    for s, je in jm.manager.table.slots.items():
        pe = pm.manager.table.slots[s]
        assert (pe.step, pe.n_updates) == (je.step, je.n_updates) and pe.step > 0
        assert _max_diff(je.params, pe.params) <= TRAIN_ATOL


def test_serve_entry_point_with_the_manager_offload_prints_the_reference_keys(capsys):
    argv = ["--smoke", "--batch", "2", "--prompt-len", "12", "--new-tokens", "4", "--offload", "manager"]
    assert PServe.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert JServe.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want) and got["generated_shape"] == want["generated_shape"] == [2, 4]
    assert sorted(got["offload"]) == sorted(want["offload"]) and sum(got["offload"].values()) > 0
