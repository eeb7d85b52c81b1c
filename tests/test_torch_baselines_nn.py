"""The port's Fig. 10 predictor zoo (``repro_torch.core.baselines_nn``: the
LSTM, CNN and MLP kinds) against the JAX package's, on the CPU at ``SMOKE``
width.

Tolerances, each with its reason:

* features from identical params: rtol 1e-5, atol 1e-6 (the same float32
  operations; XLA fuses and orders some reductions and its
  ``logistic``/``tanh`` differently, a few ulp); the logits, 16 (the
  cosine scale) times a cosine, at the cosine's atol 1e-6 times 16;
* the loss (CE, LUCIR and the thrashing term) rtol 1e-5, and its gradient
  rtol 1e-4, atol 1e-5 (the backward sums over the batch in another order);
* one ``train_group`` from the same fresh weights: params within
  ``TRAIN_ATOL`` 1e-4, as ``tests/test_torch_train.py`` holds the
  transformer (AdamW normalises each step, so a gradient element near zero
  whose sign its rounding sets moves its weight by up to 2·lr either way);
* ``online_single`` from fresh weights each package draws itself: top-1
  equal at the reference's 3 digits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import baselines_nn as JB
from repro.core import incremental as JI
from repro.core import losses as JL
from repro.core.features import DeltaVocab as JVocab
from repro.core.features import FeatureStream as JStream
from repro.core.model_table import Entry as JEntry
from repro.uvm import trace as JT
from repro_torch import convert
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import baselines_nn as PB
from repro_torch.core import incremental as PI
from repro_torch.core import losses as PL
from repro_torch.core.model_table import Entry as PEntry
from repro_torch.uvm import registry as PREG
from repro_torch.uvm import trace as PT

KINDS = ("lstm", "cnn", "mlp")
SPECS = {"lstm": (JB.lstm_specs, PB.lstm_specs), "cnn": (JB.cnn_specs, PB.cnn_specs),
         "mlp": (JB.mlp_specs, PB.mlp_specs)}
TRAIN_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensors are small: one intra-op thread keeps its work
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def _batch(cfg, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "page": rng.integers(0, cfg.page_vocab, (n, cfg.history)).astype(np.int32),
        "delta": rng.integers(0, cfg.delta_vocab, (n, cfg.history)).astype(np.int32),
        "pc": rng.integers(0, cfg.pc_vocab, (n, cfg.history)).astype(np.int32),
        "tb": rng.integers(0, cfg.tb_vocab, (n, cfg.history)).astype(np.int32),
    }


def test_registry_lists_the_builtin_kinds_and_scopes():
    assert PREG.predictor_names() == ("transformer", "lstm", "cnn", "mlp")
    with pytest.raises(ValueError, match="already registered"):
        PREG.register_predictor("lstm", PB._builder_from_specs(PB.lstm_specs, PB.lstm_features))
    with PREG.scoped():
        PREG.register_predictor("toy", PB._builder_from_specs(PB.mlp_specs, PB.mlp_features))
        assert PI.Trainer(PC.SMOKE, PI.TrainConfig(), kind="toy", device="cpu").kind == "toy"
    assert "toy" not in PREG.predictor_names()
    with pytest.raises(KeyError, match="unknown predictor kind"):
        PI.Trainer(PC.SMOKE, PI.TrainConfig(), kind="gru", device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_specs_and_initial_weights_match(kind):
    js, ps = SPECS[kind][0](JC.SMOKE), SPECS[kind][1](PC.SMOKE)
    assert {k: (tuple(v.shape), v.init, v.scale) for k, v in js.items()} == \
        {k: (tuple(v.shape), v.init, v.scale) for k, v in ps.items()}
    jp = JI.Trainer(JC.SMOKE, JI.TrainConfig(), kind).new_params(4)
    pp = PI.Trainer(PC.SMOKE, PI.TrainConfig(), kind, device="cpu").new_params(4)
    for k, v in _np(jp).items():
        np.testing.assert_array_max_ulp(pp[k].numpy(), v, maxulp=1)


@pytest.mark.parametrize("kind", KINDS)
def test_features_logits_loss_and_gradient_match(kind):
    jinit, jfwd = JB.make_model(JC.SMOKE, kind)
    _, pfwd = PB.make_model(PC.SMOKE, kind)
    jparams = jinit(jax.random.key(7))
    pparams = convert.params_from_jax(_np(jparams), "cpu")
    batch = _batch(JC.SMOKE, 64, 3)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 20, 64).astype(np.int32)
    in_et = rng.random(64) < 0.4
    f_old = rng.standard_normal((64, JC.SMOKE.d_model)).astype(np.float32)

    def jloss(p):
        logits, f = jfwd(p, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, _ = JL.total_loss(logits, f, jnp.asarray(labels), n_active=20, f_old=jnp.asarray(f_old),
                                in_et=jnp.asarray(in_et), lam=JC.SMOKE.lucir_lambda, mu=JC.SMOKE.thrash_mu)
        return loss, (logits, f)

    (jl, (jlogits, jf)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    keys = list(pparams)
    leaves = [pparams[k].clone().requires_grad_(True) for k in keys]
    plogits, pf = pfwd(dict(zip(keys, leaves)), {k: torch.tensor(v) for k, v in batch.items()})
    pl = PL.train_loss(plogits, pf, torch.tensor(labels), n_active=20, f_old=torch.tensor(f_old),
                       in_et=torch.tensor(in_et.astype(np.int32)), n_et=int(in_et.sum()),
                       lam=PC.SMOKE.lucir_lambda, mu=PC.SMOKE.thrash_mu)
    grads = torch.autograd.grad(pl, leaves, allow_unused=True)
    np.testing.assert_allclose(pf.detach().numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plogits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-6 * PC.SMOKE.cosine_scale)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    for k, g in zip(keys, grads):
        got = np.zeros_like(np.asarray(jg[k])) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def _group(name="Hotspot", scale=0.1, lo=0, hi=700):
    vocab = JVocab(JC.SMOKE.delta_vocab)
    stream = JStream(JT.get_trace(name, scale), vocab, 10, page_vocab=64, pc_vocab=16, tb_vocab=16)
    return stream.windows(lo, hi), max(vocab.n_classes, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_one_train_group_matches_jax(kind):
    """30 steps from a fresh slot, LUCIR and the thrashing term on."""
    fs, n_active = _group()
    tc = dict(group_size=2048, epochs=3, batch_size=64)
    jt = JI.Trainer(JC.SMOKE, JI.TrainConfig(**tc), kind)
    p0, prev = jt.new_params(3), jt.new_params(5)
    et = np.random.default_rng(0).random(len(fs)) < 0.3
    je = jt.train_group(JEntry(params=p0, prev_params=prev), fs, n_active, in_et=et, use_lucir=True)
    pt = PI.Trainer(PC.SMOKE, PI.TrainConfig(**tc), kind, device="cpu")
    pe = pt.train_group(PEntry(params=convert.params_from_jax(_np(p0), "cpu"),
                               prev_params=convert.params_from_jax(_np(prev), "cpu")),
                        fs, n_active, in_et=et, use_lucir=True)
    assert (pe.step, pe.n_updates) == (je.step, je.n_updates) == (30, 1)
    assert max(float(np.abs(np.asarray(v) - pe.params[k].numpy()).max()) for k, v in je.params.items()) <= TRAIN_ATOL


@pytest.mark.parametrize("kind", ("transformer",) + KINDS)
def test_online_single_top1_matches_jax(kind):
    """The Fig. 10 protocol on a short trace, each package from its own
    fresh weights (``Trainer.new_params``)."""
    tc = dict(group_size=256, epochs=2, batch_size=64)
    jt, pt = JT.get_trace("ATAX", 0.1).slice(0, 1024), PT.get_trace("ATAX", 0.1).slice(0, 1024)
    jr = JI.run_protocol(jt, JC.SMOKE, JI.TrainConfig(**tc), mode="online_single", kind=kind)
    pr = PI.run_protocol(pt, PC.SMOKE, PI.TrainConfig(**tc), mode="online_single", kind=kind, device="cpu")
    assert round(pr.top1, 3) == round(jr.top1, 3)
    assert (pr.n_samples, pr.n_classes, pr.n_models) == (jr.n_samples, jr.n_classes, jr.n_models)
