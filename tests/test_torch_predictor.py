"""The port's predictor against the JAX package on the same weights (the
JAX-initialised params copied across): features and cosine logits within
rtol 1e-5 / atol 1e-5 in float32 at ``SMOKE`` and ``CONFIG_QUICK``, with
equal argmax, top-k and ``Trainer.evaluate`` outputs; the plain attention
against the Pallas ``flash_attention`` in interpret mode at the predictor's
shapes; the frozen ``train_group`` bookkeeping."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import features as JF
from repro.core import incremental as JI
from repro.core import predictor as JP
from repro.kernels.flash_attention import kernel as JFA
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as JL
from repro.uvm import trace as JT
from repro_torch.configs import predictor_paper as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import features as PF
from repro_torch.core import incremental as PI
from repro_torch.core import predictor as PP
from repro_torch.core.model_table import Entry, ModelTable
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as PL
from repro_torch.uvm import trace as PT

RTOL = ATOL = 1e-5
CONFIGS = {"SMOKE": (JC.SMOKE, PC.SMOKE), "CONFIG_QUICK": (JC.CONFIG_QUICK, PC.CONFIG_QUICK)}


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return {
        "page": rng.integers(0, cfg.page_vocab, (n, cfg.history)).astype(np.int32),
        "delta": rng.integers(0, cfg.delta_vocab, (n, cfg.history)).astype(np.int32),
        "pc": rng.integers(0, cfg.pc_vocab, (n, cfg.history)).astype(np.int32),
        "tb": rng.integers(0, cfg.tb_vocab, (n, cfg.history)).astype(np.int32),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_specs_match(name):
    jc, pc = CONFIGS[name]
    js, ps = JP.param_specs(jc), PP.param_specs(pc)
    assert sorted(js) == sorted(ps)
    for k in js:
        assert tuple(js[k].shape) == tuple(ps[k].shape), k
        assert (js[k].init, js[k].scale) == (ps[k].init, ps[k].scale), k
    assert JP.param_count(jc) == PP.param_count(pc)
    got = PP.init(0, pc, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(s.shape) for k, s in ps.items()}
    assert JP.param_count(JC.CONFIG) == 632_066 == PP.param_count(PC.CONFIG)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_features_and_logits_match(name):
    jc, pc = CONFIGS[name]
    jparams = JP.init(jax.random.key(3), jc)
    pparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    batch = _batch(jc, 96, 7)
    jl, jf = JP.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    with torch.no_grad():
        pl, pf = PP.forward(pparams, {k: torch.tensor(v) for k, v in batch.items()}, pc)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    jv, ji = JP.predict_topk(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc, k=3, n_active=9)
    with torch.no_grad():
        pv, pi = PP.predict_topk(pparams, {k: torch.tensor(v) for k, v in batch.items()}, pc, k=3, n_active=9)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trainer_evaluate_matches(name):
    jc, pc = CONFIGS[name]
    tj = JT.get_trace("NW", 0.5)
    kw = dict(page_vocab=jc.page_vocab, pc_vocab=jc.pc_vocab, tb_vocab=jc.tb_vocab)
    jv, pv = JF.DeltaVocab(jc.delta_vocab), PF.DeltaVocab(pc.delta_vocab)
    fs_j = JF.FeatureStream(tj, jv, jc.history, **kw).windows(0, 700)
    fs_p = PF.FeatureStream(PT.get_trace("NW", 0.5), pv, pc.history, **kw).windows(0, 700)
    n_active = max(jv.n_classes, 2)
    tc = JI.TrainConfig(group_size=2048, epochs=0, batch_size=64)
    jtr = JI.Trainer(jc, tc)
    ptr = PI.Trainer(pc, PI.TrainConfig(group_size=2048, epochs=0, batch_size=64), device="cpu")
    jparams = jtr.new_params(1)
    pparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jc_, jp_ = jtr.evaluate(jparams, fs_j, n_active)
    pc_, pp_ = ptr.evaluate(pparams, fs_p, n_active)
    assert (jc_.dtype, jp_.dtype) == (pc_.dtype, pp_.dtype)
    np.testing.assert_array_equal(pc_, jc_)
    np.testing.assert_array_equal(pp_, jp_)
    e0, p0 = ptr.evaluate(pparams, fs_p.slice(0, 0), n_active)
    assert e0.shape == p0.shape == (0,)


def test_frozen_train_group_bookkeeping():
    """epochs=0: the JAX trainer initialises zero moments, takes no step and
    counts the update; the port does exactly that."""
    jc, pc = CONFIGS["SMOKE"]
    tj = JT.get_trace("NW", 0.5)
    fs = JF.FeatureStream(tj, JF.DeltaVocab(jc.delta_vocab), jc.history).windows(0, 300)
    jtr = JI.Trainer(jc, JI.TrainConfig(epochs=0))
    ptr = PI.Trainer(pc, PI.TrainConfig(epochs=0), device="cpu")
    jparams = jtr.new_params(2)
    je = jtr.train_group(JI.Entry(params=jparams), fs, 5)
    pe = ptr.train_group(Entry(params=params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")),
                         fs, 5)
    assert (pe.step, pe.n_updates) == (je.step, je.n_updates) == (0, 1)
    for k, v in je.params.items():
        np.testing.assert_array_equal(pe.params[k].numpy(), np.asarray(v))
    for part in ("m", "v"):
        for k, v in getattr(je.opt_state, part).items():
            np.testing.assert_array_equal(getattr(pe.opt_state, part)[k].numpy(), np.asarray(v))
    table = ModelTable(lambda s: {"w": torch.zeros(2)}, n_slots=8)
    table.snapshot_prev(3)
    t2 = table.clone()
    t2.slots[3].params["w"] += 1
    assert table.slots[3].params["w"].sum() == 0 and table.slots[3].prev_params["w"].sum() == 0
    assert (table.misses, table.hits, t2.n_models) == (1, 0, 1)


@pytest.mark.parametrize("B,S,K,G,D,kw", [
    (16, 10, 2, 1, 32, {}),  # the predictor's attention (CONFIG: d 64, 2 heads)
    (4, 10, 1, 2, 8, {"causal": False, "kv_len": 6, "q_offset": 3}),
])
def test_plain_attention_matches_pallas_flash_attention(B, S, K, G, D, kw):
    rng = np.random.default_rng(B + S + D)
    q = rng.standard_normal((B, S, K, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    got = FA.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(JFA.flash_attention(q, k, v, interpret=True, **kw)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(attention_ref(q, k, v, **kw)), rtol=RTOL, atol=ATOL)
    ckw = {"q_offset": kw.get("q_offset", 0), "causal": kw.get("causal", True), "kv_len": kw.get("kv_len")}
    np.testing.assert_allclose(got, np.asarray(JL._attend_chunked(q, k, v, **ckw)), rtol=RTOL, atol=ATOL)


def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, 2, 32)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    np.testing.assert_allclose(PL.rope(torch.tensor(x), torch.tensor(pos), 1e4).numpy(),
                               np.asarray(JL.rope(x, pos, 1e4)), rtol=RTOL, atol=ATOL)
    h = rng.standard_normal((3, 10, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(PL.rms_norm(torch.tensor(h), torch.tensor(s)).numpy(),
                               np.asarray(JL.rms_norm(h, s)), rtol=RTOL, atol=ATOL)
