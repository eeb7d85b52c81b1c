"""The port's dense LM (qwen2-0.5b) against the JAX package on the same
weights: the param specs at ``SMOKE`` and ``CONFIG``, the parameter count,
and ``forward`` / ``prefill`` / 8 ``decode_step``s at ``SMOKE`` on weights
from JAX's ``lm.init`` (biases and norm scales set non-zero from numpy)
carried across by ``convert.params_from_jax``.

Tolerances: float32 rtol/atol 1e-4 with equal argmax (the two compute the
same float32 functions; the sums run in other orders).  bf16: atol 2e-2 on
logits of about ±0.5 and 5e-2 on the K/V cache of about ±3 (a bf16 ulp is
2^-9 to 2^-8 on the logits, 2^-6 at the cache's largest values).  The port
rounds where the reference's code rounds, but compiled XLA on a CPU keeps
some intermediates in float32 (the bias add before rope) and evaluates
sigmoid with its own approximation, so about a quarter of the layer-1 keys
and half the MLP outputs differ from the port's by an ulp, which the second
layer carries on."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_0_5b as JQ
from repro.models import lm as JLM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs import qwen2_0_5b as PQ
from repro_torch.convert import params_from_jax
from repro_torch.models import lm as PLM
from repro_torch.models.params import numpy_params

N_DECODE = 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("name", ["SMOKE", "CONFIG"])
def test_param_specs_match(name):
    jc, pc = getattr(JQ, name), getattr(PQ, name)
    assert repr(jc).replace("repro.", "") == repr(pc).replace("repro_torch.", "")
    js, ps = JLM.param_specs(jc), PLM.param_specs(pc)
    assert sorted(js) == sorted(ps)
    for k in js:
        assert (tuple(js[k].shape), tuple(js[k].axes), js[k].init, js[k].scale) == \
            (tuple(ps[k].shape), tuple(ps[k].axes), ps[k].init, ps[k].scale), k
    assert JLM.param_count(jc) == PLM.param_count(pc) == pc.param_count()


def test_param_count_and_registry():
    assert PLM.param_count(PQ.CONFIG) == 494_147_456 == JLM.param_count(JQ.CONFIG)
    assert get_config("qwen2-0.5b") is PQ.CONFIG and get_smoke_config("qwen2-0.5b") is PQ.SMOKE
    with pytest.raises(KeyError, match="not ported"):
        get_config("whisper-medium")
    with pytest.raises(NotImplementedError, match="not ported"):
        PLM.param_specs(PQ.SMOKE.replace(family="encdec"))
    with pytest.raises(NotImplementedError, match="kv_quant"):
        PLM.param_specs(PQ.SMOKE.replace(kv_quant="int8"))


def test_numpy_params_are_reproducible_and_match_the_specs():
    specs = PLM.param_specs(PQ.SMOKE)
    a, b = numpy_params(specs, 3), numpy_params(specs, 3)
    assert sorted(a) == sorted(specs)
    for k, s in specs.items():
        assert a[k].dtype == np.float32 and a[k].shape == s.shape
        np.testing.assert_array_equal(a[k], b[k])
        if s.init == "zeros":
            assert not a[k].any()
        elif s.init == "ones":
            assert (a[k] == 1).all()
    emb = a["embed/embedding"]  # normal, scale 0.02
    assert abs(float(emb.std()) - 0.02) < 0.002
    assert not np.array_equal(numpy_params(specs, 4)["embed/embedding"], emb)


def _jax_params(cfg, seed=0):
    """JAX ``lm.init`` weights with biases and norm scales made non-zero."""
    params = {k: np.asarray(v) for k, v in JLM.init(jax.random.key(seed), cfg).items()}
    rng = np.random.default_rng(seed)
    for k, v in params.items():
        if k.endswith(("/bq", "/bk", "/bv")):
            params[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("/scale"):
            params[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_an_lm_init_tree(dtype):
    """forward, prefill and decode steps of the port on JAX-initialised
    weights equal JAX's on the same weights."""
    jcfg, pcfg = JQ.SMOKE.replace(dtype=dtype), PQ.SMOKE.replace(dtype=dtype)
    np_params = _jax_params(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    pparams = params_from_jax(np_params, "cpu")
    tol = TOL[dtype]
    rng = np.random.default_rng(11)
    B, S = 2, 40
    tokens = rng.integers(0, pcfg.vocab_size, (B, S)).astype(np.int32)

    jf, _ = jax.jit(lambda p, b: JLM.forward(p, b, jcfg))(jparams, {"tokens": jnp.asarray(tokens)})
    pf, _ = PLM.forward(pparams, {"tokens": torch.tensor(tokens)}, pcfg)
    np.testing.assert_allclose(_f32(pf), _f32(jf), rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(_f32(pf).argmax(-1), _f32(jf).argmax(-1))

    total = S + N_DECODE
    jl, jcache = jax.jit(JLM.make_prefill(jcfg))(jparams, {"tokens": jnp.asarray(tokens)})
    pl, pcache = PLM.make_prefill(pcfg)(pparams, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol, atol=tol)
    for name in ("k", "v"):
        assert pcache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(pcache[name]), _f32(jcache[name]), rtol=tol, atol=CACHE_TOL[dtype])
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0)]) for k, v in jcache.items()}
    pcache = {k: torch.cat([v, v.new_zeros((*v.shape[:2], N_DECODE, *v.shape[3:]))], 2) for k, v in pcache.items()}
    jdec = jax.jit(JLM.make_decode_step(jcfg))
    pdec = PLM.make_decode_step(pcfg)
    tok = tokens[:, -1]
    for i, pos in enumerate(range(S, total)):
        jl, jcache = jdec(jparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)}, jcache)
        pl, pcache = pdec(pparams, {"token": torch.tensor(tok), "pos": pos}, pcache)
        np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol, atol=tol, err_msg=f"decode step {i}")
        if dtype == "float32":
            np.testing.assert_array_equal(_f32(pl).argmax(-1), _f32(jl).argmax(-1))
        tok = _f32(jl)[:, -1].argmax(-1).astype(np.int32)  # teacher-forced on JAX's tokens
    np.testing.assert_allclose(_f32(pcache["k"]), _f32(jcache["k"]), rtol=tol, atol=CACHE_TOL[dtype])
