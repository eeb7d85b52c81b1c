"""The port's Mamba-2 LM (mamba2-370m, the ssm family) against the JAX
package on the same weights: the param specs at ``SMOKE`` and ``CONFIG``,
the parameter count, ``forward`` / ``prefill`` (logits and all four cache
entries) / 8 ``decode_step``s at ``SMOKE``, decode against teacher forcing,
``Engine.generate`` and the ``launch.serve`` entry point.

The JAX model's SSD goes through its default path (``ssd_ref``) in float32,
where it equals the Pallas kernel bit for bit; in bf16 it is routed
through ``ssd_pallas(..., interpret=True)`` (by ``monkeypatch``), since in
bf16 the default path rounds the state, the weights and ``decay*dt`` to
bf16 where the kernel, and the port, keep float32.

Tolerances: float32 rtol/atol 1e-4 with equal argmax (the same float32
functions, sums in other orders).  bf16: the port rounds where the
reference's lax ops round (silu as ``x * (1 / (1 + exp(-x)))``, softplus
as ``logaddexp``), but compiled XLA on a CPU keeps some bf16 intermediates
of its fusions in float32 (the gate product before the grouped norm), so
about half the mixer's outputs differ from the port's by an ulp, and the
SSD's recurrence carries that on: logits of about +-5 (a bf16 ulp 2^-6 to
2^-5) within atol 0.3 (measured up to 0.26 over three weight seeds, 0.14
on this one), the conv tails (about +-3) and the float32 SSM state (up to
about 2) within 5e-2.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_370m as JM
from repro.kernels.ssd_scan import kernel as JK
from repro.kernels.ssd_scan import ops as JOPS
from repro.launch import serve as JS
from repro.models import lm as JLM
from repro.serving import engine as JE
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs import mamba2_370m as PM
from repro_torch.launch import serve as PS
from repro_torch.models import lm as PLM
from repro_torch.models.params import numpy_params
from repro_torch.serving import engine as PE

N_DECODE = 8
TOL = {"float32": 1e-4, "bfloat16": 0.3}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CACHE_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")


def _route_jax_ssd_through_the_kernel(monkeypatch):
    def ssd(x, dt, A_log, b, c, *, chunk, initial_state=None):
        return JK.ssd_pallas(x, dt, A_log, b, c, chunk=chunk, initial_state=initial_state, interpret=True)

    monkeypatch.setattr(JOPS, "ssd", ssd)


@pytest.mark.parametrize("name", ["SMOKE", "CONFIG"])
def test_param_specs_match(name):
    jc, pc = getattr(JM, name), getattr(PM, name)
    assert repr(jc).replace("repro.", "") == repr(pc).replace("repro_torch.", "")
    js, ps = JLM.param_specs(jc), PLM.param_specs(pc)
    assert sorted(js) == sorted(ps)
    for k in js:
        assert (tuple(js[k].shape), tuple(js[k].axes), js[k].init, js[k].scale) == \
            (tuple(ps[k].shape), tuple(ps[k].axes), ps[k].init, ps[k].scale), k
    jcs, pcs = JLM.module(jc).cache_specs(jc, 2, 64), PLM.module(pc).cache_specs(pc, 2, 64)
    assert {k: (tuple(s.shape), tuple(s.axes)) for k, s in jcs.items()} == \
        {k: (tuple(s.shape), tuple(s.axes)) for k, s in pcs.items()}
    assert JLM.param_count(jc) == PLM.param_count(pc) == pc.param_count()


def test_param_count_and_registry():
    assert PLM.param_count(PM.CONFIG) == 420_136_448 == JLM.param_count(JM.CONFIG)
    assert get_config("mamba2-370m") is PM.CONFIG and get_smoke_config("mamba2-370m") is PM.SMOKE


def _weights(cfg, seed=0):
    """``numpy_params`` with the zero and one initialisers made non-trivial
    (decay rates, dt biases, skips, conv biases, norm scales)."""
    params = numpy_params(PLM.param_specs(cfg), seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if k.endswith(("/A_log", "/dt_bias", "/conv_bx", "/conv_bB", "/conv_bC")):
            params[k] = (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(("/scale", "/gate_norm", "/Dskip")):
            params[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_jax(dtype, monkeypatch):
    if dtype == "bfloat16":
        _route_jax_ssd_through_the_kernel(monkeypatch)
    jcfg, pcfg = JM.SMOKE.replace(dtype=dtype), PM.SMOKE.replace(dtype=dtype)
    weights = _weights(pcfg)
    jparams = {k: jnp.asarray(v) for k, v in weights.items()}
    pparams = {k: torch.tensor(v) for k, v in weights.items()}
    tol = TOL[dtype]
    rng = np.random.default_rng(11)
    B, S = 2, 48
    tokens = rng.integers(0, pcfg.vocab_size, (B, S)).astype(np.int32)

    jf, _ = jax.jit(lambda p, b: JLM.forward(p, b, jcfg))(jparams, {"tokens": jnp.asarray(tokens)})
    pf, _ = PLM.forward(pparams, {"tokens": torch.tensor(tokens)}, pcfg)
    np.testing.assert_allclose(_f32(pf), _f32(jf), rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(_f32(pf).argmax(-1), _f32(jf).argmax(-1))

    jl, jcache = jax.jit(JLM.make_prefill(jcfg))(jparams, {"tokens": jnp.asarray(tokens)})
    pl, pcache = PLM.make_prefill(pcfg)(pparams, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol, atol=tol)
    assert sorted(pcache) == sorted(jcache) == sorted(CACHE_KEYS)
    for name in CACHE_KEYS:
        assert str(pcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype), name
        assert tuple(pcache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(_f32(pcache[name]), _f32(jcache[name]), rtol=CACHE_TOL[dtype],
                                   atol=CACHE_TOL[dtype], err_msg=name)
    assert pcache["ssm"].dtype == torch.float32
    assert pcache["conv_x"].dtype == PLM.compute_dtype(pcfg)

    jdec = jax.jit(JLM.make_decode_step(jcfg))
    pdec = PLM.make_decode_step(pcfg)
    tok = tokens[:, -1]
    for i, pos in enumerate(range(S, S + N_DECODE)):
        jl, jcache = jdec(jparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)}, jcache)
        pl, pcache = pdec(pparams, {"token": torch.tensor(tok), "pos": pos}, pcache)
        np.testing.assert_allclose(_f32(pl), _f32(jl), rtol=tol, atol=tol, err_msg=f"decode step {i}")
        if dtype == "float32":
            np.testing.assert_array_equal(_f32(pl).argmax(-1), _f32(jl).argmax(-1))
        tok = _f32(jl)[:, -1].argmax(-1).astype(np.int32)  # teacher-forced on JAX's tokens
    for name in CACHE_KEYS:
        np.testing.assert_allclose(_f32(pcache[name]), _f32(jcache[name]), rtol=CACHE_TOL[dtype],
                                   atol=CACHE_TOL[dtype], err_msg=name)


def test_decode_equals_teacher_forcing():
    """Prefill 32 tokens, then decode the next 16 of the same sequence: the
    recurrence gives the chunked forward's logits at those positions."""
    cfg = PM.SMOKE.replace(dtype="float32")
    params = {k: torch.tensor(v) for k, v in _weights(cfg, seed=3).items()}
    tokens = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 48)))
    full, _ = PLM.forward(params, {"tokens": tokens}, cfg)
    logits, cache = PLM.make_prefill(cfg)(params, {"tokens": tokens[:, :32]})
    torch.testing.assert_close(logits[:, 0], full[:, 31], rtol=1e-4, atol=1e-4)
    dec = PLM.make_decode_step(cfg)
    for pos in range(32, 47):
        logits, cache = dec(params, {"token": tokens[:, pos], "pos": pos}, cache)
        torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def engines():
    jcfg, pcfg = JM.SMOKE.replace(dtype="float32"), PM.SMOKE.replace(dtype="float32")
    weights = _weights(pcfg, seed=1)
    prompt = np.random.default_rng(1).integers(0, pcfg.vocab_size, (2, 64)).astype(np.int32)
    je = JE.Engine(jcfg, {k: jnp.asarray(v) for k, v in weights.items()}, offload="learned")
    pe = PE.Engine(pcfg, {k: torch.tensor(v) for k, v in weights.items()}, offload="learned", device="cpu")
    return je, pe, prompt


def test_engine_generate_matches_jax(engines):
    je, pe, prompt = engines
    jr = je.generate({"tokens": jnp.asarray(prompt)}, 24, pad_to=96)
    pr = pe.generate({"tokens": prompt}, 24, pad_to=96)
    np.testing.assert_array_equal(pr.tokens, np.asarray(jr.tokens))
    assert pr.steps == jr.steps == 24


def test_engine_builds_no_offload_manager_without_a_kv_cache(engines):
    """The reference offloads only families with a KV cache: ``learned``
    gives no stats for the ssm family, in both packages."""
    je, pe, prompt = engines
    assert pe.make_manager(96) is None
    assert pe.generate({"tokens": prompt}, 2).offload_stats is None
    assert je.generate({"tokens": jnp.asarray(prompt)}, 2).offload_stats is None


def test_serve_entry_point_prints_the_reference_keys(capsys):
    argv = ["--arch", "mamba2-370m", "--smoke", "--batch", "2", "--prompt-len", "32", "--new-tokens", "4",
            "--offload", "learned"]
    assert PS.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert JS.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["arch"] == want["arch"] == "mamba2-370m-smoke"
    assert got["generated_shape"] == want["generated_shape"] == [2, 4]
    assert got["offload"] is None and want["offload"] is None and len(got["first_seq"]) == 4


def test_a_ragged_prompt_raises_in_both_packages():
    """The SSD takes only whole chunks (16 tokens at SMOKE)."""
    argv = ["--arch", "mamba2-370m", "--smoke", "--batch", "1", "--prompt-len", "20", "--new-tokens", "2"]
    with pytest.raises(ValueError, match="not divisible by chunk"):
        PS.main([*argv, "--device", "cpu"])
    with pytest.raises(ValueError, match="not divisible by chunk"):
        JS.main(argv)
