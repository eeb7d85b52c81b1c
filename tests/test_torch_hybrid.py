"""The port's hybrid LM (zamba2-7b) and the two dense configs that need only
their config modules (qwen1.5-4b, granite-3-8b), against the JAX package on
the same weights: the param and cache specs at ``SMOKE`` and ``CONFIG``, the
parameter counts, JAX's own initial weights, ``forward`` / ``prefill``
(logits and every cache entry) / 8 ``decode_step``s at ``SMOKE`` (also with
no tail layer and at head width 112), ``Engine.generate`` and the
``launch.serve`` entry point.

The JAX model's SSD goes through its default path (``ssd_ref``) in float32,
where it equals the Pallas kernel bit for bit; in bf16 it is routed through
``ssd_pallas(..., interpret=True)`` (by ``monkeypatch``), as the exported
reference of the card's run is, since in bf16 the default path rounds the
state, the weights and ``decay*dt`` to bf16 where the kernel, and the port,
keep float32.

Tolerances (``TOL``): float32 rtol/atol 1e-4 with equal argmax (the same
float32 functions, sums in other orders), but the keys and values are
float32 numbers rounded to the bf16 cache, where a sum in another order can
flip one bf16 ulp (rtol 2^-7), and the float32 decode steps read that cache,
so a flipped key moves their logits (measured up to 5e-4; atol 2e-3).  bf16:
the Mamba-2 layers differ from compiled XLA's by an ulp here and there
(``tests/test_torch_mamba2.py`` says where), and five bf16 layers of this
random-weight model amplify an ulp: moving one bf16 ulp in 1% of one weight
tensor moves JAX's own logits (about +-5) by 0.33, and its float32 run is
0.81 away.  So bf16 is held, at rtol 2^-7 (one ulp), only within atol 0.75
on the logits (0.40 needed on these weights, up to 0.63 over three
seeds), 0.5 on the decode steps' (0.27 needed, at most 0.27 over three
seeds) and 0.3 on the caches (up to 0.25); the float32 test is the tight
one.  Faults planted in the hybrid fail these limits: one application's
cache slot read or written for another's (k, v off by 1.7-2.9), the
decode's cache position one off (2.6), the shared MLP dropped at the
second application in decode (1.3) or norm1 used for norm2 (2.4 on the
logits), the final norm applied twice in decode (0.72 against 0.5); the
SSM state rounded to bf16 in the cache passes them, and only the float32
test catches it.  The dense
configs: ``tests/test_torch_lm.py``'s weights, and its limits but on their
larger logits (``DENSE_TOL``).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels.ssd_scan import kernel as JK
from repro.kernels.ssd_scan import ops as JOPS
from repro.launch import serve as JS
from repro.models import hybrid as JH
from repro.models import lm as JLM
from repro.serving import engine as JE
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as PS
from repro_torch.models import hybrid as PH
from repro_torch.models import lm as PLM
from repro_torch.models.params import init_params_jax, numpy_params
from repro_torch.serving import engine as PE

N_DECODE = 8
ARCHS = ("zamba2-7b", "qwen1.5-4b", "granite-3-8b")
COUNTS = {"zamba2-7b": 6_751_130_832, "qwen1.5-4b": 3_951_024_640, "granite-3-8b": 8_374_259_712}
# (rtol, atol) per quantity: logits of the forward and the prefill, of the
# decode steps, the conv tails and SSM states, the keys and values
TOL = {"float32": {"logits": (1e-4, 1e-4), "decode": (1e-4, 2e-3), "state": (1e-4, 1e-4),
                   "kv": (2.0 ** -7, 1e-4)},
       "bfloat16": {"logits": (2.0 ** -7, 0.75), "decode": (2.0 ** -7, 0.5), "state": (2.0 ** -7, 0.3),
                    "kv": (2.0 ** -7, 0.3)}}
# the dense configs: the float32 limits above; in bf16 tests/test_torch_lm.py's
# on the keys and values, and atol 0.1 on logits of about +-5 (an untied
# unembedding; qwen2's tied one gives +-0.7), where a bf16 ulp is 2^-5 and
# the port was two ulps from JAX over three seeds
DENSE_TOL = {"float32": TOL["float32"],
             "bfloat16": {"logits": (2e-2, 0.1), "decode": (2e-2, 0.1), "kv": (2e-2, 5e-2)}}
STATE_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")


def _route_jax_ssd_through_the_kernel(monkeypatch):
    def ssd(x, dt, A_log, b, c, *, chunk, initial_state=None):
        return JK.ssd_pallas(x, dt, A_log, b, c, chunk=chunk, initial_state=initial_state, interpret=True)

    monkeypatch.setattr(JOPS, "ssd", ssd)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["SMOKE", "CONFIG"])
def test_param_specs_match(arch, name):
    jc = j_get_smoke_config(arch) if name == "SMOKE" else j_get_config(arch)
    pc = get_smoke_config(arch) if name == "SMOKE" else get_config(arch)
    assert repr(jc).replace("repro.", "") == repr(pc).replace("repro_torch.", "")
    js, ps = JLM.param_specs(jc), PLM.param_specs(pc)
    assert sorted(js) == sorted(ps)
    for k in js:
        assert (tuple(js[k].shape), tuple(js[k].axes), js[k].init, js[k].scale) == \
            (tuple(ps[k].shape), tuple(ps[k].axes), ps[k].init, ps[k].scale), k
    jcs, pcs = JLM.module(jc).cache_specs(jc, 2, 64), PLM.module(pc).cache_specs(pc, 2, 64)
    assert {k: (tuple(s.shape), tuple(s.axes), s.init) for k, s in jcs.items()} == \
        {k: (tuple(s.shape), tuple(s.axes), s.init) for k, s in pcs.items()}
    assert JLM.param_count(jc) == PLM.param_count(pc) == pc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_registry(arch):
    cfg = get_config(arch)
    assert PLM.param_count(cfg) == COUNTS[arch] == JLM.param_count(j_get_config(arch))
    assert get_smoke_config(arch).name == f"{arch}-smoke"
    assert PLM.module(cfg) is (PH if arch == "zamba2-7b" else PLM.FAMILIES["dense"])


def test_group_layout_matches_jax():
    for n in (1, 5, 6, 12, 15, 81):
        cfg = j_get_config("zamba2-7b").replace(num_layers=n)
        assert PH.group_layout(cfg) == JH.group_layout(cfg)
    assert PH.group_layout(get_config("zamba2-7b")) == (13, 6, 3)


def _ulps(a, b):
    ia, ib = (x.view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(x < 0, -(2**31) - x, x) for x in (ia, ib))
    return np.abs(ia - ib)


def test_init_params_jax_equals_lm_init():
    """The JAX package's own initial weights, drawn in the port, within 3
    ulp (``tests/test_torch_random.py``: XLA's and the port's ErfInv round
    differently in a few elements)."""
    jcfg, pcfg = j_get_smoke_config("zamba2-7b"), get_smoke_config("zamba2-7b")
    want = {k: np.asarray(v) for k, v in JLM.init(jax.random.key(0), jcfg).items()}
    got = init_params_jax(0, PLM.param_specs(pcfg), device="cpu")
    assert sorted(got) == sorted(want)
    n = n_diff = 0
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == np.float32, k
        d = _ulps(g.reshape(-1), v.reshape(-1))
        assert d.max(initial=0) <= 3, k
        n, n_diff = n + d.size, n_diff + np.count_nonzero(d)
    assert n_diff <= 5e-5 * n


def _weights(cfg, seed=0):
    """``numpy_params`` with the zero and one initialisers made non-trivial
    (decay rates, dt biases, skips, conv and qkv biases, norm scales)."""
    params = numpy_params(PLM.param_specs(cfg), seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if k.endswith(("/A_log", "/dt_bias", "/conv_bx", "/conv_bB", "/conv_bC", "/bq", "/bk", "/bv")):
            params[k] = (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(("/scale", "/gate_norm", "/Dskip")):
            params[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


def _lm_weights(cfg, seed=0):
    """JAX ``lm.init`` weights with the qkv biases and norm scales made
    non-zero (``tests/test_torch_lm.py``'s)."""
    params = {k: np.asarray(v) for k, v in JLM.init(jax.random.key(seed), cfg).items()}
    rng = np.random.default_rng(seed)
    for k, v in params.items():
        if k.endswith(("/bq", "/bk", "/bv")):
            params[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("/scale"):
            params[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol[0], atol=tol[1], err_msg=msg)


def _hold_to_jax(jcfg, pcfg, weights, S, tol):
    """forward, prefill (every cache entry) and N_DECODE decode steps,
    teacher-forced on JAX's tokens, of the port against JAX's, within
    ``tol`` (a ``TOL`` entry)."""
    jparams = {k: jnp.asarray(v) for k, v in weights.items()}
    pparams = {k: torch.tensor(v) for k, v in weights.items()}
    exact = pcfg.dtype == "float32"
    tokens = np.random.default_rng(11).integers(0, pcfg.vocab_size, (2, S)).astype(np.int32)

    jf, _ = jax.jit(lambda p, b: JLM.forward(p, b, jcfg))(jparams, {"tokens": jnp.asarray(tokens)})
    pf, _ = PLM.forward(pparams, {"tokens": torch.tensor(tokens)}, pcfg)
    _close(pf, jf, tol["logits"])
    if exact:
        np.testing.assert_array_equal(_f32(pf).argmax(-1), _f32(jf).argmax(-1))

    jl, jcache = jax.jit(JLM.make_prefill(jcfg))(jparams, {"tokens": jnp.asarray(tokens)})
    pl, pcache = PLM.make_prefill(pcfg)(pparams, {"tokens": torch.tensor(tokens)})
    _close(pl, jl, tol["logits"])
    assert sorted(pcache) == sorted(jcache)

    def hold_cache():
        for name in pcache:
            assert str(pcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype), name
            assert tuple(pcache[name].shape) == jcache[name].shape, name
            _close(pcache[name], jcache[name], tol["kv" if name in ("k", "v") else "state"], name)

    hold_cache()
    # both caches grown to S + N_DECODE along their sequence axis, as the engines grow them
    grow = lambda a: a if a.ndim < 3 or a.shape[2] != S else jnp.pad(a, [(0, 0), (0, 0), (0, N_DECODE)] + [(0, 0)] * (a.ndim - 3))
    jcache = {k: (grow(v) if k in ("k", "v") else v) for k, v in jcache.items()}
    pcache = {k: (torch.cat([v, v.new_zeros((*v.shape[:2], N_DECODE, *v.shape[3:]))], 2) if k in ("k", "v") else v)
              for k, v in pcache.items()}
    jdec, pdec = jax.jit(JLM.make_decode_step(jcfg)), PLM.make_decode_step(pcfg)
    tok = tokens[:, -1]
    for i, pos in enumerate(range(S, S + N_DECODE)):
        jl, jcache = jdec(jparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)}, jcache)
        pl, pcache = pdec(pparams, {"token": torch.tensor(tok), "pos": pos}, pcache)
        _close(pl, jl, tol["decode"], f"decode step {i}")
        if exact:
            np.testing.assert_array_equal(_f32(pl).argmax(-1), _f32(jl).argmax(-1))
        tok = _f32(jl)[:, -1].argmax(-1).astype(np.int32)  # teacher-forced on JAX's tokens
    hold_cache()
    return pcache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_jax(dtype, monkeypatch):
    """SMOKE: 5 layers, two applications of the shared block and a tail layer."""
    if dtype == "bfloat16":
        _route_jax_ssd_through_the_kernel(monkeypatch)
    jcfg = j_get_smoke_config("zamba2-7b").replace(dtype=dtype)
    pcfg = get_smoke_config("zamba2-7b").replace(dtype=dtype)
    assert PH.group_layout(pcfg) == (2, 2, 1)
    pcache = _hold_to_jax(jcfg, pcfg, _weights(pcfg), 48, TOL[dtype])
    assert pcache["ssm"].dtype == torch.float32 and pcache["k"].dtype == torch.bfloat16
    assert pcache["conv_x"].dtype == PLM.compute_dtype(pcfg)
    assert tuple(pcache["k"].shape) == (2, 2, 48 + N_DECODE, pcfg.num_kv_heads, pcfg.head_dim)


@pytest.mark.parametrize("layout", ["no_tail", "head_dim_112"])
def test_other_layouts_match_jax(layout):
    """Two groups and no tail layer (num_layers a multiple of attn_every),
    and zamba2's head width 112 (the CUDA kernels' new instances) at SMOKE
    widths, in float32."""
    kw = {"num_layers": 4} if layout == "no_tail" else {"head_dim": 112}
    jcfg = j_get_smoke_config("zamba2-7b").replace(dtype="float32", **kw)
    pcfg = get_smoke_config("zamba2-7b").replace(dtype="float32", **kw)
    assert PH.group_layout(pcfg)[2] == (0 if layout == "no_tail" else 1)
    _hold_to_jax(jcfg, pcfg, _weights(pcfg, seed=2), 32, TOL["float32"])


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-3-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_configs_match_jax(arch, dtype):
    jcfg, pcfg = j_get_smoke_config(arch).replace(dtype=dtype), get_smoke_config(arch).replace(dtype=dtype)
    _hold_to_jax(jcfg, pcfg, _lm_weights(jcfg), 40, DENSE_TOL[dtype])


def test_decode_equals_teacher_forcing():
    """Prefill 32 tokens, then decode the next 15 of the same sequence: the
    recurrence and the cached attention give the forward's logits there,
    within 1e-2, since the decode steps read bf16 keys and values where the
    forward keeps float32 ones (measured 2.3e-3; one position off: 0.30)."""
    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32")
    params = {k: torch.tensor(v) for k, v in _weights(cfg, seed=3).items()}
    tokens = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 48)))
    full, _ = PLM.forward(params, {"tokens": tokens}, cfg)
    logits, cache = PLM.make_prefill(cfg)(params, {"tokens": tokens[:, :32]})
    torch.testing.assert_close(logits[:, 0], full[:, 31], rtol=1e-4, atol=1e-4)
    cache = PE.Engine._grow_cache(cache, 48)
    assert cache["k"].shape[2] == 48 and cache["conv_x"].shape[2] == cfg.conv_width - 1
    dec = PLM.make_decode_step(cfg)
    for pos in range(32, 47):
        logits, cache = dec(params, {"token": tokens[:, pos], "pos": pos}, cache)
        torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def engines():
    jcfg = j_get_smoke_config("zamba2-7b").replace(dtype="float32")
    pcfg = get_smoke_config("zamba2-7b").replace(dtype="float32")
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


def test_engine_builds_no_offload_manager_for_the_hybrid(engines):
    """The reference offloads only the dense, moe, vlm and encdec families:
    ``learned`` gives no stats for the hybrid, though it has a KV cache."""
    je, pe, prompt = engines
    assert "hybrid" not in PE.KV_FAMILIES
    assert pe.make_manager(96) is None
    assert pe.generate({"tokens": prompt}, 2).offload_stats is None
    assert je.generate({"tokens": jnp.asarray(prompt)}, 2).offload_stats is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_prints_the_reference_keys(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "32", "--new-tokens", "4",
            "--offload", "learned"]
    assert PS.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert JS.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["arch"] == want["arch"] == f"{arch}-smoke"
    assert got["generated_shape"] == want["generated_shape"] == [2, 4]
    assert (got["offload"] is None) == (want["offload"] is None) == (arch == "zamba2-7b")
    if arch != "zamba2-7b":
        assert sorted(got["offload"]) == sorted(want["offload"])


def test_a_ragged_prompt_raises_in_both_packages():
    """The hybrid's SSD takes only whole chunks (16 tokens at SMOKE)."""
    argv = ["--arch", "zamba2-7b", "--smoke", "--batch", "1", "--prompt-len", "20", "--new-tokens", "2"]
    with pytest.raises(ValueError):
        PS.main([*argv, "--device", "cpu"])
    with pytest.raises(ValueError):
        JS.main(argv)
