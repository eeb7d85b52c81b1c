"""The port's mixture-of-experts family (olmoe-1b-7b, qwen2-moe-a2.7b) and
the dense qwen3-0.6b with its ``qk_norm``, against the JAX package on the
same weights: the param and cache specs at ``SMOKE`` and ``CONFIG``, the
parameter and active-parameter counts, JAX's own initial weights, the MoE
layer alone against the reference's scatter path (``_moe_ffn_scatter``)
with its routing (experts, slots, drops) equal bit for bit, ``forward`` /
``prefill`` (logits and every cache entry) / 8 ``decode_step``s at
``SMOKE``, ``Engine.generate`` with the ``learned`` offload and the
``launch.serve`` entry point.  Nothing here builds ``CONFIG`` weights.

Routing: the expert ids, slots and drops are integers and are held equal
to JAX's (``repro.models.moe._local_dispatch``, the reference's own
routing code, on the same float32 logits); a capacity factor of 0.4 forces
drops, ``num_experts=20`` pads 20 experts to 32 (``SMOKE`` has at most 8,
so it never pads), and qwen2-moe's ``SMOKE`` has shared experts.

Tolerances (``FFN_TOL``, ``TOL``), as measured: float32 rtol/atol 1e-5 on
the MoE layer's output (6e-7 needed: sums in another order) and 1e-4 on
logits, with equal argmax, as ``tests/test_torch_lm.py``; the keys and
values are float32 numbers rounded to the bf16 cache, where a sum in
another order can flip one bf16 ulp (rtol 2^-7), and the float32 decode
steps read that cache (3.6e-4 needed; atol 2e-3, as the hybrid's test).
bf16: the combine adds each token's k outputs in choice order, rounding
after each add, as the reference's scatter-add; ``combine`` equals JAX's
bit for bit on the same expert outputs (``test_combine_order``).  The rest
differs by XLA's own bf16 sigmoid, which rounds after each of its
operations where ``torch.sigmoid`` rounds once (a third of the SwiGLU
outputs one ulp apart), so the layer is held at rtol 2^-7 within atol 0.05
(0.031 needed).  Through the models those ulps move the router's
probabilities by up to 0.006, enough to send a token whose k-th and
(k+1)-th experts are that close elsewhere: such a token must be a near tie
in JAX's router (``ROUTE_GAP``), and each row is compared up to its first
one; there the two-layer models are held within atol 0.2 on logits of
about +-2 (0.11 needed), on the decode steps' (0.08) and 0.15 on the
caches (0.077).  In float32 the routes are equal throughout.  Faults
planted in a copy fail these tests: padded experts left unmasked or the
capacity taken over the padded count (the routing, ``padded``),
``torch.topk`` for the stable sort (the tie test), a combine summed once
in float32 (``test_combine_order``), the shared experts' gate dropped, and
the k norm dropped (the model tests).
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch import serve as JS
from repro.models import lm as JLM
from repro.models import moe as JM
from repro.serving import engine as JE
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as PS
from repro_torch.models import lm as PLM
from repro_torch.models import moe as PM
from repro_torch.models.params import init_params_jax, numpy_params
from repro_torch.serving import engine as PE

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import export_torch_reference as E  # noqa: E402

N_DECODE = 8
ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b", "qwen3-0.6b")
COUNTS = {"olmoe-1b-7b": 6_919_624_704, "qwen2-moe-a2.7b": 15_146_977_280, "qwen3-0.6b": 596_180_992}
FFN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 0.05)}
# (rtol, atol): logits of the forward and the prefill, of the decode steps, the keys and values
TOL = {"float32": {"logits": (1e-4, 1e-4), "decode": (1e-4, 2e-3), "kv": (2.0 ** -7, 1e-4)},
       "bfloat16": {"logits": (2.0 ** -7, 0.2), "decode": (2.0 ** -7, 0.2), "kv": (2.0 ** -7, 0.15)}}
# a bf16 route may differ from JAX's only where JAX's k-th and (k+1)-th
# router probabilities are this close (bf16 moves them by up to 0.006 here)
ROUTE_GAP = 0.02
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    assert JLM.active_param_count(jc) == PLM.active_param_count(pc)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_registry(arch):
    cfg = get_config(arch)
    assert PLM.param_count(cfg) == COUNTS[arch] == JLM.param_count(j_get_config(arch))
    assert get_smoke_config(arch).name == f"{arch}-smoke"
    assert PLM.module(cfg) is (PLM.FAMILIES["dense"] if arch == "qwen3-0.6b" else PM)
    if arch == "qwen3-0.6b":
        assert PLM.active_param_count(cfg) == COUNTS[arch]
    else:
        assert PLM.active_param_count(cfg) < COUNTS[arch] // 4


def test_padded_experts_and_capacity_match_jax():
    base = j_get_config("qwen2-moe-a2.7b")
    for n in (2, 6, 8, 16, 17, 20, 60, 64):
        for factor in (0.4, 1.0, 1.25):
            jc, pc = base.replace(num_experts=n, capacity_factor=factor), \
                get_config("qwen2-moe-a2.7b").replace(num_experts=n, capacity_factor=factor)
            assert PM.padded_experts(pc) == JM.padded_experts(jc)
            for tokens in (1, 2, 7, 64, 1000, 1024):
                assert PM.capacity(pc, tokens) == JM.capacity(jc, tokens), (n, factor, tokens)
    assert PM.padded_experts(get_config("qwen2-moe-a2.7b")) == 64
    assert PM.capacity(get_config("olmoe-1b-7b"), 1024) == 160 and PM.capacity(get_config("olmoe-1b-7b"), 2) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_jax_equals_lm_init(arch):
    """The JAX package's own initial weights, drawn in the port, within 3
    ulp (``tests/test_torch_random.py``: XLA's and the port's ErfInv round
    differently in a few elements)."""
    want = {k: np.asarray(v) for k, v in JLM.init(jax.random.key(0), j_get_smoke_config(arch)).items()}
    got = init_params_jax(0, PLM.param_specs(get_smoke_config(arch)), device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == np.float32, k
        ia, ib = (x.reshape(-1).view(np.int32).astype(np.int64) for x in (g, v))
        ia, ib = (np.where(x < 0, -(2**31) - x, x) for x in (ia, ib))
        assert np.abs(ia - ib).max(initial=0) <= 3, k


def _weights(cfg, seed=0):
    """``numpy_params`` with the zero and one initialisers made non-trivial
    (qkv biases, norm scales, q/k norms, the shared experts' gate)."""
    params = numpy_params(PLM.param_specs(cfg), seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if k.endswith(("/bq", "/bk", "/bv", "/shared_gate")):
            params[k] = (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(("/scale", "/q_norm", "/k_norm")):
            params[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


FFN_CASES = {"olmoe": ("olmoe-1b-7b", {}), "drops": ("olmoe-1b-7b", {"capacity_factor": 0.4}),
             "padded": ("olmoe-1b-7b", {"num_experts": 20}), "shared": ("qwen2-moe-a2.7b", {})}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case, dtype):
    arch, kw = FFN_CASES[case]
    jc, pc = j_get_smoke_config(arch).replace(**kw), get_smoke_config(arch).replace(**kw)
    w = {k.removeprefix("blocks/moe/"): v[0] for k, v in _weights(pc, seed=3).items() if k.startswith("blocks/moe/")}
    x = np.random.default_rng(5).standard_normal((2, 40, pc.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(_JDT[dtype]) for k, v in w.items()}
    tp = {k: torch.tensor(v).to(_TDT[dtype]) for k, v in w.items()}
    jx, tx = jnp.asarray(x).astype(_JDT[dtype]), torch.tensor(x).to(_TDT[dtype])

    jy, jaux = jax.jit(lambda p, x: JM._moe_ffn_scatter(p, x, jc))(jp, jx)
    ty, taux = PM.moe_ffn(tp, tx, pc)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)), *FFN_TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    # the routing, bit for bit: the reference's own routing code on its float32 logits
    T, Ep = 80, PM.padded_experts(pc)
    C = JM.capacity(jc, T)
    xf = jx.reshape(T, -1)
    logits = (xf @ jp["router"].astype(jnp.float32)).astype(jnp.float32)
    _, (flat_e, slot, keep, gates, _, _), _ = JM._local_dispatch(xf, logits, jc, jc.num_experts, Ep, C, xf.dtype)
    r = PM.route(tp["router"], tx.reshape(T, -1), pc)
    assert r.capacity == C and r.probs.shape == (T, Ep)
    np.testing.assert_array_equal(r.idx.reshape(-1).numpy(), np.asarray(flat_e))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_allclose(r.gates.reshape(-1).numpy(), np.asarray(gates).reshape(-1), rtol=1e-5)
    if case == "drops":
        assert not r.keep.all()
    else:
        assert r.keep.all()
    if case == "padded":
        assert Ep == 32 and int(r.idx.max()) < 20 and float(r.probs[:, 20:].max()) == 0.0


def test_routing_breaks_ties_as_jax_top_k():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k`` (a router with equal columns ties every expert)."""
    pc = get_smoke_config("olmoe-1b-7b")
    col = np.random.default_rng(0).standard_normal((pc.d_model, 1)).astype(np.float32)
    router = np.repeat(col, pc.num_experts, axis=1)
    router[:, 5] += 1.0  # one expert above the tied rest
    x = np.random.default_rng(1).standard_normal((6, pc.d_model)).astype(np.float32)
    r = PM.route(torch.tensor(router), torch.tensor(x), pc)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1), pc.top_k)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(jidx))
    assert set(r.idx[:, 1].tolist()) <= {0, 1}


def test_combine_order():
    """The bf16 combine on the same expert outputs: JAX's scatter-add
    ``zeros(T, D).at[tok_idx].add(yk)`` equals the port's ``combine`` (k
    adds in choice order) bit for bit; a float32 sum rounded once does not."""
    T, k, D = 200, 8, 64
    yk = np.random.default_rng(0).standard_normal((T * k, D)).astype(np.float32)
    jy = jnp.asarray(yk).astype(jnp.bfloat16)
    tok = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    want = np.asarray(jax.jit(lambda y, t: jnp.zeros((T, D), jnp.bfloat16).at[t].add(y, mode="drop"))(jy, tok)
                      .astype(jnp.float32))
    ty = torch.tensor(yk).to(torch.bfloat16).reshape(T, k, D)
    np.testing.assert_array_equal(PM.combine(ty).float().numpy(), want)
    assert (ty.float().sum(1).to(torch.bfloat16).float().numpy() != want).any()


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol[0], atol=tol[1], err_msg=msg)


@contextlib.contextmanager
def _port_routes():
    """Every call of the port's routing, recorded as (expert ids (T, k),
    kept (T*k,))."""
    rec, route = [], PM.route

    def recording(router, xf, cfg):
        r = route(router, xf, cfg)
        rec.append((r.idx.numpy(), r.keep.numpy()))
        return r

    PM.route = recording
    try:
        yield rec
    finally:
        PM.route = route


def _first_diverged(jrec, prec, B: int, k: int) -> tuple[np.ndarray, int]:
    """The first position of each row at which any layer routes a token to
    another set of experts than JAX, or keeps another choice (S where none
    does), and S; each such token must be a near tie in JAX's router (its
    k-th and (k+1)-th probabilities within ``ROUTE_GAP``)."""
    assert len(jrec) == len(prec)
    S = jrec[0][0].shape[0] // B
    first = np.full(B, S)
    for (jidx, jkeep, jtop), (pidx, pkeep) in zip(jrec, prec):
        sets = (np.sort(jidx, -1) != np.sort(pidx, -1)).any(-1)
        gap = jtop[:, k - 1] - jtop[:, k]
        assert (gap[sets] <= ROUTE_GAP).all(), f"a route differs where JAX's gap is {gap[sets].max()}"
        bad = (sets | (jkeep != pkeep).reshape(-1, k).any(-1)).reshape(B, S)
        first = np.minimum(first, np.where(bad.any(1), bad.argmax(1), S))
    return first, S


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch, dtype):
    """forward (and the aux loss), prefill (logits and every cache entry)
    and 8 decode steps, teacher-forced on JAX's tokens, at ``SMOKE``, with
    every MoE layer's routing recorded on both sides.  In float32 the
    routes are equal throughout; in bf16 a token may route elsewhere only
    at a near tie, and each row is held up to its first such token (at
    least half of the positions)."""
    jcfg, pcfg = j_get_smoke_config(arch).replace(dtype=dtype), get_smoke_config(arch).replace(dtype=dtype)
    weights = _weights(pcfg)
    jparams = {k: jnp.asarray(v) for k, v in weights.items()}
    pparams = {k: torch.tensor(v) for k, v in weights.items()}
    tokens = np.random.default_rng(11).integers(0, pcfg.vocab_size, (2, 40)).astype(np.int32)
    with E.jax_moe_routes() as jrec, _port_routes() as prec:
        _hold_routed(jcfg, pcfg, jparams, pparams, tokens, jrec, prec)


def _hold_routed(jcfg, pcfg, jparams, pparams, tokens, jrec, prec):
    tol, exact, k = TOL[pcfg.dtype], pcfg.dtype == "float32", pcfg.top_k
    B, S = tokens.shape

    def run(jfn, pfn):
        j0, p0 = len(jrec), len(prec)
        jout, pout = jfn(), pfn()
        jax.effects_barrier()
        if pcfg.family != "moe":
            return jout, pout, None
        first, n = _first_diverged(jrec[j0:], prec[p0:], B, k)
        assert not exact or (first == n).all(), f"float32 routes differ from JAX's (rows diverge at {first})"
        return jout, pout, first

    (jf, jaux), (pf, paux), first = run(lambda: jax.jit(lambda p, b: JLM.forward(p, b, jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)}), lambda: PLM.forward(pparams, {"tokens": torch.tensor(tokens)}, pcfg))
    first = np.full(B, S) if first is None else first
    assert first.sum() >= B * S // 2, first
    for row in range(B):
        _close(pf[row, :first[row]], jf[row, :first[row]], tol["logits"], f"row {row}")
    assert sorted(paux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(paux[key]), float(jaux[key]), rtol=1e-5 if exact else 1e-2)
    if exact:
        np.testing.assert_array_equal(_f32(pf).argmax(-1), _f32(jf).argmax(-1))

    (jl, jcache), (pl, pcache), first = run(lambda: jax.jit(JLM.make_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)}), lambda: PLM.make_prefill(pcfg)(pparams, {"tokens": torch.tensor(tokens)}))
    first = np.full(B, S) if first is None else first
    held = first == S  # rows whose every token routes as JAX's
    _close(pl[held], np.asarray(jl.astype(jnp.float32))[held], tol["logits"])
    assert sorted(pcache) == sorted(jcache) == ["k", "v"]

    def hold_cache(upto):
        for name in pcache:
            assert str(pcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype), name
            assert tuple(pcache[name].shape) == jcache[name].shape, name
            for row in range(B):
                _close(pcache[name][:, row, :upto[row]], jcache[name][:, row, :upto[row]], tol["kv"], name)

    hold_cache(first)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0)]) for k, v in jcache.items()}
    pcache = PE.Engine._grow_cache(pcache, S + N_DECODE)
    jdec, pdec = jax.jit(JLM.make_decode_step(jcfg)), PLM.make_decode_step(pcfg)
    tok = tokens[:, -1]
    for i, pos in enumerate(range(S, S + N_DECODE)):
        (jl, jcache), (pl, pcache), step_first = run(
            lambda: jdec(jparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)}, jcache),
            lambda: pdec(pparams, {"token": torch.tensor(tok), "pos": pos}, pcache))
        held &= True if step_first is None else step_first == 1
        _close(pl[held], np.asarray(jl.astype(jnp.float32))[held], tol["decode"], f"decode step {i}")
        if exact:
            np.testing.assert_array_equal(_f32(pl).argmax(-1), _f32(jl).argmax(-1))
        tok = _f32(jl)[:, -1].argmax(-1).astype(np.int32)  # teacher-forced on JAX's tokens
    hold_cache(np.where(held, S + N_DECODE, first))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_engine_generate_matches_jax(arch):
    """The ``learned`` KV offload on the MoE family: tokens and offload
    stats equal JAX's, in float32."""
    jcfg = j_get_smoke_config(arch).replace(dtype="float32")
    pcfg = get_smoke_config(arch).replace(dtype="float32")
    weights = _weights(pcfg, seed=1)
    prompt = np.random.default_rng(1).integers(0, pcfg.vocab_size, (2, 64)).astype(np.int32)
    je = JE.Engine(jcfg, {k: jnp.asarray(v) for k, v in weights.items()}, offload="learned")
    pe = PE.Engine(pcfg, {k: torch.tensor(v) for k, v in weights.items()}, offload="learned", device="cpu")
    assert "moe" in PE.KV_FAMILIES
    jr = je.generate({"tokens": jnp.asarray(prompt)}, 24, pad_to=160)
    pr = pe.generate({"tokens": prompt}, 24, pad_to=160)
    np.testing.assert_array_equal(pr.tokens, np.asarray(jr.tokens))
    assert pr.offload_stats == jr.offload_stats and pr.offload_stats["hbm_hits"] + pr.offload_stats["hbm_misses"] > 0


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
    assert sorted(got["offload"]) == sorted(want["offload"])
