"""The port's serving stack against the JAX package's: the paged KV round
trip, the ``learned`` and ``lru`` offload managers fed the same mass and
touch streams (bit-exact stats, residency and frequency table across a
table flush), ``Engine.generate`` at float32 ``SMOKE`` on the same numpy
weights (the same tokens and offload stats), and the ``launch.serve``
entry point."""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_0_5b as JQ
from repro.launch import serve as JS
from repro.serving import engine as JE
from repro_torch.configs import qwen2_0_5b as PQ
from repro_torch.launch import serve as PS
from repro_torch.models import lm as PLM
from repro_torch.models.params import numpy_params
from repro_torch.serving import engine as PE
from repro_torch.serving import offload as PO
from repro_torch.serving.kv_cache import PAGE_TOKENS, PagedKV


def test_paged_kv_roundtrip():
    kv = PagedKV.create(n_layers=2, n_pages=8, kv_heads=2, head_dim=4, batch=2, max_pages=4, device="cpu")
    L, K, D = 2, 2, 4
    for t in range(PAGE_TOKENS + 3):  # crosses a page boundary
        lk = torch.full((L, K, D), float(t))
        kv.append_token(0, lk, lk + 100)
    k, v = kv.gather(0, PAGE_TOKENS + 3)
    assert k.shape == (L, PAGE_TOKENS + 3, K, D) and k.dtype == torch.bfloat16
    np.testing.assert_allclose(k[0, :, 0, 0].float().numpy(), np.arange(PAGE_TOKENS + 3))
    np.testing.assert_allclose(v[0, :, 0, 0].float().numpy(), np.arange(PAGE_TOKENS + 3) + 100)
    assert kv.seq_lens[0] == PAGE_TOKENS + 3
    assert (kv.block_table[0, :2] >= 0).all() and kv.n_pool_pages == 8


def _stream(rng, n_steps, n_pages):
    """Per step: a mass over the pages the cache covers so far (skewed, with
    ties at zero past the valid prefix) and the pages at or above half the
    largest, as the engine derives them."""
    for step in range(n_steps):
        n_valid = min(n_pages, 2 + step * n_pages // n_steps)
        mass = np.zeros(n_pages)
        mass[:n_valid] = rng.gamma(0.7, size=n_valid)
        touched = np.nonzero(mass >= 0.5 * mass[:n_valid].max())[0]
        yield mass, touched


@pytest.mark.parametrize("kind", ["learned", "lru"])
@pytest.mark.parametrize("n_pages,cap", [(32, 16), (12, 3)])
def test_offload_managers_match_jax_bit_exact(kind, n_pages, cap):
    """200 steps cross the frequency table's flush (every 3 intervals of 64)."""
    jm = JE.OFFLOAD_KINDS[kind](n_pages, cap)
    pm = PE.OFFLOAD_KINDS[kind](n_pages, cap, device="cpu")
    for mass, touched in _stream(np.random.default_rng(n_pages + cap), 200, n_pages):
        jm.on_attention(mass, touched)
        pm.on_attention(mass, touched)
    assert jm.freq_table.flushes == pm.freq_table.flushes == 1
    assert dataclasses.asdict(pm.stats) == dataclasses.asdict(jm.stats)
    assert pm.stats.evictions > 0 and pm.step == jm.step == 200
    for name in ("resident", "evicted_once", "last_interval", "attn_mass"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(pm.freq_table.tags.numpy(), jm.freq_table.tags)
    np.testing.assert_array_equal(pm.freq_table.counters.numpy(), jm.freq_table.counters)
    np.testing.assert_array_equal(pm._freq_dense(), jm._freq_dense())


SERVE = {"prompt_len": 70, "n_new": 26, "pad_to": 96}


@pytest.fixture(scope="module")
def engines():
    jcfg, pcfg = JQ.SMOKE.replace(dtype="float32"), PQ.SMOKE.replace(dtype="float32")
    weights = numpy_params(PLM.param_specs(pcfg), 0)
    prompt = np.random.default_rng(1).integers(0, pcfg.vocab_size, (2, SERVE["prompt_len"])).astype(np.int32)
    je = JE.Engine(jcfg, {k: jnp.asarray(v) for k, v in weights.items()})
    pe = PE.Engine(pcfg, {k: torch.tensor(v) for k, v in weights.items()}, device="cpu")
    return je, pe, prompt


@pytest.mark.parametrize("kind", ["learned", "lru"])
def test_engine_generate_matches_jax(engines, kind):
    je, pe, prompt = engines
    je.offload_kind = pe.offload_kind = kind
    jr = je.generate({"tokens": jnp.asarray(prompt)}, SERVE["n_new"], pad_to=SERVE["pad_to"])
    pr = pe.generate({"tokens": prompt}, SERVE["n_new"], pad_to=SERVE["pad_to"])
    np.testing.assert_array_equal(pr.tokens, np.asarray(jr.tokens))
    assert pr.steps == jr.steps == SERVE["n_new"]
    assert pr.offload_stats == jr.offload_stats
    assert pr.offload_stats["hbm_misses"] > 0


def test_engine_rejects_the_manager_offload_kind():
    """The engine builds the ``manager`` kind (a ``LearnedOffloadManager``
    on its device, ``tests/test_torch_train.py`` holds it against the JAX
    package); what it still rejects are that kind's snapshot options,
    which need the manager's snapshot store (not ported)."""
    cfg = PQ.SMOKE
    params = PLM.init(0, cfg, device="cpu")
    mgr = PE.Engine(cfg, params, offload="manager", device="cpu").make_manager(96)
    assert isinstance(mgr, PO.LearnedOffloadManager) and mgr.manager.device.type == "cpu"
    for kw in ({"checkpoint_dir": "snapshots"}, {"checkpoint_every": 4}, {"resume": True}):
        with pytest.raises(NotImplementedError, match="snapshot"):
            PO.LearnedOffloadManager(4, 2, device="cpu", **kw)


def test_serve_entry_point_prints_the_reference_keys(capsys):
    argv = ["--smoke", "--batch", "2", "--prompt-len", "12", "--new-tokens", "4", "--offload", "learned"]
    assert PS.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert JS.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["arch"] == want["arch"] and got["generated_shape"] == want["generated_shape"] == [2, 4]
    assert sorted(got["offload"]) == sorted(want["offload"]) and len(got["first_seq"]) == 4
