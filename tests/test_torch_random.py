"""``repro_torch.random`` against ``jax.random`` (threefry2x32, partitionable
layout, 64-bit types off, as the JAX package runs), and the port's initial
weights against the JAX package's.

Keys, ``split``, ``fold_in``, bits, uniforms and ``randint`` are integer
work and are held bit for bit.  ``normal`` mirrors XLA's float32 ErfInv as
the CPU backend runs it; measured on 200,000 draws of ``key(0)``, 3 differ
from JAX's, each by one ulp.  Limits: at most ``NORMAL_SHARE`` of the draws
differ, by at most ``NORMAL_ULP``.  A weight is a float32 standard deviation
times a normal, so its limits are the normals' share and 3 ulp
(``WEIGHT_ULP``; ``CONFIG``'s three exported slots: 7-9 of 632,066
elements differ, by at most 3 ulp).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import predictor_paper as JC
from repro.core import baselines_nn as JB
from repro.core import predictor as JP
from repro.models.params import init_params as j_init_params
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs import predictor_paper as PC
from repro_torch.core import baselines_nn as PB
from repro_torch.core import predictor as PP
from repro_torch.models.params import init_params_jax

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 123, 2**31 + 5, 2**32 - 1)
SHAPES = ((), (7,), (3, 5), (1000,))
NORMAL_SHARE = 5e-5
NORMAL_ULP = 1
WEIGHT_ULP = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This module's tensors are small: one intra-op thread keeps its work
    from oversubscribing the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS + (-7, 2**40 + 9))
def test_keys_split_and_fold_in_are_jax_bits(seed):
    jk, pk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(R.key_data(pk), _kd(jk))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(R.key_data(R.split(pk, num)), _kd(jax.random.split(jk, num)))
    for data in (0, 7, 2**31 + 3):
        np.testing.assert_array_equal(R.key_data(R.fold_in(pk, data)), _kd(jax.random.fold_in(jk, data)))
    # a batch of fold_ins, one key per value
    ts = np.array([0, 5, 77, 123456])
    got = R.key_data(R.fold_in(pk, torch.tensor(ts)))
    np.testing.assert_array_equal(got, np.stack([_kd(jax.random.fold_in(jk, int(t))) for t in ts]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_and_randint_are_jax_bits(seed, shape):
    jk, pk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(R.random_bits(pk, shape).numpy().astype(np.uint32),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    ju = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(R.uniform(pk, shape).numpy().view(np.uint32), ju.view(np.uint32))
    for lo, hi in ((0, 1 << 30), (3, 17), (-5, 1_000_003), (10, 10)):
        np.testing.assert_array_equal(R.randint(pk, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(jk, shape, lo, hi)))


def test_randint_of_a_batch_of_keys_is_each_keys_draw():
    pk = R.fold_in(R.key(5), torch.tensor([0, 3, 77]))
    got = R.randint(pk, (300,), 0, 1 << 30).numpy()
    for i, t in enumerate((0, 3, 77)):
        want = jax.random.randint(jax.random.fold_in(jax.random.key(5), t), (300,), 0, 1 << 30)
        np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("seed,n", [(0, 200_000), (2**31 + 5, 50_000), (9, 3)])
def test_normal_within_the_stated_ulp(seed, n):
    want = np.asarray(jax.random.normal(jax.random.key(seed), (n,)))
    got = R.normal(R.key(seed), (n,)).numpy()
    d = _ulps(got, want)
    assert d.max() <= NORMAL_ULP
    assert np.count_nonzero(d) <= NORMAL_SHARE * n


def _assert_weights_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    n = n_diff = 0
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.shape == v.shape and g.dtype == np.float32, k
        d = _ulps(g.reshape(-1), np.asarray(v, np.float32).reshape(-1))
        assert d.max(initial=0) <= WEIGHT_ULP, k
        n += d.size
        n_diff += np.count_nonzero(d)
    assert n_diff <= NORMAL_SHARE * n


@pytest.mark.parametrize("kind", ["transformer", "lstm", "cnn", "mlp"])
def test_init_params_jax_matches_the_jax_package(kind):
    jspecs = JP.param_specs(JC.SMOKE) if kind == "transformer" else getattr(JB, f"{kind}_specs")(JC.SMOKE)
    pspecs = PP.param_specs(PC.SMOKE) if kind == "transformer" else getattr(PB, f"{kind}_specs")(PC.SMOKE)
    for seed in (0, 3):
        want = {k: np.asarray(v) for k, v in j_init_params(jax.random.key(seed), jspecs).items()}
        _assert_weights_close(init_params_jax(seed, pspecs, device="cpu"), want)


def test_predictor_init_at_config_matches_the_exported_slots():
    """``CONFIG``'s draws against the JAX package's own, exported in
    ``init_paper_slots.npz`` (slots 0, 2 and 3)."""
    fresh = convert.fresh_slots(ROOT / "experiments" / "torch" / "init_paper_slots.npz")
    assert sorted(fresh) == [0, 2, 3]
    for s, want in fresh.items():
        _assert_weights_close(PP.init(s, PC.CONFIG, "cpu"), {k: np.asarray(v) for k, v in want.items()})
