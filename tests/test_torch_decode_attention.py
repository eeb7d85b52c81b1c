"""The plain version of the port's decode-attention kernel against the JAX
package's Pallas kernel (``decode_attention_kernelcall`` in interpret mode)
and its oracle ``decode_ref``, and the bf16 plain flash attention against
the Pallas flash kernel (interpret mode) and the JAX package's
``_attend_chunked``.  (The CUDA kernels are held against these plain
versions on the card: tests/test_torch_kernels_gpu.py and chip_smoke.py.)

Tolerances: float32 rtol/atol 1e-5 (summation order only).  bf16 atol 2e-2:
the outputs lie within about ±3, where one bf16 rounding of ``p`` (before
the PV product) and one of the output are each worth up to 2^-7 of the
value, and the compared versions round ``p`` against different running
maxima (per 512-key block here, the whole row in ``decode_ref``, which
rounds nothing before the output)."""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as JDK
from repro.kernels.decode_attention import ops as JDO
from repro.kernels.decode_attention.ref import decode_ref
from repro.kernels.flash_attention import kernel as JFA
from repro.models import layers as JL
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, dtype, *shapes):
    arrs = [rng.standard_normal(s).astype(np.float32).astype(_NP[dtype]) for s in shapes]
    return arrs, [torch.tensor(a.astype(np.float32)).to(_TORCH[dtype]) for a in arrs]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (B, K, G, D, T, kv_len): kv_len at 1, at a block edge (512), past it, and T;
# G > 1; T = 1024 is two of the TPU kernel's 512-key blocks
CASES = [
    (2, 2, 1, 64, 1024, 1),
    (2, 2, 7, 64, 1024, 512),
    (2, 2, 7, 64, 1024, 513),
    (1, 2, 4, 32, 1024, 1024),
    (2, 1, 3, 16, 512, 300),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,G,D,T,kv_len", CASES)
def test_decode_plain_matches_pallas_and_ref(B, K, G, D, T, kv_len, dtype):
    rng = np.random.default_rng(B * 1000 + G * 100 + kv_len)
    (q, k, v), (tq, tk, tv) = _inputs(rng, dtype, (B, K, G, D), (B, T, K, D), (B, T, K, D))
    before = dict(LAUNCHES)
    got = DA.decode_attention_kernelcall(tq, tk, tv, kv_len)
    assert LAUNCHES == before  # a CPU tensor never counts as a kernel launch
    assert got.dtype == _TORCH[dtype] and got.shape == (B, K, G, D)
    tol = TOL[dtype]
    pallas = JDK.decode_attention_kernelcall(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=tol, atol=tol)
    ref = decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_len)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)


def test_decode_model_layout_and_default_kv_len():
    rng = np.random.default_rng(7)
    (q, k, v), (tq, tk, tv) = _inputs(rng, "float32", (2, 1, 2, 3, 32), (2, 256, 2, 32), (2, 256, 2, 32))
    got = DA.decode_attention(tq, tk, tv)
    assert got.shape == (2, 1, 2, 3, 32)
    want = JDO.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


# (B, S, T, K, G, D, kw)
FLASH = [
    (2, 64, 64, 2, 7, 64, {}),
    (1, 128, 128, 2, 3, 32, {"kv_len": 100}),
    (2, 32, 96, 1, 2, 16, {"q_offset": 64}),
]


@pytest.mark.parametrize("B,S,T,K,G,D,kw", FLASH)
def test_flash_plain_bf16_matches_pallas_and_chunked(B, S, T, K, G, D, kw):
    rng = np.random.default_rng(S * T + G)
    (q, k, v), (tq, tk, tv) = _inputs(rng, "bfloat16", (B, S, K, G, D), (B, T, K, D), (B, T, K, D))
    got = FA.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    pallas = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=2e-2, atol=2e-2)
    chunked = JL._attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                 q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"))
    np.testing.assert_allclose(_f32(got), _f32(chunked), rtol=2e-2, atol=2e-2)
    # the same rounding points as _attend_chunked: nearly every output is the same bf16 number
    assert np.mean(_f32(got) == _f32(chunked)) > 0.95
