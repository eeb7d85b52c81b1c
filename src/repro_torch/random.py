"""JAX's PRNG as the JAX package uses it, in PyTorch.

The JAX package draws its fresh predictor weights (``init_params(
jax.random.key(seed), specs)``) and the ``random`` eviction policy's keys
(``randint(fold_in(key, t), ...)``) from ``jax.random``.  This module
computes the same numbers: keys, ``split``, ``fold_in``, 32-bit
``random_bits``, ``uniform``, ``normal`` and ``randint`` of the default
``threefry2x32`` implementation with ``jax_threefry_partitionable`` on (the
default from JAX 0.5; mirrored from JAX 0.9.0's ``jax/_src/prng.py`` and
``jax/_src/random.py``).

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words; every
draw is computed on the host in int64 tensors masked to 32 bits, so it does
not depend on the device it is later moved to.  Keys, bits, uniforms and
``randint`` are integer work and equal JAX's bit for bit.  ``normal`` mirrors
XLA's float32 ErfInv as the CPU backend runs it (``-log1p(-x·x)`` with
Cephes' ``log1p`` and ``log``, the ``w < 5`` split, the two coefficient sets
in Horner order, multiply-adds fused) in float32 torch ops; a handful of
normals in a hundred thousand still differ from JAX's by one ulp
(``tests/test_torch_random.py`` states and holds the limit).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count pairs ``(x1, x2)`` under the key
    ``(k1, k2)`` (20 rounds), elementwise."""
    ks = [_u32(k1), _u32(k2)]
    ks.append(ks[0] ^ ks[1] ^ 0x1BD11BDA)
    x = [(_u32(x1) + ks[0]) & _M32, (_u32(x2) + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``'s data with 64-bit types off (the JAX
    package's setting): the seed wraps to 32 bits, so ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def key_data(k: torch.Tensor) -> np.ndarray:
    """The key's two words as ``uint32`` (``jax.random.key_data``)."""
    return k.cpu().numpy().astype(np.uint32)


def _iota(shape) -> tuple[torch.Tensor, torch.Tensor]:
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64)
    return (idx >> 32).reshape(shape), (idx & _M32).reshape(shape)


def _words(k: torch.Tensor, ndim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A batch of keys ``(..., 2)`` as two word tensors shaped ``(..., 1 *
    ndim)``, to broadcast against counts of ``ndim`` dimensions."""
    shape = k.shape[:-1] + (1,) * ndim
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys per key, shape ``(..., num, 2)``."""
    hi, lo = _iota((num,))
    b1, b2 = threefry2x32(*_words(k, 1), hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``;
    ``data`` may be a tensor of many values (one key each)."""
    data = _u32(data)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int64 tensor of uint32 values), shape
    ``(..., *shape)`` for keys ``(..., 2)``."""
    shape = tuple(shape)
    hi, lo = _iota(shape)
    b1, b2 = threefry2x32(*_words(k, len(shape)), hi, lo)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Float32 uniforms in ``[minval, maxval)``: the 23 high bits as the
    mantissa of a float in [1, 2), minus one, scaled."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """Float32 ``a·b + c`` rounded once, as XLA's CPU code fuses it (the
    product of two float32 numbers is exact in float64)."""
    return (torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).to(torch.float32)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log (the Cephes polynomial of its vectorised
    ``logf``), its multiply-adds fused."""
    y = torch.maximum(y, _f32(np.finfo(np.float32).tiny))
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    x = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    small = x < _f32(0.707106781186547524)
    e = e - small.to(torch.float32)
    x = (x - 1.0) + torch.where(small, x, torch.zeros_like(x))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0, y1, y2 = _fma(x, _f32(p[0]), _f32(p[1])), _fma(x, _f32(p[3]), _f32(p[4])), _fma(x, _f32(p[6]), _f32(p[7]))
    y0, y1, y2 = _fma(y0, x, _f32(p[2])), _fma(y1, x, _f32(p[5])), _fma(y2, x, _f32(p[8]))
    y0 = _fma(_fma(y0, x3, y1), x3, y2)
    y0 = _fma(y0, x3, _f32(-2.12194440e-4) * e)
    x = _fma(_f32(-0.5), x2, x)
    return _fma(_f32(0.693359375), e, x + y0)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: Cephes' rational approximation below
    ``sqrt(2) - 1`` in magnitude, else ``log(1 + x)``."""
    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c))
        return p

    x2 = x * x
    small = _fma(_f32(-0.5), x2, (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))) + x
    return torch.where(x.abs() < 0.41421356237309504880, small, _log(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (``ErfInv32``), operation for operation."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(c_lt), _f32(c_ge)))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """Float32 standard normals: ``sqrt(2)·erf_inv(u)`` with ``u`` uniform
    in ``(-1, 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * erf_inv(u)


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """Int32 integers in ``[minval, maxval)`` (both in int32 range; an
    empty range gives ``minval``): 64 random bits per element reduced
    modulo the span, as uint32 arithmetic wraps.  Keys ``(..., 2)`` give
    ``(..., *shape)``."""
    ks = split(k)
    higher, lower = random_bits(ks[..., 0, :], shape), random_bits(ks[..., 1, :], shape)
    span = int(maxval) - int(minval) if maxval > minval else 1
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    off = ((((higher % span) * mult) & _M32) + (lower % span)) & _M32  # uint32 wraps
    return (minval + off % span).to(torch.int32)
