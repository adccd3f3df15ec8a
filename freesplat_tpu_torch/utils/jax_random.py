"""The JAX package's random draws: flax's default initializers at
``jax.random.PRNGKey(seed)``, drawn with numpy on the host.

So that a seed names the same network in both packages:

- ``threefry2x32`` is jax's counter-based hash (20 rounds) over numpy
  uint32 counters; ``fold_in`` and ``random_bits`` are jax's on it.
- ``param_key`` is the key flax hands a parameter: the root key folded
  with the SHA-1 of the module path and the parameter's place in its
  module (flax's ``LazyRng``, without the separator flag).
- ``truncated_normal`` is ``jax.random.truncated_normal(key, -2, 2)``
  with jax's partitionable random bits (a 64-bit iota as the counters),
  its uniform-from-mantissa and XLA's float32 inverse error function
  (Giles' polynomials), and ``lecun_normal`` scales it as flax's
  ``variance_scaling(1, "fan_in", "truncated_normal")``.

Where XLA contracts a multiply and an add, so does ``_fma32``.  XLA's
float32 ``log1p`` is its own; here it is rounded from float64.  About
1 % of the weights then differ from the JAX package's on the CPU in their
last bit, as its back ends differ from one another.
"""
from __future__ import annotations

import functools
import hashlib
import math

import numpy as np
import torch

__all__ = ["fold_in", "lecun_normal", "param_key", "prng_key", "random_bits", "threefry2x32",
           "truncated_normal"]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's ErfInv32 coefficients for w = -log1p(-x * x) < 5, highest degree
# first.  |x| <= erf(sqrt 2) here, so w < 2.5 and its other branch is
# never taken.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """jax's threefry2x32 of the counter pairs ``(x0, x1)`` (uint32
    arrays, overwritten) under ``key``."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 += np.uint32(ks[0])
    x1 += np.uint32(ks[1])
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, r, out=t)
            x1 >>= 32 - r
            x1 |= t
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _M)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return 0, seed & _M


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return int(x0[0]), int(x1[0])


def param_key(root: tuple[int, int], path: tuple[str, ...], index: int = 1) -> tuple[int, int]:
    """The key flax's ``self.param`` passes to the initializer of the
    ``index``-th parameter (1-based) of the module at ``path``: the root
    folded with the first 4 bytes of SHA-1(path names, index)."""
    m = hashlib.sha1()
    for part in path:
        m.update(part.encode("utf-8"))
    m.update(index.to_bytes((index.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits(key: tuple[int, int], lo: np.ndarray) -> np.ndarray:
    """jax's partitionable 32-bit random bits at the flat indices ``lo``
    (uint32; the counters' high word is 0)."""
    x0, x1 = threefry2x32(key, np.zeros_like(lo), lo.copy())
    return x0 ^ x1


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA contracts it: the
    product of two float32 values is exact in float64."""
    return (a.astype(np.float64) * b + np.float64(c)).astype(np.float32)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    # log1p rounded from float64, where XLA has a float32 log1p of its own.
    w = -np.log1p((x * -x).astype(np.float64)).astype(np.float32) - np.float32(2.5)
    p = np.full_like(x, _ERFINV_LT5[0])
    for c in _ERFINV_LT5[1:]:
        p = _fma32(p, w, np.float32(c))
    return p * x


_SQRT2 = np.float32(np.sqrt(2))
_A = np.float32(math.erf(np.float32(-2.0) / _SQRT2))  # XLA's erf(-2 / sqrt 2)
_B = -_A


def truncated_normal(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape)`` in float32, in
    slices that stay in cache (the hash is ~100 passes)."""
    n = math.prod(shape)
    out = np.empty(n, np.float32)
    for start in range(0, n, 1 << 14):
        lo = np.arange(start, min(start + (1 << 14), n), dtype=np.uint32)
        mant = ((random_bits(key, lo) >> 9) | np.uint32(0x3F800000)).view(np.float32) - 1
        u = np.maximum(_A, _fma32(mant, _B - _A, _A))
        out[start:start + len(lo)] = _SQRT2 * _erfinv32(u)
    lower = np.nextafter(np.float32(-2), np.float32(np.inf))
    upper = np.nextafter(np.float32(2), np.float32(-np.inf))
    return np.clip(out, lower, upper).reshape(shape)


@functools.lru_cache(maxsize=1024)  # ~two encoders' kernels, ~400 MB
def _lecun_normal(key: tuple[int, int], shape: tuple[int, ...], fan_in: int) -> np.ndarray:
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return truncated_normal(key, shape) * stddev


def lecun_normal(key: tuple[int, int], shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal()``, for a kernel of
    flax ``shape`` with ``fan_in`` inputs (on the host).  The draws are
    kept: a process that builds a module from one seed again (tests, the
    smoke's phases) draws nothing the second time."""
    return torch.tensor(_lecun_normal(key, shape, fan_in))
