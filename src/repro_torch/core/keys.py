"""Threefry-2x32 key arithmetic in numpy, bitwise equal to ``jax.random``.

The JAX train step keys probe i of step t as
``fold_in(fold_in(wrap_key_data(seed), t), i)`` and turns the key into a
uint32 noise seed with ``prng.seed_from_key``. The step index lives on
the host, so the port derives every probe seed on the host with these
twins and no step waits on the device to learn a seed.

Also here: ``normal``, a twin of ``jax.random.normal`` in float32 (uniform
bits through XLA's ``erf_inv`` polynomial), so the port's LeNet-5 init
reproduces the JAX package's ``init_lenet5(jax.random.key(seed))``. Its
bits are exact; the float tail is within a few ulp of XLA's.

Keys are numpy uint32[2] arrays (``jax.random.key_data`` layout); the
``jax_threefry_partitionable`` bit layout (JAX's default) is assumed.
"""
from __future__ import annotations

import zlib

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block hash (20 rounds) of counters (x0, x1)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key_data(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))``: ``[0, seed mod
    2**32]``. Without x64, JAX keeps only the seed's low 32 bits (a seed
    of 2**32 + 5 or -1 gives [0, 5] or [0, 2**32 - 1])."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in`` on key data: the hash of counters (0, data)."""
    y0, y1 = threefry2x32(key, _U32(0), _U32(int(data) & 0xFFFFFFFF))
    return np.array([y0, y1], _U32)


def subkey(key, *path) -> np.ndarray:
    """The JAX package's ``models.layers.subkey``: fold in each path
    element (ints as they are, names by crc32 mod 2**31)."""
    for p in path:
        d = p if isinstance(p, int) else zlib.crc32(str(p).encode()) % (2**31)
        key = fold_in(key, d)
    return key


def random_bits(key, shape) -> np.ndarray:
    """uint32 bits of ``jax.random.bits(key, shape)`` (fewer than 2**32
    elements): threefry of (0, flat index), the two words xor-ed."""
    n = int(np.prod(shape, dtype=np.int64))
    b0, b1 = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return (b0 ^ b1).reshape(shape)


# XLA's ErfInv32 (Giles' single-precision approximation)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    f = np.float32
    w = -np.log1p(-x * x)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0])).astype(f)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, f(a), f(b)) + p * w).astype(f)
    return np.where(np.abs(x) == f(1.0), x * np.finfo(f).max, p * x)


def normal(key, shape) -> np.ndarray:
    """float32 twin of ``jax.random.normal(key, shape)``."""
    f = np.float32
    bits = random_bits(key, shape)
    u = ((bits >> _U32(9)) | _U32(0x3F800000)).view(f) - f(1.0)
    lo = np.nextafter(f(-1.0), f(0.0), dtype=f)
    u = np.maximum(lo, u * (f(1.0) - lo) + lo)
    with np.errstate(over="ignore"):
        return (f(np.sqrt(2)) * _erf_inv(u)).astype(f)
