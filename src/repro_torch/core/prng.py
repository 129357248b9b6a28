"""Counter-based hash bits, bitwise equal to ``repro/core/prng.py``.

Every element's bits are a murmur3-style hash of (global flat index,
salt, seed), so the same (seed, salt, shape, offset) regenerates the same
bits on any device. The serve sampler's Gumbel stream is built on them,
and ``normal`` turns two streams into the ZO perturbation z.

The arithmetic is uint32 with wrap-around. PyTorch's CPU kernels have no
uint32 add, shift or remainder, so the hash runs in int64 holding values
in [0, 2**32) and masks after every add and multiply. Multiplies are
split into 16-bit halves so that no intermediate leaves int64's range.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_PHI = 0x9E3779B9


def mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant m."""
    lo = a * (m & 0xFFFF)                         # < 2**48
    hi = ((a * (m >> 16)) & 0xFFFF) << 16         # < 2**32
    return (lo + hi) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    h = h ^ (h >> 13)
    h = mul32(h, _M2)
    return h ^ (h >> 16)


class IndexMap:
    """Where a tensor's elements sit in a larger leaf's flat index space:
    element i (row-major over ``levels``' extents) is at ``base + sum_k
    i_k * stride_k``, (extent_k, stride_k) from outer to inner. A whole
    leaf of n elements is ``IndexMap(0, ((n, 1),))``, a period's slice of
    a stacked leaf one level at base p * size, a rank's shard of a
    sharded leaf up to three levels (``sharding/params.py::
    shard_desc``). The noise reads each index mod 2**32, as the JAX
    package's uint32 ``iota`` wraps: a leaf of more than 2**32 elements
    (a stacked expert leaf of Mixtral or Phi-3.5-MoE at full depth)
    draws at its flat index mod 2**32, and so do its shards."""

    def __init__(self, base: int, levels):
        self.base = int(base)
        self.levels = tuple((int(e), int(s)) for e, s in levels)
        if self.base < 0 or any(e < 0 or s < 0 for e, s in self.levels):
            raise ValueError(f"index map {self}: negative base or level")

    @property
    def numel(self) -> int:
        n = 1
        for e, _ in self.levels:
            n *= e
        return n

    @property
    def max_index(self) -> int:
        return self.base + sum((e - 1) * s for e, s in self.levels)

    @property
    def is_contiguous(self) -> bool:
        """One run of consecutive indices (the offset form)."""
        live = [(e, s) for e, s in self.levels if e != 1]
        return not live or (len(live) == 1 and live[0][1] == 1)

    def flat_indices(self, device=None) -> torch.Tensor:
        """The index of every element, row-major, mod 2**32 (int64)."""
        idx = torch.full((), self.base, dtype=torch.int64, device=device)
        for e, s in self.levels:
            idx = idx[..., None] + torch.arange(
                e, dtype=torch.int64, device=device) * s
        return idx.reshape(-1) & MASK32

    def __eq__(self, other):
        return isinstance(other, IndexMap) and (
            self.base, self.levels) == (other.base, other.levels)

    def __hash__(self):
        # reprolint: allow(no-builtin-hash) -- unsalted ints, in __hash__ only
        return hash((self.base, self.levels))

    def __repr__(self):
        return f"IndexMap(base={self.base}, levels={self.levels})"


def uniform_bits(seed, salt: int, shape, offset: int = 0, *,
                 device=None, index: "IndexMap" = None) -> torch.Tensor:
    """uint32 hash bits (as int64) for every element of ``shape``.

    seed: a Python int or an int64 tensor of uint32 values. A tensor seed
    of shape S gives bits of shape S + shape, one stream per seed (the
    batched form of the JAX package's per-row ``vmap``).
    offset: flat-index offset, ``bits(shape, off)[i] ==
    bits(bigger_shape)[off + i]``.
    index: an ``IndexMap`` of ``prod(shape)`` elements, in place of
    ``offset``: element i draws at the map's i-th index.
    """
    shape = tuple(int(d) for d in shape)
    if isinstance(seed, torch.Tensor):
        device = seed.device
        seed = seed.to(torch.int64) & MASK32
    else:
        seed = torch.tensor(int(seed) & MASK32, dtype=torch.int64,
                            device=device)
    n = 1
    for d in shape:
        n *= d
    if index is not None:
        if index.numel != n:
            raise ValueError(f"{index} holds {index.numel} elements, the "
                             f"shape {shape} {n}")
        idx = index.flat_indices(device)
    else:
        idx = (torch.arange(n, dtype=torch.int64, device=device)
               + (int(offset) & MASK32)) & MASK32
    h = (mul32(idx, _PHI) + (int(salt) & MASK32)) & MASK32
    h = h.reshape(shape)
    s = seed.reshape(seed.shape + (1,) * len(shape))
    h = _fmix32(h ^ s)
    return _fmix32((h + mul32(s, _M2)) & MASK32)


def normal(seed, salt: int, shape, offset: int = 0, *,
           device=None, index: "IndexMap" = None) -> torch.Tensor:
    """Standard normal float32 via Box-Muller on two hashed streams (salts
    2*salt+1 and 2*salt+2), op for op ``repro/core/prng.py::normal``:
    u1 = (b1 >> 8) * 2**-24 + 2**-25 in (0, 1], u2 = (b2 >> 8) * 2**-24,
    z = sqrt(-2 log u1) * cos(float32(2 pi) * u2). Every multiply and add
    is its own rounded f32 op. ``seed``, ``offset`` and ``index`` as in
    ``uniform_bits``."""
    b1 = uniform_bits(seed, 2 * int(salt) + 1, shape, offset, device=device,
                      index=index)
    b2 = uniform_bits(seed, 2 * int(salt) + 2, shape, offset, device=device,
                      index=index)
    u1 = (b1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (b2 >> 8).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(float(np.float32(2.0 * np.pi)) * u2)


def seed_from_key(key) -> int:
    """The uint32 noise seed of a key (numpy uint32[2] key data, see
    ``core/keys.py``): ``data[0] ^ (data[1] * M1)`` mod 2**32."""
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32))
    return (k0 ^ (k1 * _M1)) & MASK32
