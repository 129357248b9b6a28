"""What a kernel launch costs, and the counter that records launches and
collectives as a step runs.

Each function below takes one call's shapes and dtypes and returns a
``KernelCost`` (flops, bytes, bound_s, bound_by): the arithmetic the call
asks for, the bytes it must move (each input read once, each output
written once), and the least time the card could take for it, the
larger of the bytes over the card's memory rate and its operations over
the card's peak rate for them. These are the counts behind PERF.md's
bound column; ``chip_smoke.py`` prints its bounds from them.

The noise kernels (``zo_perturb``, ``zo_fused_replay``) are bound by
instruction issue, not by FLOPs: their operation count is the SASS
instructions an element along the fast path of the built kernel's
16-byte loop (total, and those on the INT32 pipe), read from ``cuobjdump
-sass`` of ``csrc/zo_perturb.cu`` and ``csrc/zo_fused_replay.cu`` by
``chip_smoke.py::noise_paths`` on an "NVIDIA H100 80GB HBM3, 700.00 W"
card (nvcc 12.8). They are named constants here, and ``chip_smoke.py``
asserts that the build it runs still issues exactly these counts. The
shard forms (an index map in place of the offset) are priced at the
counts of their unit-stride build, the one a shard whose innermost run
is consecutive takes; a strided shard issues a few more, so its bound
stays a lower bound.

``counting()`` makes a ``CostCounter`` the active one for the code
inside: ``kernels/ops.py`` records every launch of the three kernels a
train step reaches, on any device, and ``sharding/collectives.py`` every
collective. The active counter is a module-level slot, not a
``contextvars`` variable: the autograd engine runs a CUDA backward (and
so the collectives of a sharded backward) on a thread of its own, which
does not see a context variable set by the caller. With no counter
active an entry point reads the slot once and records nothing.
"""
from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import torch

# H100 SXM at its 700 W limit: the peaks of NVIDIA's H100 datasheet and
# the highest SM clock nvidia-smi reports
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12, torch.int8: 1979e12}
SM_HZ = 1.98e9
INT32_LANES = 132 * 64           # the INT32 (ALU) pipe: 64 lanes a clock an SM
SCHED_LANES = 132 * 4 * 32       # one warp instruction a clock per scheduler

# (instructions, INT32-pipe instructions) an element on the fast path of
# the 16-byte loop (8 bf16 or 4 f32 elements an iteration) of each build
# the dispatch takes: the offset form, and the shard form with a unit
# innermost stride (the usual shard; a strided one issues a few more);
# and of one more record in zo_fused_replay's record loop. From
# chip_smoke.py::noise_paths on an "NVIDIA H100 80GB HBM3, 700.00 W" card
# (torch 2.11.0+cu128, nvcc 12.8): the sums over one iteration, exact.
_BF16, _F32 = torch.bfloat16, torch.float32
NOISE_SASS = {
    ("zo_perturb", _BF16): (948 / 8, 317 / 8),
    ("zo_perturb", _F32): (474 / 4, 159 / 4),
    ("zo_perturb_shard", _BF16): (972 / 8, 320 / 8),
    ("zo_perturb_shard", _F32): (500 / 4, 164 / 4),
    ("zo_fused_replay", _BF16): (1181 / 8, 368 / 8),
    ("zo_fused_replay", _F32): (577 / 4, 185 / 4),
    ("zo_fused_replay_shard", _BF16): (1212 / 8, 374 / 8),
    ("zo_fused_replay_shard", _F32): (611 / 4, 194 / 4),
}
REPLAY_RECORD_SASS = {
    ("zo_fused_replay", _BF16): (129.0, 41.0),
    ("zo_fused_replay", _F32): (124.0, 39.0),
    ("zo_fused_replay_shard", _BF16): (129.0, 41.0),
    ("zo_fused_replay_shard", _F32): (129.0, 42.0),
}
# the symbol of each build in the SASS, and its elements an iteration
NOISE_SYMBOLS = {
    ("zo_perturb", _BF16): ("zo_perturb_kernelI13__nv_bfloat16Li8E", 8),
    ("zo_perturb", _F32): ("zo_perturb_kernelIfLi4E", 4),
    ("zo_perturb_shard", _BF16):
        ("zo_perturb_map_kernelI13__nv_bfloat16Li8ELb1E", 8),
    ("zo_perturb_shard", _F32): ("zo_perturb_map_kernelIfLi4ELb1E", 4),
    ("zo_fused_replay", _BF16): ("zo_replay_kernelI13__nv_bfloat16Li8E", 8),
    ("zo_fused_replay", _F32): ("zo_replay_kernelIfLi4E", 4),
    ("zo_fused_replay_shard", _BF16):
        ("zo_replay_map_kernelI13__nv_bfloat16Li8ELb1E", 8),
    ("zo_fused_replay_shard", _F32): ("zo_replay_map_kernelIfLi4ELb1E", 4),
}


class KernelCost(NamedTuple):
    flops: float
    bytes: float
    bound_s: float
    bound_by: str                # "bytes" or "operations"


def peak_ops(dtype) -> float:
    """The card's peak operations a second for ``dtype`` (f32's for a
    type the table does not name)."""
    return PEAK_OPS_PER_S.get(dtype, PEAK_OPS_PER_S[torch.float32])


def _cost(flops, nbytes, ops_s) -> KernelCost:
    by_bytes = nbytes / HBM_BYTES_PER_S
    return KernelCost(float(flops), float(nbytes), max(by_bytes, ops_s),
                      "bytes" if by_bytes >= ops_s else "operations")


def noise_seconds(n: int, per_element, hz: float = SM_HZ) -> float:
    """The issue time of ``n`` elements at ``per_element`` =
    (instructions, INT32-pipe instructions): the slower of the INT32 pipe
    and the dispatch rate (one warp instruction a clock per scheduler)."""
    total, alu = per_element
    return max(alu * n / (INT32_LANES * hz), total * n / (SCHED_LANES * hz))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _perturb(form, n, dtype, hz) -> KernelCost:
    return _cost(2 * n, 2 * n * _itemsize(dtype),
                 noise_seconds(n, NOISE_SASS[(form, dtype)], hz))


def zo_perturb(n: int, dtype, hz: float = SM_HZ) -> KernelCost:
    """theta + scale * z over an ``n``-element leaf: 2 FLOPs an element
    (the noise draw is counted in instructions), a read and a write."""
    return _perturb("zo_perturb", n, dtype, hz)


def zo_perturb_shard(n: int, dtype, hz: float = SM_HZ) -> KernelCost:
    """``zo_perturb``'s shard form over a rank's ``n`` elements."""
    return _perturb("zo_perturb_shard", n, dtype, hz)


def _replay(form, n, dtype, records, hz) -> KernelCost:
    base, rec = NOISE_SASS[(form, dtype)], REPLAY_RECORD_SASS[(form, dtype)]
    per = tuple(max(b, records * r) for b, r in zip(base, rec))
    return _cost(2 * n * records, 2 * n * _itemsize(dtype),
                 noise_seconds(n, per, hz))


def zo_fused_replay(n: int, dtype, records: int = 1,
                    hz: float = SM_HZ) -> KernelCost:
    """S x P = ``records`` (seed, coeff) records applied to an
    ``n``-element leaf: 2 FLOPs an element and record, a read and a
    write; the operations those of the S = P = 1 path, or of ``records``
    passes of the record loop where that is more."""
    return _replay("zo_fused_replay", n, dtype, records, hz)


def zo_fused_replay_shard(n: int, dtype, records: int = 1,
                          hz: float = SM_HZ) -> KernelCost:
    """``zo_fused_replay``'s shard form over a rank's ``n`` elements."""
    return _replay("zo_fused_replay_shard", n, dtype, records, hz)


@functools.lru_cache(maxsize=None)
def visible_pairs(Sq: int, Sk: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """The (query, key) pairs the causal and window masks leave, query
    row i at position ``q_offset + i``, key j at j."""
    n = 0
    for i in range(Sq):
        q = q_offset + i
        lo = max(0, q - window + 1) if window > 0 else 0
        hi = min(q, Sk - 1) if causal else Sk - 1
        n += max(0, hi - lo + 1)
    return n


def flash_attention(q_shape, k_shape, dtype, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0,
                    lse: bool = False) -> KernelCost:
    """o = softmax(q k^T) v for q [B, H, Sq, D], k / v [B, Hkv, Sk, D]:
    4 B H D FLOPs a visible (query, key) pair (Q K^T and P V) at the
    card's peak for ``dtype``; q, k, v read and o written once, and with
    ``lse`` the f32 [B, H, Sq] log-sum-exps written too."""
    B, H, Sq, D = q_shape
    Sk = k_shape[2]
    itemsize = _itemsize(dtype)
    flops = 4 * B * H * D * visible_pairs(Sq, Sk, causal, window, q_offset)
    nbytes = itemsize * (2 * B * H * Sq * D + 2 * B * k_shape[1] * Sk * D) \
        + (4 * B * H * Sq if lse else 0)
    return _cost(flops, nbytes, flops / peak_ops(dtype))


# ---------------------------------------------------------------------- #
# the counter
# ---------------------------------------------------------------------- #
class Launch(NamedTuple):
    name: str
    dtype: str
    cost: KernelCost


def bytes_moved(kind: str, out_bytes: float, n: int) -> float:
    """The bytes a collective of ``kind`` with ``out_bytes`` of output on
    a rank moves a rank over a group of ``n``, by the ring conventions of
    ``repro/launch/hlo_analysis.py``:

      all-gather        out_bytes * (n-1)/n
      all-reduce        2 * out_bytes * (n-1)/n
      reduce-scatter    out_bytes * (n-1)
      all-to-all        out_bytes * (n-1)/n
    """
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    raise ValueError(f"unknown collective kind {kind!r}")


class Collective(NamedTuple):
    """One collective as a rank calls it: its kind (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``), the ranks of
    its group (global ranks, in group order), the bytes of its output on
    this rank, and the bytes it moves a rank (``bytes_moved``)."""
    kind: str
    ranks: tuple
    out_bytes: int
    bytes_moved: float

    @property
    def group(self) -> int:
        return len(self.ranks)


class CostCounter:
    """The kernel launches and collectives of the code run while it is
    active, in call order."""

    def __init__(self):
        self.launches: List[Launch] = []
        self.collectives: List[Collective] = []

    def kernel(self, name: str, dtype, cost: KernelCost):
        self.launches.append(Launch(name, str(dtype).replace("torch.", ""),
                                    cost))

    def collective(self, record: Collective):
        self.collectives.append(record)

    def launch_counts(self) -> Dict[str, int]:
        return dict(Counter(r.name for r in self.launches))


_ACTIVE: List[Optional[CostCounter]] = [None]


def active() -> Optional[CostCounter]:
    """The active counter, or None."""
    return _ACTIVE[0]


@contextlib.contextmanager
def counting(counter: Optional[CostCounter] = None):
    """``counter`` (a new one by default) active inside, the one active
    before restored on exit; yields it."""
    counter = CostCounter() if counter is None else counter
    before, _ACTIVE[0] = _ACTIVE[0], counter
    try:
        yield counter
    finally:
        _ACTIVE[0] = before
