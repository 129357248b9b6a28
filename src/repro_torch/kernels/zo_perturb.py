"""Wrappers of the CUDA ZO perturbations (csrc/zo_perturb.cu and
csrc/int8_perturb.cu).

The ports of ``repro/kernels/zo_perturb.py``: ``zo_perturb``, theta' =
cast(theta + scale * z), z regenerated from (seed, salt, flat index); and
``int8_perturb_leaves``, theta' = clamp(theta + k * z, -127, 127) with the
int8 lane's sparse uniform z, on every int8 leaf of a model in one launch
(``int8_perturb`` is a table of one leaf). ``launches`` and
``int8_launches`` count the launches of each kernel and nothing else.

``zo_perturb`` draws z at ``offset + i`` (a whole leaf, a period's slice
of a stacked one), or, given ``index``, at a rank's shard's global flat
indices (``core/prng.py::IndexMap``, up to three levels): such a map goes
to the shard form of the kernel (``map_args`` packs it), one of one
contiguous run to the offset form.

The int8 kernels take the noise's keep test and remainder as integer
constants computed here once a launch: ``keep_bound`` and
``fastmod_magic``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

launches = 0
int8_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_SYMBOLS = {torch.float32: "zo_perturb_f32", torch.bfloat16: "zo_perturb_bf16"}
_ZO_ARGS = [_P, _P, _P, _U32, ctypes.c_float, _U32, _U32, _P]
_MAP_SYMBOLS = {torch.float32: "zo_perturb_map_f32",
                torch.bfloat16: "zo_perturb_map_bf16"}


class Map3(ctypes.Structure):
    """``csrc/zo_noise.cuh::Map3``: a shard's index map for the kernels."""
    _fields_ = [("m1", ctypes.c_uint64), ("m2", ctypes.c_uint64),
                ("e1", ctypes.c_uint32), ("e2", ctypes.c_uint32),
                ("s0", ctypes.c_uint32), ("s1", ctypes.c_uint32),
                ("s2", ctypes.c_uint32), ("base", ctypes.c_uint32)]


_MAP_ARGS = [_P, _P, _P, _U32, ctypes.c_float, ctypes.POINTER(Map3), _U32, _P]
_INT8_ARGS = [_P, _I, _P, _I, _I, _U64, _U64, _P]
MAX_ELEMENTS = 2**32 - 1        # flat indices are uint32
MAX_SALT = 2**30                # 2 * salt + 2 must stay below 2**32
MAX_LEAVES = 64                 # leaf-table entries a launch (csrc/zo_noise.cuh)
ALIGN = 16                      # bytes: where each new int8 leaf starts


def _fn(dtype):
    return _build.function("zo_perturb", _SYMBOLS[dtype], _ZO_ARGS)


def check_leaf(name: str, theta, out, salt: int, dtypes=tuple(_SYMBOLS)):
    """The leaf checks the ZO kernels make before a launch."""
    if not theta.is_cuda:
        raise ValueError(f"{name}: theta must be a CUDA tensor")
    if theta.dtype not in dtypes:
        raise ValueError(f"{name}: theta dtype {theta.dtype} is not one of "
                         f"{', '.join(str(d) for d in dtypes)}")
    if not theta.is_contiguous():
        raise ValueError(f"{name}: theta must be contiguous (a leading-dim "
                         "slice of a stacked leaf is)")
    if theta.numel() > MAX_ELEMENTS:
        raise ValueError(f"{name}: {theta.numel()} elements; flat indices "
                         "are uint32, so a leaf holds fewer than 2**32")
    if not 0 <= salt < MAX_SALT:
        raise ValueError(f"{name}: salt {salt} is outside [0, 2**30)")
    if out is not None and (out.shape != theta.shape or out.dtype != theta.dtype
                            or out.device != theta.device
                            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous tensor like theta")


def device_ints(name: str, t, device, shape):
    """A uint32-valued int32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want int32 {list(shape)} on {device}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")
    return t.contiguous()


def map_args(name: str, index, n: int) -> "Map3":
    """The kernels' ``Map3`` of an ``IndexMap`` of ``n`` elements: its
    levels padded to three at the outer side, the inner two extents'
    fastdiv constants (``fastmod_magic``: ceil(2**64 / e), 0 for e = 1)."""
    if index.numel != n:
        raise ValueError(f"{name}: {index} holds {index.numel} elements, the "
                         f"leaf {n}")
    if len(index.levels) > 3:
        raise ValueError(f"{name}: {index} has more than three levels")
    if index.max_index > MAX_ELEMENTS:
        raise ValueError(f"{name}: {index} reaches flat index "
                         f"{index.max_index}, past 2**32 - 1")
    (e0, s0), (e1, s1), (e2, s2) = ((1, 0),) * (3 - len(index.levels)) \
        + index.levels
    return Map3(fastmod_magic(e1), fastmod_magic(e2), e1, e2, s0, s1, s2,
                index.base)


def zo_perturb(theta, seed, salt: int, scale: float, offset: int = 0,
               index=None):
    """theta [any] f32/bf16 contiguous on a CUDA device; seed an int32 [1]
    tensor on the same device holding the uint32 seed; scale a host float
    (rounded to f32); z is drawn over the flat indices offset + i, or at
    ``index``'s (an ``IndexMap`` of theta's elements, in place of
    ``offset``), which must stay below 2**32. Returns a new tensor."""
    global launches
    check_leaf("zo_perturb", theta, None, salt)
    m = None
    if index is not None:
        if offset:
            raise ValueError("zo_perturb: an offset and an index map")
        m = map_args("zo_perturb", index, theta.numel())
        if index.is_contiguous:         # one run: the offset form
            offset, m = index.base, None
    if not 0 <= offset <= 2**32 - theta.numel():
        raise ValueError(f"zo_perturb: offset {offset} + {theta.numel()} "
                         "elements passes 2**32 (flat indices are uint32)")
    seed = device_ints("zo_perturb seed", seed, theta.device, (1,))
    out = torch.empty_like(theta)
    if theta.numel() == 0:
        return out
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    args = (theta.data_ptr(), out.data_ptr(), seed.data_ptr(), salt,
            float(scale))
    if m is None:
        rc = _fn(theta.dtype)(*args, offset, theta.numel(), stream)
    else:
        rc = _build.function("zo_perturb", _MAP_SYMBOLS[theta.dtype],
                             _MAP_ARGS)(*args, ctypes.byref(m),
                                        theta.numel(), stream)
    if rc:
        raise RuntimeError(f"zo_perturb: launch failed with CUDA error {rc}")
    launches += 1
    return out


def fastmod_magic(d: int) -> int:
    """ceil(2**64 / d) mod 2**64, Lemire's fastmod constant: a mod d ==
    ((magic * a mod 2**64) * d) >> 64 for every uint32 a and 1 <= d <
    2**32 (``csrc/zo_noise.cuh::fastmod``)."""
    return ((2**64 - 1) // d + 1) % 2**64


@functools.lru_cache(maxsize=None)
def keep_bound(p_zero) -> int:
    """The int8 noise's keep test as an integer bound: the least T in [0,
    2**32] such that ``float32(b) < keep_threshold(p_zero)`` is false for
    b = T (2**32 where it holds for every uint32). Rounding a uint32 to
    float32 is monotone, so the test holds exactly where b < T."""
    from ..core.int8 import keep_threshold
    thresh = np.float32(keep_threshold(p_zero))
    lo, hi = 0, 2**32
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(np.uint32(mid)) < thresh:
            lo = mid + 1
        else:
            hi = mid
    return lo


def int8_noise_args(name: str, r_max: int, p_zero):
    """(r_max, fastmod magic of 2 r_max + 1, keep bound): the int8
    kernels' noise constants."""
    if not 0 <= int(r_max) < 2**31:
        raise ValueError(f"{name}: r_max {r_max} is outside [0, 2**31)")
    return int(r_max), fastmod_magic(2 * int(r_max) + 1), keep_bound(p_zero)


def new_leaves(thetas):
    """Tensors shaped like ``thetas``, views into one new int8 buffer, each
    starting on an ALIGN-byte boundary."""
    offsets, total = [], 0
    for t in thetas:
        offsets.append(total)
        total += -(-t.numel() // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=torch.int8, device=thetas[0].device)
    return [buf[o:o + t.numel()].view(t.shape)
            for o, t in zip(offsets, thetas)]


def leaf_table(name: str, thetas, salts, outs=None):
    """(rows, outs): the int8 kernels' leaf table after the leaf checks,
    one row {theta, out, n, salt} (uint64) for each leaf that holds
    elements, and the outputs (``new_leaves`` where ``outs`` is None).
    An out may be its theta itself; distinct leaves must not overlap."""
    if len(thetas) != len(salts) or (outs is not None
                                     and len(outs) != len(thetas)):
        raise ValueError(f"{name}: {len(thetas)} leaves and {len(salts)} "
                         "salts (and as many outs)")
    dev = thetas[0].device
    for i, (theta, salt) in enumerate(zip(thetas, salts)):
        check_leaf(name, theta, None if outs is None else outs[i], salt,
                   (torch.int8,))
        if theta.device != dev:
            raise ValueError(f"{name}: leaves on {dev} and {theta.device}")
    outs = new_leaves(thetas) if outs is None else list(outs)
    rows = [(t.data_ptr(), o.data_ptr(), t.numel(), salt)
            for t, o, salt in zip(thetas, outs, salts) if t.numel()]
    return np.array(rows, dtype=np.uint64).reshape(-1, 4), outs


def launch_leaves(name: str, rows: np.ndarray, launch) -> int:
    """Calls ``launch(table, count)`` on the rows, at most MAX_LEAVES a
    call, raising on a CUDA error. Returns the number of launches."""
    for lo in range(0, len(rows), MAX_LEAVES):
        table = rows[lo:lo + MAX_LEAVES]
        rc = launch(table.ctypes.data, len(table))
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    return -(-len(rows) // MAX_LEAVES)


def int8_perturb_leaves(thetas, seed, salts, k: int, r_max: int, p_zero):
    """int8 leaves ``thetas`` (contiguous, on one CUDA device), each with
    its salt; seed an int32 [1] tensor on that device holding the uint32
    seed; k and r_max host ints; p_zero a host float. Returns the new
    leaves, views into one new buffer (see ``new_leaves``); one launch
    for every MAX_LEAVES leaves."""
    global int8_launches
    if not thetas:
        return []
    if not -2**31 <= int(k) < 2**31:
        raise ValueError(f"int8_perturb: k {k} is outside the int32 range")
    rows, outs = leaf_table("int8_perturb", thetas, salts)
    seed = device_ints("int8_perturb seed", seed, thetas[0].device, (1,))
    r, magic, keep = int8_noise_args("int8_perturb", r_max, p_zero)
    fn = _build.function("int8_perturb", "int8_perturb", _INT8_ARGS)
    stream = torch.cuda.current_stream(thetas[0].device).cuda_stream
    int8_launches += launch_leaves(
        "int8_perturb", rows, lambda table, count: fn(
            table, count, seed.data_ptr(), int(k), r, magic, keep, stream))
    return outs


def int8_perturb(theta, seed, salt: int, k: int, r_max: int, p_zero):
    """``int8_perturb_leaves`` on one leaf. Returns a new tensor."""
    return int8_perturb_leaves([theta], seed, [salt], k, r_max, p_zero)[0]
