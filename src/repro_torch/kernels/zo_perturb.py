"""Wrappers of the CUDA ZO perturbations (csrc/zo_perturb.cu and
csrc/int8_perturb.cu).

The ports of ``repro/kernels/zo_perturb.py``: ``zo_perturb``, theta' =
cast(theta + scale * z), z regenerated from (seed, salt, flat index); and
``int8_perturb``, theta' = clamp(theta + k * z, -127, 127) with the int8
lane's sparse uniform z. ``launches`` and ``int8_launches`` count the
launches of each kernel and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
int8_launches = 0

_P = ctypes.c_void_p
_SYMBOLS = {torch.float32: "zo_perturb_f32", torch.bfloat16: "zo_perturb_bf16"}
MAX_ELEMENTS = 2**32 - 1        # flat indices are uint32
MAX_SALT = 2**30                # 2 * salt + 2 must stay below 2**32


def _fn(dtype):
    fn = getattr(_build.load("zo_perturb"), _SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, ctypes.c_uint32, ctypes.c_float,
                   ctypes.c_uint32, ctypes.c_uint32, _P]
    fn.restype = ctypes.c_int
    return fn


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


def zo_perturb(theta, seed, salt: int, scale: float, offset: int = 0):
    """theta [any] f32/bf16 contiguous on a CUDA device; seed an int32 [1]
    tensor on the same device holding the uint32 seed; scale a host float
    (rounded to f32); z is drawn over the flat indices offset + i, which
    must stay below 2**32. Returns a new tensor."""
    global launches
    check_leaf("zo_perturb", theta, None, salt)
    if not 0 <= offset <= 2**32 - theta.numel():
        raise ValueError(f"zo_perturb: offset {offset} + {theta.numel()} "
                         "elements passes 2**32 (flat indices are uint32)")
    seed = device_ints("zo_perturb seed", seed, theta.device, (1,))
    out = torch.empty_like(theta)
    if theta.numel() == 0:
        return out
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = _fn(theta.dtype)(theta.data_ptr(), out.data_ptr(), seed.data_ptr(),
                          salt, float(scale), offset, theta.numel(), stream)
    if rc:
        raise RuntimeError(f"zo_perturb: launch failed with CUDA error {rc}")
    launches += 1
    return out


def int8_perturb(theta, seed, salt: int, k: int, r_max: int, p_zero):
    """theta [any] int8 contiguous on a CUDA device; seed an int32 [1]
    tensor on the same device holding the uint32 seed; k and r_max host
    ints; p_zero a host float (the keep threshold is rounded in f32 as
    ``core.int8.keep_threshold`` does). Returns a new tensor."""
    global int8_launches
    from ..core.int8 import keep_threshold
    check_leaf("int8_perturb", theta, None, salt, (torch.int8,))
    seed = device_ints("int8_perturb seed", seed, theta.device, (1,))
    out = torch.empty_like(theta)
    if theta.numel() == 0:
        return out
    fn = _build.load("int8_perturb").int8_perturb
    fn.argtypes = [_P, _P, _P, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_uint32, _P]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = fn(theta.data_ptr(), out.data_ptr(), seed.data_ptr(), salt, int(k),
            int(r_max), keep_threshold(p_zero), theta.numel(), stream)
    if rc:
        raise RuntimeError(f"int8_perturb: launch failed with CUDA error {rc}")
    int8_launches += 1
    return out
