"""Wrappers of the CUDA fused ZO replays (csrc/zo_fused_replay.cu and
csrc/zo_fused_replay_int8.cu).

The ports of ``repro/kernels/zo_fused_replay.py``: ``zo_fused_replay``
applies S steps x P probes of (seed, coeff) records to one leaf in one
pass, with the per-step accumulate-then-cast order of
``ref.zo_fused_replay_ref``; ``zo_fused_replay_int8`` applies (seed,
ternary g) records to an int8 leaf, accumulating in int32 and clamping
once a step (``ref.zo_fused_replay_int8_ref``). ``launches`` and
``int8_launches`` count the launches of each kernel and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .zo_perturb import check_leaf, device_ints

launches = 0
int8_launches = 0

_P = ctypes.c_void_p
_SYMBOLS = {torch.float32: "zo_fused_replay_f32",
            torch.bfloat16: "zo_fused_replay_bf16"}
MAX_RECORDS = 227 * 1024 // 8   # S * P seeds and coeffs in shared memory


def _fn(dtype):
    fn = getattr(_build.load("zo_fused_replay"), _SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_uint32, _P]
    fn.restype = ctypes.c_int
    return fn


def zo_fused_replay(theta, seeds, coeffs, salt: int, out=None):
    """theta [any] f32/bf16 contiguous on a CUDA device; seeds int32 [S, P]
    (uint32 values) and coeffs f32 [S, P] on the same device. Returns a
    new tensor, or writes ``out`` (which may be theta itself)."""
    global launches
    check_leaf("zo_fused_replay", theta, out, salt)
    if seeds.dim() != 2:
        raise ValueError("zo_fused_replay: seeds must be [S, P]")
    S, P = seeds.shape
    if not 0 < S * P <= MAX_RECORDS:
        raise ValueError(f"zo_fused_replay: {S} x {P} records; the kernel "
                         f"takes 1 to {MAX_RECORDS} per launch")
    seeds = device_ints("zo_fused_replay seeds", seeds, theta.device, (S, P))
    if coeffs.device != theta.device or coeffs.dtype != torch.float32 \
            or tuple(coeffs.shape) != (S, P):
        raise ValueError(f"zo_fused_replay: coeffs must be float32 [{S}, {P}] "
                         f"on {theta.device}")
    coeffs = coeffs.contiguous()
    out = torch.empty_like(theta) if out is None else out
    if theta.numel() == 0:
        return out
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = _fn(theta.dtype)(theta.data_ptr(), out.data_ptr(), seeds.data_ptr(),
                          coeffs.data_ptr(), S, P, salt, theta.numel(), stream)
    if rc:
        raise RuntimeError(f"zo_fused_replay: launch failed with CUDA error "
                           f"{rc}")
    launches += 1
    return out


def zo_fused_replay_int8(theta, seeds, gs, salt: int, r_max: int, p_zero,
                         shift: int, out=None):
    """theta [any] int8 contiguous on a CUDA device; seeds int32 [S, P]
    (uint32 values) and gs int32 [S, P] on the same device; r_max and
    shift host ints, p_zero a host float. Returns a new tensor, or writes
    ``out`` (which may be theta itself)."""
    global int8_launches
    from ..core.int8 import keep_threshold
    check_leaf("zo_fused_replay_int8", theta, out, salt, (torch.int8,))
    if seeds.dim() != 2:
        raise ValueError("zo_fused_replay_int8: seeds must be [S, P]")
    S, P = seeds.shape
    if not 0 < S * P <= MAX_RECORDS:
        raise ValueError(f"zo_fused_replay_int8: {S} x {P} records; the "
                         f"kernel takes 1 to {MAX_RECORDS} per launch")
    seeds = device_ints("zo_fused_replay_int8 seeds", seeds, theta.device,
                        (S, P))
    gs = device_ints("zo_fused_replay_int8 gs", gs, theta.device, (S, P))
    out = torch.empty_like(theta) if out is None else out
    if theta.numel() == 0:
        return out
    fn = _build.load("zo_fused_replay_int8").zo_fused_replay_int8
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_uint32, _P]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = fn(theta.data_ptr(), out.data_ptr(), seeds.data_ptr(), gs.data_ptr(),
            S, P, salt, int(r_max), keep_threshold(p_zero), int(shift),
            theta.numel(), stream)
    if rc:
        raise RuntimeError(f"zo_fused_replay_int8: launch failed with CUDA "
                           f"error {rc}")
    int8_launches += 1
    return out
