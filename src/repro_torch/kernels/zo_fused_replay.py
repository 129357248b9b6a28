"""Wrapper of the CUDA fused ZO replay (csrc/zo_fused_replay.cu).

The port of ``repro/kernels/zo_fused_replay.py::zo_fused_replay``: S steps
x P probes of (seed, coeff) records applied to one leaf in one pass, with
the per-step accumulate-then-cast order of ``ref.zo_fused_replay_ref``.
``launches`` counts the launches of the kernel and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .zo_perturb import check_leaf, device_ints

launches = 0

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
