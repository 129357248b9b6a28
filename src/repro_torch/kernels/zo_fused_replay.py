"""Wrappers of the CUDA fused ZO replays (csrc/zo_fused_replay.cu and
csrc/zo_fused_replay_int8.cu).

The ports of ``repro/kernels/zo_fused_replay.py``: ``zo_fused_replay``
applies S steps x P probes of (seed, coeff) records to one leaf in one
pass, with the per-step accumulate-then-cast order of
``ref.zo_fused_replay_ref``; ``zo_fused_replay_int8_leaves`` applies
(seed, ternary g) records to every int8 leaf of a model in one launch,
accumulating in int32 and clamping once a step
(``ref.zo_fused_replay_int8_ref``; ``zo_fused_replay_int8`` is a table of
one leaf). ``launches`` and ``int8_launches`` count the launches of each
kernel and nothing else. ``zo_fused_replay`` given an ``index`` (a
rank's shard's ``core/prng.py::IndexMap``) replays at the shard's global
flat indices through the kernel's shard form.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .zo_perturb import (Map3, check_leaf, device_ints, int8_noise_args,
                         launch_leaves, leaf_table, map_args)

launches = 0
int8_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_SYMBOLS = {torch.float32: "zo_fused_replay_f32",
            torch.bfloat16: "zo_fused_replay_bf16"}
_ARGS = [_P, _P, _P, _P, _I, _I, ctypes.c_uint32, ctypes.c_uint32, _P]
_MAP_SYMBOLS = {torch.float32: "zo_fused_replay_map_f32",
                torch.bfloat16: "zo_fused_replay_map_bf16"}
_MAP_ARGS = [_P, _P, _P, _P, _I, _I, ctypes.c_uint32, ctypes.POINTER(Map3),
             ctypes.c_uint32, _P]
_INT8_ARGS = [_P, _I, _P, _P, _I, _I, _I, _U64, _U64, _I, _P]
MAX_RECORDS = 227 * 1024 // 8   # S * P seeds and coeffs in the f32 kernel's
#                                 shared memory; the int8 one takes as many


def _fn(dtype):
    return _build.function("zo_fused_replay", _SYMBOLS[dtype], _ARGS)


def zo_fused_replay(theta, seeds, coeffs, salt: int, out=None, index=None):
    """theta [any] f32/bf16 contiguous on a CUDA device; seeds int32 [S, P]
    (uint32 values) and coeffs f32 [S, P] on the same device; z at the
    flat indices 0..n-1, or at ``index``'s (an ``IndexMap`` of theta's
    elements). Returns a new tensor, or writes ``out`` (which may be
    theta itself)."""
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
    args = (theta.data_ptr(), out.data_ptr(), seeds.data_ptr(),
            coeffs.data_ptr(), S, P, salt)
    m = None if index is None else map_args("zo_fused_replay", index,
                                            theta.numel())
    if m is None or (index.is_contiguous and index.base == 0):
        rc = _fn(theta.dtype)(*args, theta.numel(), stream)
    else:             # the offset form has no offset: the shard form
        rc = _build.function("zo_fused_replay", _MAP_SYMBOLS[theta.dtype],
                             _MAP_ARGS)(*args, ctypes.byref(m),
                                        theta.numel(), stream)
    if rc:
        raise RuntimeError(f"zo_fused_replay: launch failed with CUDA error "
                           f"{rc}")
    launches += 1
    return out


def zo_fused_replay_int8_leaves(thetas, seeds, gs, salts, r_max: int,
                                p_zero, shift: int, outs=None):
    """int8 leaves ``thetas`` (contiguous, on one CUDA device), each with
    its salt; seeds int32 [S, P] (uint32 values) and gs int32 [S, P] on
    that device; r_max and shift host ints, p_zero a host float. Returns
    the new leaves, views into one new buffer, or writes ``outs`` (which
    may be ``thetas`` itself); one launch for every MAX_LEAVES leaves."""
    global int8_launches
    name = "zo_fused_replay_int8"
    if not thetas:
        return []
    if not -2**31 <= int(shift) < 2**31:
        raise ValueError(f"{name}: shift {shift} is outside the int32 range")
    if seeds.dim() != 2:
        raise ValueError(f"{name}: seeds must be [S, P]")
    S, P = seeds.shape
    if not 0 < S * P <= MAX_RECORDS:
        raise ValueError(f"{name}: {S} x {P} records; the kernel takes 1 to "
                         f"{MAX_RECORDS} per launch")
    seeds = device_ints(f"{name} seeds", seeds, thetas[0].device, (S, P))
    gs = device_ints(f"{name} gs", gs, thetas[0].device, (S, P))
    rows, outs = leaf_table(name, thetas, salts, outs)
    r, magic, keep = int8_noise_args(name, r_max, p_zero)
    fn = _build.function(name, name, _INT8_ARGS)
    stream = torch.cuda.current_stream(thetas[0].device).cuda_stream
    int8_launches += launch_leaves(name, rows, lambda table, count: fn(
        table, count, seeds.data_ptr(), gs.data_ptr(), S, P, r, magic, keep,
        int(shift), stream))
    return outs


def zo_fused_replay_int8(theta, seeds, gs, salt: int, r_max: int, p_zero,
                         shift: int, out=None):
    """``zo_fused_replay_int8_leaves`` on one leaf. Returns a new tensor,
    or writes ``out`` (which may be theta itself)."""
    return zo_fused_replay_int8_leaves(
        [theta], seeds, gs, [salt], r_max, p_zero, shift,
        outs=None if out is None else [out])[0]
