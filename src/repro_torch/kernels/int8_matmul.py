"""Wrapper of the CUDA int8 GEMM (csrc/int8_matmul.cu).

The port of ``repro/kernels/int8_matmul.py::int8_matmul``: int8 a [M, K]
x int8 w [K, N] -> (int32 out [M, N], max|out| as an int32 0-d tensor),
the max fused into the kernel's epilogue. Any M, K, N (the kernel
zero-pads its tiles). ``launches`` counts the launches of the kernel and
nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_P = ctypes.c_void_p
MAX_K = 133_143                 # K * 127^2 < 2^31: the int32 sum cannot wrap
MAX_N = 65_535 * 64             # keeps grid.y (N tiles) within 65,535


def int8_matmul(a, w):
    """a [M, K] and w [K, N], int8, contiguous, on one CUDA device."""
    global launches
    for name, t in (("a", a), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"int8_matmul: {name} must be a CUDA tensor")
        if t.dtype != torch.int8:
            raise ValueError(f"int8_matmul: {name} dtype {t.dtype} is not "
                             "int8")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be a contiguous 2-D "
                             "tensor")
    (M, K), (K2, N) = a.shape, w.shape
    if K != K2 or a.device != w.device:
        raise ValueError(f"int8_matmul: a {list(a.shape)} on {a.device} and "
                         f"w {list(w.shape)} on {w.device} do not chain")
    if K > MAX_K:
        raise ValueError(f"int8_matmul: K = {K} > {MAX_K}, where K * 127^2 "
                         "overflows the int32 accumulator")
    if M >= 2**31 or N > MAX_N:
        raise ValueError(f"int8_matmul: M = {M}, N = {N}; the grid takes "
                         f"M < 2^31 and N <= {MAX_N}")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    maxabs = torch.empty((), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out, maxabs.zero_()
    fn = _build.load("int8_matmul").int8_matmul     # zeroes maxabs first
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   _P]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), maxabs.data_ptr(),
            M, K, N, stream)
    if rc:
        raise RuntimeError(f"int8_matmul: launch failed with CUDA error {rc}")
    launches += 1
    return out, maxabs
