"""Wrapper of the CUDA sort-free top-k/top-p filter (csrc/topk_mask.cu).

The port of ``repro/kernels/topk_mask.py``. ``launches`` counts the
launches of the kernel and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_P = ctypes.c_void_p


def _fn():
    fn = _build.load("topk_mask").topk_topp_mask_f32
    fn.argtypes = [_P] * 4 + [ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def topk_topp_mask(logits, k, p):
    """logits [B, V] f32, k [B] int (<= 0 disables), p [B] f32 (>= 1
    disables), on one CUDA device -> logits with filtered entries at
    -1e30."""
    global launches
    B, V = logits.shape
    if not all(t.is_cuda and t.device == logits.device
               for t in (logits, k, p)):
        raise ValueError("topk_topp_mask: every tensor must be on one CUDA "
                         "device")
    if k.shape != (B,) or p.shape != (B,):
        raise ValueError(f"topk_topp_mask: k {tuple(k.shape)} and p "
                         f"{tuple(p.shape)} must be [{B}]")
    x = logits.to(torch.float32).contiguous()
    k = k.to(torch.int32).contiguous()
    p = p.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(x.data_ptr(), k.data_ptr(), p.data_ptr(), out.data_ptr(),
               B, V, stream)
    if rc:
        raise RuntimeError(f"topk_topp_mask: launch failed with CUDA error "
                           f"{rc}")
    launches += 1
    return out
