"""Wrapper of the CUDA flash attention (csrc/flash_attn.cu).

The port of ``repro/kernels/flash_attn.py``: causal / sliding-window
attention with the online softmax, forward only, f32 accumulation, in the
JAX layout (q [B,H,Sq,D], k/v [B,Hkv,Sk,D]), query row i at position
``q_offset + i`` (a rank's rows of the sequence-sharded attention plan
start past 0), and with ``return_lse`` each row's log-sum-exp too.
``launches`` counts its launches and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

launches = 0

HEAD_DIMS = (16, 64, 128)
_SYMBOLS = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn(dtype):
    fn = getattr(_build.load("flash_attn"), _SYMBOLS[dtype])
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _I,
                   _I, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, q_offset):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; want all float32 or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: want q [B,H,Sq,D] and k, v "
                         "[B,Hkv,Sk,D]")
    B, H, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {list(q.shape)} and k/v "
                         f"{list(k.shape)} do not match (Hkv divides H)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if max(Sq, Sk) >= 2**31 or max(B, H) > 65535:
        raise ValueError("flash_attention: Sq, Sk below 2**31 and B, H at "
                         "most 65535")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim of q, k, v must be "
                         "contiguous")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if not 0 <= q_offset < 2**31 - Sq:
        raise ValueError(f"flash_attention: q_offset {q_offset} is not in "
                         f"[0, 2**31 - Sq)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    return_lse: bool = False):
    """q [B,H,Sq,D], k/v [B,Hkv,Sk,D] on a CUDA device, all f32 or all
    bf16, each with a contiguous last dim (other strides are free); q head
    h reads kv head h // (H / Hkv); query row i sits at position
    ``q_offset + i`` for the causal and window masks. Returns o
    [B,H,Sq,D] in q's dtype, in q's memory layout when q is dense (a
    transposed [B,S,H,D] view gives one back); with ``return_lse``,
    (o, lse): lse f32 [B,H,Sq], each row's log-sum-exp of its scaled,
    masked scores (o is the same bits either way). The kernel has no
    backward."""
    global launches
    _check(q, k, v, window, q_offset)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                         for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, H, Hkv, Sq, Sk, D, strides,
                      float(scale), int(bool(causal)), int(window),
                      int(q_offset), None if lse is None else lse.data_ptr(),
                      stream)
    if rc:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{rc}")
    launches += 1
    return (out, lse) if return_lse else out
