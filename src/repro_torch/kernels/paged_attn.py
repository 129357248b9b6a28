"""Wrapper of the CUDA paged-attention decode step (csrc/paged_attn.cu).

The port of ``repro/kernels/paged_attn.py``: one launch writes the
token's K/V into its pool slot and attends the row's live pages. The
pools are updated in place. ``launches`` counts the launches of the
kernel and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_MAX_G, _MAX_DH = 8, 256                  # csrc/paged_attn.cu limits
SPLIT_POSITIONS = 128                     # positions per block (one split)
_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]


def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("paged_attn"),
                 f"paged_attention_step_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def paged_attention_step(q, k_new, v_new, k_pool, v_pool, page_table,
                         seq_lens, *, scale: float, window: int = 0):
    """q [B,KVd,G,Dh]; k_new/v_new [B,KVd,Dh]; pools [N,ps,KVd,Dh];
    page_table [B,P] int; seq_lens [B] int, all on one CUDA device.
    Writes the token's K/V into the pools in place; returns o
    [B,KVd,G,Dh] in q's dtype (0 for a row with no live position)."""
    global launches
    B, KVd, G, Dh = q.shape
    N, ps = k_pool.shape[:2]
    P = page_table.shape[1]
    dt = k_pool.dtype
    tensors = (q, k_new, v_new, k_pool, v_pool, page_table, seq_lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_step: every tensor must be on "
                         "one CUDA device")
    if dt not in _SUFFIX or q.dtype != dt or v_pool.dtype != dt:
        raise TypeError(f"paged_attention_step: q {q.dtype} and pools "
                        f"{dt}/{v_pool.dtype} must share bf16 or f32")
    if k_pool.shape != (N, ps, KVd, Dh) or v_pool.shape != k_pool.shape \
            or k_new.shape != (B, KVd, Dh) or v_new.shape != (B, KVd, Dh) \
            or page_table.shape != (B, P) or seq_lens.shape != (B,):
        raise ValueError("paged_attention_step: shapes disagree: q "
                         f"{tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
                         f"table {tuple(page_table.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention_step: the pools are written in "
                         "place and must be contiguous")
    if G > _MAX_G or Dh > _MAX_DH or (Dh * k_pool.element_size()) % 16 \
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"paged_attention_step: G={G} (max {_MAX_G}) and "
                         f"Dh={Dh} (max {_MAX_DH}, rows of 16 bytes) must "
                         "fit the kernel, and the pools be 16-byte aligned")
    q = q.contiguous()
    k_new = k_new.to(dt).contiguous()
    v_new = v_new.to(dt).contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    n_splits = -(-(P * ps) // SPLIT_POSITIONS)
    part_acc = torch.empty((B, KVd, n_splits, G, Dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, KVd, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn(dt)(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                 part_ml.data_ptr(), B, KVd, G, Dh, ps, P, float(scale),
                 int(window), SPLIT_POSITIONS, n_splits, stream)
    if rc:
        raise RuntimeError(f"paged_attention_step: launch failed with CUDA "
                           f"error {rc}")
    launches += 1
    return out
