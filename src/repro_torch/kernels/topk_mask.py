"""Wrapper of the CUDA sort-free top-k/top-p filter (csrc/topk_mask.cu).

The port of ``repro/kernels/topk_mask.py``. ``launches`` counts the
launches of the kernel and nothing else. ``plan`` is the launch geometry,
pure Python so that the CPU tests can check it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

launches = 0

# csrc/topk_mask.cu's limits
MAX_CLUSTER = 16                 # non-portable above 8
SLICE_BYTES = 52 * 1024          # a CTA's slice of the row, resident
SHARED_BYTES = 50 * 1024         # its histograms and scratch (an upper bound)
SMEM_LIMIT = 232448              # dynamic shared memory of a CTA
_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    """One cluster of ``cluster`` CTAs per row; CTA r holds entries
    [r * slice, (r + 1) * slice) of the row in shared memory."""
    vocab: int
    cluster: int
    slice: int
    smem_bytes: int

    def ranges(self):
        """The entries of each CTA of a cluster, in rank order."""
        return [range(r * self.slice, min((r + 1) * self.slice, self.vocab))
                for r in range(self.cluster)]


def plan(V: int) -> TopkPlan:
    """The fewest CTAs (a power of two up to MAX_CLUSTER) whose slices,
    rounded up to whole float4s, fit SLICE_BYTES of shared memory."""
    if V < 1:
        raise ValueError(f"topk_topp_mask: vocab {V}")
    C = 1
    while True:
        sl = -(-(-(-V // C)) // 4) * 4
        if sl * 4 <= SLICE_BYTES:
            return TopkPlan(V, C, sl, SHARED_BYTES + sl * 4)
        if C == MAX_CLUSTER:
            raise ValueError(
                f"topk_topp_mask: a row of {V} entries does not fit "
                f"{MAX_CLUSTER} CTAs of {SLICE_BYTES} bytes; the kernel "
                "keeps the whole row in shared memory")
        C *= 2


def _fn():
    fn = _build.load("topk_mask").topk_topp_mask_f32
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P]
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
    if B > 65535:
        raise ValueError(f"topk_topp_mask: {B} rows, at most 65535")
    pl = plan(max(V, 1))
    x = logits.to(torch.float32).contiguous()
    k = k.to(torch.int32).contiguous()
    p = p.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn()(x.data_ptr(), k.data_ptr(), p.data_ptr(), out.data_ptr(),
               B, V, pl.cluster, pl.slice, stream)
    if rc:
        raise RuntimeError(f"topk_topp_mask: cluster launch failed with "
                           f"CUDA error {rc}")
    launches += 1
    return out
