"""Wrapper of the CUDA paged-attention decode step (csrc/paged_attn.cu).

The port of ``repro/kernels/paged_attn.py``: one cluster launch writes
the token's K/V into its pool slot and attends the row's live pages. The
pools are updated in place. ``launches`` counts the launches of the
kernel and nothing else. ``plan`` is the launch geometry, pure Python so
that the CPU tests can check it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

launches = 0

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# csrc/paged_attn.cu's constants; plan() mirrors its shared-memory layout
MAX_G = 8
HEAD_DIMS = (16, 64, 128, 256)            # the kernel's instantiations
WARPS = 4                                 # warps of a CTA
CHUNK = 16                                # positions a warp scores at once
MAX_CLUSTER = 8                           # portable cluster size
SMEM_LIMIT = 232448                       # dynamic shared memory of a CTA
_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _I, _P]


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """One cluster of ``cluster`` CTAs per (row, KV head); CTA r takes
    positions [r * split, (r + 1) * split) of the row's P * ps, each warp
    ``CHUNK`` of them at a time through ``stages`` cp.async buffers."""
    positions: int
    cluster: int
    split: int
    stages: int
    smem_bytes: int

    def ranges(self):
        """The positions of each CTA of a cluster, in rank order."""
        return [range(r * self.split, min((r + 1) * self.split,
                                          self.positions))
                for r in range(self.cluster)]


def smem_bytes(split: int, ps: int, G: int, Dh: int, itemsize: int,
               stages: int) -> int:
    """Dynamic shared memory of one CTA (csrc/paged_attn.cu::smem_bytes):
    the CTA's partial (m, l, o), the page ids of its split, and per warp
    its K/V stage ring (rows padded by 16 bytes), weights, rescales and
    the chunk's position offsets."""
    row = Dh * itemsize + 16
    part = (2 * MAX_G + G * Dh) * 4
    pages = -(-(split // ps + 2) * 4 // 16) * 16
    warp = stages * 2 * CHUNK * row + CHUNK * MAX_G * 4 + MAX_G * 4 \
        + CHUNK * 8
    return part + pages + WARPS * warp


def plan(P: int, ps: int, G: int, Dh: int, itemsize: int) -> PagedPlan:
    """The launch geometry for a table of P pages of ps positions: the
    fewest CTAs (at most MAX_CLUSTER) whose splits, in whole tiles of
    WARPS * CHUNK positions, cover P * ps; two stages where they fit the
    shared memory of a CTA, else one."""
    if not (1 <= G <= MAX_G and Dh in HEAD_DIMS and P >= 1 and ps >= 1):
        raise ValueError(f"paged_attention_step: G={G} (1..{MAX_G}), "
                         f"Dh={Dh} (one of {HEAD_DIMS}), P={P}, ps={ps}")
    T = P * ps
    tile = WARPS * CHUNK
    split = -(-(-(-T // MAX_CLUSTER)) // tile) * tile
    for stages in (2, 1):
        smem = smem_bytes(split, ps, G, Dh, itemsize, stages)
        if smem <= SMEM_LIMIT:
            return PagedPlan(T, -(-T // split), split, stages, smem)
    raise ValueError(f"paged_attention_step: {T} positions at Dh={Dh} need "
                     f"{smem} bytes of shared memory a CTA")


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
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16 or KVd > 65535 \
            or B > 65535:
        raise ValueError("paged_attention_step: the pools must be 16-byte "
                         f"aligned, and B={B}, KVd={KVd} at most 65535")
    pl = plan(P, ps, G, Dh, k_pool.element_size())
    # q is read as 4-byte pairs and k_new/v_new by 16-byte cp.async
    q, k_new, v_new = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (q.contiguous(), k_new.to(dt).contiguous(),
                                 v_new.to(dt).contiguous()))
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn(dt)(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), B, KVd, G, Dh, ps, P,
                 float(scale), int(window), pl.cluster, pl.split, pl.stages,
                 stream)
    if rc:
        raise RuntimeError(f"paged_attention_step: cluster launch failed "
                           f"with CUDA error {rc}")
    launches += 1
    return out
