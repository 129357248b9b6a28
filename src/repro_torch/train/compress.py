"""Int8 error-feedback compression of the BP tail's gradient.

The port of ``repro/train/compress.py``. The fleet's fp32 lane ships a
worker's tail gradient as per-tensor-scaled int8 with error feedback:
the quantisation error is carried in the worker's residual and added
back the next step. The JAX package computes this outside any Pallas
kernel, so plain PyTorch on the tensors is the port. The op order is the
reference's, and so are the bits: x = g + r, scale = max(max|x|, 1e-30)
/ 127, q = clip(round(x / scale)) (IEEE f32 division, round half to
even), new_r = x - q * scale.

``compressed_psum`` is the collective over a process group
(``repro/train/compress.py:55-81``, a ``shard_map`` helper there): the
local maxima all-reduced with MAX fix a shared scale, every rank
quantises against it, the int8 payloads are summed in int32 (exact) and
dequantised, the residual kept. Like the reference, a library function:
no train path calls it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import zo


def int8_compress(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g + residual) -> (q int8, scale f32 0-d, new_residual f32)."""
    x = g.to(torch.float32) + residual
    # a zero-size leaf has max 0, as JAX's ``initial=0.0``
    top = x.abs().amax() if x.numel() else x.new_zeros(())
    scale = torch.clamp(top, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.to(torch.float32) * scale
    return q, scale, new_residual


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, residuals):
    """Tree-wise error-feedback int8 compression: (q tree, scale tree,
    new residual tree), each shaped like ``grads``."""
    outs = [int8_compress(g, r)
            for g, r in zip(zo.leaves(grads), zo.leaves(residuals))]
    return tuple(zo.rebuild(grads, [o[i] for o in outs]) for i in range(3))


def decompress_tree(qs, scales):
    return zo.rebuild(qs, [int8_decompress(q, s)
                           for q, s in zip(zo.leaves(qs), zo.leaves(scales))])


def shared_quantise(g: torch.Tensor, r: torch.Tensor, group=None):
    """``compressed_psum``'s steps (1) and (2) for one tensor: (q int8,
    the scale shared by every rank of ``group``, x = g + r in f32)."""
    import torch.distributed as dist
    x = g.to(torch.float32) + r
    top = x.abs().amax() if x.numel() else x.new_zeros(())
    top = torch.clamp(top, min=1e-30).reshape(1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = top[0] / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale, x


def compressed_psum(grads, residuals, group=None):
    """Quantise -> all-reduce (int32) -> dequantise over ``group`` (the
    default group for None): (average f32 tree, new residual tree).

    Protocol: (1) an all-reduce MAX of the local max |g + r| (floored at
    1e-30) fixes a shared scale per tensor, (2) every rank quantises
    against it, (3) the int8 payloads are summed in int32, exactly, (4)
    avg = sum * scale / n, and the residual keeps the rank's own
    quantisation error. Wire format ~1 byte an element."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(g, r):
        q, scale, x = shared_quantise(g, r, group)
        new_r = x - q.to(torch.float32) * scale
        tot = q.to(torch.int32)
        dist.all_reduce(tot, group=group)
        return tot.to(torch.float32) * scale / n, new_r

    outs = [one(g, r) for g, r in zip(zo.leaves(grads), zo.leaves(residuals))]
    return (zo.rebuild(grads, [o[0] for o in outs]),
            zo.rebuild(grads, [o[1] for o in outs]))
