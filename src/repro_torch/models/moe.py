"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro/models/moe.py`` for one device (no expert or d_ff
sharding). Dispatch never materialises a [tokens, E, C] one-hot:

  1. top-k routing over the f32 softmax, renormalised -> (expert, gate)
     per slot (k slots per token);
  2. a stable argsort of the slots by expert; position in expert by the
     running-start cummax; slots past the capacity C are dropped;
  3. expert buffers [B, E, C, D] by a scatter of slot ids and a gather of
     token vectors;
  4. one batched SwiGLU over all experts;
  5. combine: each slot's output row, unsorted, weighted and summed over k.

The expert products are plain large matrix products, which the JAX
package also computes outside any Pallas kernel, so ``torch.einsum`` is
the port. Capacity is per sequence: a decode step (S = 1) gives every
expert a buffer of C = 1 row per sequence, so every expert's weights are
read whether or not a token routes to it, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import dense_init


def init_moe(gen, cfg: ModelConfig, dtype, lead=()):
    """The router is f32 whatever the model's dtype, as in the reference.
    The expert weights' scale is the reference's: ``dense_init``'s
    default fan-in there is the leading dim, E, for w_gate and w_up."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    return {
        "router": dense_init(gen, lead + (d, E), torch.float32, fan_in=d),
        "w_gate": dense_init(gen, lead + (E, d, ff), dtype, fan_in=E),
        "w_up": dense_init(gen, lead + (E, d, ff), dtype, fan_in=E),
        "w_down": dense_init(gen, lead + (E, ff, d), dtype, fan_in=ff),
    }


def capacity(cfg: ModelConfig, S: int) -> int:
    c = int(math.ceil(S * cfg.experts_per_token * cfg.capacity_factor
                      / cfg.num_experts))
    return max(c, 1)


def route(p, x, cfg: ModelConfig):
    """Routing of x [B, S, D] in slot order (slot s*K + j is token s's
    j-th choice). Returns (sort_idx [B, nslot], keep [B, nslot] in sorted
    order, dest [B, nslot] buffer cell in [0, E*C), slot gates [B, nslot]
    f32)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    nslot = S * K
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.topk(gates, K, dim=-1)            # [B, S, K]
    top_g = top_g / top_g.sum(dim=-1, keepdim=True)
    slot_e = top_i.reshape(B, nslot)
    sort_idx = torch.argsort(slot_e, dim=1, stable=True)
    sorted_e = torch.gather(slot_e, 1, sort_idx)
    ar = torch.arange(nslot, device=x.device).expand(B, nslot)
    is_start = torch.cat([torch.ones_like(sorted_e[:, :1], dtype=torch.bool),
                          sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    pos = ar - run_start                                   # position in expert
    keep = pos < C
    dest = sorted_e * C + torch.where(keep, pos, 0)
    return sort_idx, keep, dest, top_g.reshape(B, nslot)


def moe_ffn(p, x, cfg: ModelConfig):
    """x: [B, S, D] -> [B, S, D]. Group = one sequence (capacity per
    sequence)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    nslot = S * K
    sort_idx, keep, dest, slot_g = route(p, x, cfg)

    # which slot fills buffer cell (e, c); sentinel nslot. Dropped slots
    # write to one extra column, which is cut off (the reference's
    # scatter with mode="drop")
    binv = torch.full((B, E * C + 1), nslot, dtype=torch.int64,
                      device=x.device)
    binv.scatter_(1, torch.where(keep, dest, E * C), sort_idx)
    binv = binv[:, :E * C]
    token_of_cell = torch.clamp(binv // K, max=S - 1)
    xin = torch.gather(x, 1, token_of_cell[..., None].expand(B, E * C, D))
    xin = torch.where((binv < nslot)[..., None], xin, 0).reshape(B, E, C, D)

    h = F.silu(torch.einsum("becd,edf->becf", xin, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", xin, p["w_up"])
    out = torch.einsum("becf,efd->becd", h, p["w_down"]).reshape(B, E * C, D)

    val = torch.gather(out, 1, dest[..., None].expand(B, nslot, D))
    val = torch.where(keep[..., None], val, 0)
    unsort = torch.argsort(sort_idx, dim=1)        # the inverse permutation
    val = torch.gather(val, 1, unsort[..., None].expand(B, nslot, D))
    val = val.reshape(B, S, K, D) * slot_g.reshape(B, S, K)[..., None].to(
        val.dtype)
    return val.sum(dim=2).to(x.dtype)
