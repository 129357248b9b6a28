"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro/models/moe.py``, on one device and on a mesh.
Dispatch never materialises a [tokens, E, C] one-hot:

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
read whether or not a token routes to it, as in the reference; on a mesh
the rank that holds a sequence's rows routes it, so which slots drop
does not depend on the mesh.

On a mesh (``run``, a ``sharding/collectives.py::MeshRun``; steps 3-4
by the rules' MoE plan, where GSPMD placed the buffers by the sharding
constraints of ``repro/models/moe.py:86-98``):

  * ``ep``, `model` a batch axis (``fsdp`` at a batch that dp * tp
    divides): the buffers [B_loc, E, C, D] go through an all-to-all over
    `model` to [tp B_loc, E / tp, C, D], the rank's experts run on every
    row of its `model` group, and a second all-to-all brings them back;
  * ``ep``, `model` not a batch axis (``tp``, ``serve``, ``fsdp`` at a
    batch dp * tp does not divide): the `model` ranks hold the same
    rows, each fills and computes only its own experts' buffers, and the
    outputs are gathered over `model` along E (``replica_gather``);
  * ``tp`` (tp does not divide E) with TP compute: every expert on every
    rank, d_ff split over `model`; the down projection's partial sums
    all-reduced in f32 and rounded once (``layers.py::_row_parallel``);
    without TP compute (``fsdp``) the one-device form on gathered
    weights.

Where the `model` ranks hold the same rows, the expert inputs' share of
x's gradient is partial on each and is summed over `model` (``copy_to``
on the dispatch input only); the router's and the gates' share is the
same on every `model` rank and is not summed.
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


def _buffers(x, binv, lo: int, hi: int, C: int, K: int, nslot: int):
    """The expert buffers [B, hi - lo, C, D] of experts [lo, hi): each
    cell's token row of x, zeros where no slot fills the cell."""
    B, S, D = x.shape
    cells = binv[:, lo * C:hi * C]
    token = torch.clamp(cells // K, max=S - 1)
    xin = torch.gather(x, 1, token[..., None].expand(B, cells.shape[1], D))
    return torch.where((cells < nslot)[..., None], xin, 0).reshape(
        B, hi - lo, C, D)


def _mesh_plan(run, specs):
    """How a mesh runs the experts (module docstring): "all_to_all",
    "own_experts", "d_ff" (the MoE tp plan with TP compute), or None
    (the one-device form: no mesh, or no split of the experts' work)."""
    if run is None:
        return None
    if run.expert_axis is not None:
        return "all_to_all" if run.expert_axis in run.batch_axes \
            else "own_experts"
    from .layers import _model_sharded
    if not run.whole_weights and _model_sharded(specs["w_gate"]):
        return "d_ff"
    return None


def moe_ffn(p, x, cfg: ModelConfig, specs=None, run=None):
    """x: [B, S, D] -> [B, S, D]. Group = one sequence (capacity per
    sequence). On a mesh (``run``, with the block's ``specs``) x is the
    rank's rows and ``p`` the weights from ``MeshRun.weights``: the
    expert leaves the rank's E / tp experts under the ``ep`` plan, its
    d_ff slice under the MoE ``tp`` plan with TP compute."""
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
    plan = _mesh_plan(run, specs)
    lo, hi, src = 0, E, x
    if plan is not None:
        from ..sharding import collectives as col
        g = run.model_group
        if plan != "all_to_all":
            # the `model` ranks hold the same rows: the expert inputs'
            # share of x's gradient is partial on each, the router's not
            src = col.copy_to(x, g)
        if plan == "own_experts":
            r = run.coords[run.expert_axis]
            n = E // run.sizes[run.expert_axis]
            lo, hi = r * n, (r + 1) * n
    xin = _buffers(src, binv, lo, hi, C, K, nslot)
    if plan == "all_to_all":                 # [tp B, E / tp, C, D]
        xin = col.all_to_all(xin, g, 1, 0)
    h = F.silu(torch.einsum("becd,edf->becf", xin, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", xin, p["w_up"])
    if plan == "d_ff":
        from .layers import _row_parallel
        out = _row_parallel("becf,efd->becd", h, p["w_down"], run)
    else:
        out = torch.einsum("becf,efd->becd", h, p["w_down"])
    if plan == "all_to_all":                 # back to [B, E, C, D]
        out = col.all_to_all(out, g, 0, 1)
    elif plan == "own_experts":
        out = col.replica_gather(out, g, 1, r)
    out = out.reshape(B, E * C, D)

    val = torch.gather(out, 1, dest[..., None].expand(B, nslot, D))
    val = torch.where(keep[..., None], val, 0)
    unsort = torch.argsort(sort_idx, dim=1)        # the inverse permutation
    val = torch.gather(val, 1, unsort[..., None].expand(B, nslot, D))
    val = val.reshape(B, S, K, D) * slot_g.reshape(B, S, K)[..., None].to(
        val.dtype)
    return val.sum(dim=2).to(x.dtype)
