"""The collectives of a sharded step, on plain local tensors.

On the TPU, GSPMD inserted these from the sharding rules; here they are
explicit, with process groups per mesh axis (``MeshRun``). Each rank holds
plain tensors (its shards; the kernels are ctypes launches on raw
pointers), and the model gathers and reduces through these functions:

  * ``copy_to(x, group)``: identity forward, all-reduce of the gradient
    backward (Megatron's f: a column-parallel input, or a leaf replicated
    over a group whose ranks each use part of it);
  * ``reduce_to(x, group)``: all-reduce forward, identity backward
    (Megatron's g: a row-parallel output, the loss sum over `data`, the
    vocab-parallel sums);
  * ``fsdp_gather(x, group, dim)``: all-gather of a leaf's FSDP shards
    along ``dim`` forward, reduce-scatter of the gradient backward;
  * ``MeshRun.weight``: a leaf as the model uses it (its FSDP shards
    gathered over `data`, its gradient summed over `data` where the leaf
    is replicated there).

Sums of floats run in f32 (a bf16 tensor is cast up, reduced, cast back),
so every backend reduces alike; a group of one rank is the identity, so
a 1x1 mesh computes what one device does. The collectives go straight to
the backend on the ranks' tensors, CUDA ones under gloo too (ranks that
share a card): PyTorch documents only all_reduce and broadcast for gloo
on CUDA tensors, and ``chip_smoke.py::gloo_cuda_probe`` tries each on
the card, ``check_gloo_probe`` holding the build to ``GLOO_CUDA_OPS``,
the ones the port calls.
"""
from __future__ import annotations

from math import prod
from typing import Dict

import torch
import torch.distributed as dist

from ..launch.mesh import axis_shape
from .params import (ShardDesc, dict_leaves, map_dict, param_shardings,
                     shard_desc, shard_descs, unshard_leaf)
from .rules import ShardingRules

# the collectives the port calls on CUDA tensors, which gloo must take
# (torch 2.11 does: chip_smoke.py::gloo_cuda_probe / check_gloo_probe)
GLOO_CUDA_OPS = ("all_reduce", "all_gather", "reduce_scatter")
EXECUTED_AXES = ("data", "model")


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``group``, a new tensor of t's dtype
    (floats summed in f32); ``t`` itself on a group of one."""
    if _size(group) == 1:
        return t
    x = t.detach().to(torch.float32, copy=True) if t.is_floating_point() \
        else t.detach().clone()
    dist.all_reduce(x, op=op, group=group)
    return x.to(t.dtype)


def _gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape everywhere), stacked: [n, *x.shape]
    (the group's ranks in order; the default group for None)."""
    n = dist.get_world_size(group)
    flat = x.detach().reshape(-1).contiguous()
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.reshape((n,) + tuple(x.shape))


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    if _size(group) == 1:
        return t
    return torch.cat(_gather_flat(t, group).unbind(0), dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (in f32), split along
    ``dim`` into the group's ranks' parts: this rank's part, t's dtype."""
    n = _size(group)
    if n == 1:
        return t
    x = t.detach().to(torch.float32)
    parts = torch.stack(x.chunk(n, dim=dim)).contiguous()
    shape = parts.shape[1:]
    parts = parts.reshape(-1)
    out = torch.empty(parts.numel() // n, dtype=parts.dtype,
                      device=parts.device)
    dist.reduce_scatter_tensor(out, parts, group=group)
    return out.reshape(shape).to(t.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    if _size(group) == 1 or not x.requires_grad:
        return x
    return _CopyTo.apply(x, group)


def reduce_to(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward; the gradient passed through."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return all_reduce(x, group)
    return _ReduceTo.apply(x, group)


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; reduce-scatter backward."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return all_gather(x, group, dim)
    return _FsdpGather.apply(x, group, dim)


class MeshRun:
    """A mesh bound to a model's parameters on this rank: the rules, the
    process group, size and coordinate of each mesh axis, every leaf's
    spec (``param_shardings``) and this rank's shard descriptors.

    ``abstract_params``: the global tree of shapes
    (``core/api.py::abstract_params``). Executes meshes over `data` and
    `model` (any other axis raises)."""

    def __init__(self, mesh, rules: ShardingRules, abstract_params):
        sizes = axis_shape(mesh)
        other = [a for a in sizes if a not in EXECUTED_AXES]
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: the port executes (data, model) "
                "meshes; the pod axis waits (ROADMAP.md queue 1)")
        self.mesh, self.rules = mesh, rules
        self.axes = tuple(sizes)
        self.sizes = sizes
        self.groups = {a: mesh.get_group(a) for a in self.axes}
        self.coords = {a: mesh.get_local_rank(a) for a in self.axes}
        self.dp = sizes.get("data", 1)
        self.tp = sizes.get("model", 1)
        self.world = prod(sizes.values())
        self.rank = dist.get_rank()
        self.shapes = map_dict(lambda _n, t: tuple(t.shape),
                               abstract_params)
        self.specs = param_shardings(abstract_params, rules)
        self.descs = shard_descs(abstract_params, self.specs, self.coords,
                                 sizes)
        stack = self.specs.get("periods_zo") or self.specs.get("periods_bp")
        self.block_specs = {k: map_dict(lambda _n, s: s[1:], v)
                            for k, v in (stack or {}).items()}

    # ---- groups ------------------------------------------------------- #
    @property
    def model_group(self):
        return self.groups.get("model")

    @property
    def data_group(self):
        return self.groups.get("data")

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The mesh coordinates of ``rank`` (row-major over the axes)."""
        out = {}
        for a in reversed(self.axes):
            out[a] = rank % self.sizes[a]
            rank //= self.sizes[a]
        return out

    # ---- leaves --------------------------------------------------------- #
    def weight(self, t: torch.Tensor, spec) -> torch.Tensor:
        """A leaf shard as the model uses it: gathered over `data` along
        its FSDP dim; a leaf replicated over `data` has its gradient
        summed there. Still sharded over `model`."""
        spec = tuple(spec) if spec is not None else (None,) * t.dim()
        for dim, ax in enumerate(spec):
            axes = ax if isinstance(ax, tuple) else (ax,)
            if "data" in axes:
                if axes != ("data",):
                    raise NotImplementedError(f"spec {spec}: a dim over "
                                              "several axes")
                return fsdp_gather(t, self.data_group, dim)
        return copy_to(t, self.data_group)

    def weights(self, tree, specs):
        """``weight`` of every leaf of a tree, with its spec tree."""
        it = iter(dict_leaves(specs))
        return map_dict(lambda _n, t: self.weight(t, next(it)), tree)

    def index_maps(self, descs=None):
        """The ``IndexMap`` of every leaf's shard (of ``descs``, by
        default the params')."""
        return map_dict(lambda _n, d: d.index,
                        self.descs if descs is None else descs)

    def desc_of(self, names, rank: int) -> ShardDesc:
        tree = self.specs
        shapes = self.shapes
        for k in names:
            tree, shapes = tree[k], shapes[k]
        return shard_desc(shapes, tree, self.coords_of(rank), self.sizes)

    def gather_leaf(self, names, t: torch.Tensor) -> torch.Tensor:
        """The global leaf at ``names`` from every rank's shard ``t``
        (all ranks call it; every rank gets the leaf)."""
        descs = [self.desc_of(names, r) for r in range(self.world)]
        if descs[0].whole and all(d.whole for d in descs):
            return t
        parts = _gather_flat(t, None)
        return unshard_leaf(list(parts.unbind(0)), descs)

    def same_on_all_ranks(self, t: torch.Tensor, what: str):
        """Raises unless ``t`` is bitwise equal on every rank (an
        all-gather over the world, also at one rank)."""
        bits = t.detach().reshape(-1)
        bits = bits.view(torch.int32) if bits.element_size() == 4 \
            else bits.to(torch.float64).view(torch.int64)
        out = _gather_flat(bits, None)
        if not bool((out == out[:1]).all()):
            raise AssertionError(f"{what} differ across ranks: "
                                 f"{out.cpu().tolist()}")

    def replica_digests(self, params) -> torch.Tensor:
        """A position-weighted digest of every leaf's bits, int64 [n], in
        ``core/zo.py::leaves_with_path`` order."""
        from ..core import zo
        out = []
        for _, t in zo.leaves_with_path(params):
            b = t.detach().reshape(-1)
            b = (b.view(torch.int16) if b.element_size() == 2
                 else b.view(torch.int32)).to(torch.int64)
            w = torch.arange(b.numel(), dtype=torch.int64,
                             device=b.device) * 2654435761 + 1
            out.append((b * w).sum())
        return torch.stack(out) if out else torch.zeros(0, dtype=torch.int64)

    def check_replicas(self, params):
        """Raises unless every leaf is bitwise the same (by digest) on
        the ranks that hold the same shard of it (replicated norm scales
        and q_norm / k_norm, and the copies of any shard). Returns the
        number of (leaf, rank) pairs that had a copy to agree with."""
        from ..core import zo
        out = _gather_flat(self.replica_digests(params), None).cpu()
        held = 0
        for i, (path, _) in enumerate(zo.leaves_with_path(params)):
            first = {}
            for r in range(self.world):
                key = self.desc_of(path, r).starts
                if key in first:
                    held += 1
                    if out[r, i] != out[first[key], i]:
                        raise AssertionError(
                            f"{zo.keystr(path)}: ranks {first[key]} and {r} "
                            "hold the same shard with other bits")
                first.setdefault(key, r)
        return held


def rows_slice(global_rows: int, spec_axes, coords, sizes) -> slice:
    """This rank's rows of a batch split over ``spec_axes`` (None:
    every row)."""
    if spec_axes is None:
        return slice(0, global_rows)
    from .params import axis_index
    from .rules import axes_size
    n = axes_size(sizes, tuple(spec_axes))
    per = global_rows // n
    i = axis_index(coords, sizes, tuple(spec_axes))
    return slice(i * per, (i + 1) * per)


# ---------------------------------------------------------------------- #
# vocab-parallel embedding and loss
# ---------------------------------------------------------------------- #
def _vocab_rows(table_spec, v_local: int, run: MeshRun):
    """(first vocab row of this rank, whether rows are split over
    `model`) of a table whose vocab dim has ``table_spec``."""
    from ..models.layers import _model_sharded
    split = run.tp > 1 and _model_sharded((table_spec,))
    return (run.model_rank * v_local if split else 0), split


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, run: MeshRun):
    """Rows of the embedding table [V, D] (spec (model, data)) for
    tokens [B, S]: its FSDP shards gathered over `data`; where its vocab
    rows are split over `model`, each rank takes the tokens in its rows,
    zeros for the rest, and the rows are all-reduced over `model`."""
    spec = run.specs["embed"]
    w = run.weight(table, spec)
    lo, split = _vocab_rows(spec[0], w.shape[0], run)
    tok = tokens.to(torch.int64)
    if not split:
        return w[tok]
    mine = (tok >= lo) & (tok < lo + w.shape[0])
    x = w[(tok - lo).clamp(0, w.shape[0] - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return reduce_to(x, run.model_group)


def vocab_parallel_ce(h: torch.Tensor, unembed: torch.Tensor,
                      labels: torch.Tensor, run: MeshRun) -> torch.Tensor:
    """-log softmax(h @ unembed)[label], f32 [B, S], for h [B, S, D]
    (the same on every `model` rank) and the rank's unembedding columns
    [D, V_local] (FSDP shards already gathered). With the vocab split
    over `model`: the max is all-reduced (MAX, no gradient: a shift),
    then the sum of exp and the label's logit (SUM); otherwise
    ``torch.logsumexp``, as one device computes it."""
    lo, split = _vocab_rows(run.specs["unembed"][1], unembed.shape[1], run)
    if not split:
        logits = torch.einsum("bsd,dv->bsv", h, unembed).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return logz - ll
    logits = torch.einsum("bsd,dv->bsv", copy_to(h, run.model_group),
                          unembed).float()
    m = all_reduce(logits.detach().amax(dim=-1), run.model_group,
                   dist.ReduceOp.MAX)
    se = reduce_to(torch.exp(logits - m[..., None]).sum(dim=-1),
                   run.model_group)
    mine = (labels >= lo) & (labels < lo + unembed.shape[1])
    ll = torch.gather(logits, -1, (labels - lo).clamp(
        0, unembed.shape[1] - 1)[..., None])[..., 0]
    ll = reduce_to(torch.where(mine, ll, torch.zeros_like(ll)),
                   run.model_group)
    return m + torch.log(se) - ll
