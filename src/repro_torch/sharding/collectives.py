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
    along ``dim`` forward, reduce-scatter of the gradient backward (the
    group's ranks held different rows);
  * ``replica_gather(x, group, dim, index)``: all-gather forward, the
    rank's own part of the gradient backward, with no sum (the group's
    ranks held the same rows and computed the same thing);
  * ``seq_gather``: the sequence-sharded attention's output blocks
    gathered along the sequence, the rank's own block of the gradient
    backward;
  * ``all_to_all(x, group, split_dim, cat_dim)``: x split into the
    group's ranks' parts along ``split_dim``, part j sent to rank j, the
    parts received concatenated along ``cat_dim`` in rank order; the
    reverse all-to-all backward (the MoE's expert dispatch and its
    return under the ``ep`` plan where `model` is a batch axis). It
    moves data and sums nothing, so it is exact in any dtype;
  * ``MeshRun.weight``: a leaf as the model uses it, by the rules: its
    shards gathered over every axis its spec names that carries no TP
    compute (`data` under ``tp``; `data` and `model` under ``fsdp``)
    except the expert axis of an expert leaf (`model` under the MoE
    ``ep`` plan, in every strategy), its gradient summed over each batch
    axis (``rules.batch_axes``: `pod`, `data`, and `model` under
    ``fsdp`` when the batch divides dp * tp);
  * ``MeshRun.batch_sum``: a sum over every batch axis (the loss and its
    mask count).

Each collective is recorded into the active cost counter
(``kernels/cost.py::counting``), with its kind, group, output bytes and
the bytes it moves a rank (``kernels/cost.py::bytes_moved``'s ring
conventions), in a real run and in the dry run alike.

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

from ..kernels import cost
from ..launch.mesh import axis_shape
from .params import (ShardDesc, kept_desc, map_dict, param_shardings,
                     period_map, shard_desc, shard_descs, unshard_leaf)
from .rules import ShardingRules

# the collectives the port calls on CUDA tensors, which gloo must take
# (torch 2.11 does: chip_smoke.py::gloo_cuda_probe / check_gloo_probe)
GLOO_CUDA_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
# the leaves whose leading dim is the expert dim (under ``moe`` blocks)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
EXECUTED_AXES = ("pod", "data", "model")


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _record(kind: str, out: torch.Tensor, group):
    """The collective into the active cost counter, if there is one."""
    counter = cost.active()
    if counter is None:
        return
    ranks = tuple(dist.get_process_group_ranks(group)) if group is not None \
        else tuple(range(dist.get_world_size()))
    nbytes = out.numel() * out.element_size()
    counter.collective(cost.Collective(kind, ranks, nbytes,
                                       cost.bytes_moved(kind, nbytes,
                                                        len(ranks))))


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``group``, a new tensor of t's dtype
    (floats summed in f32); ``t`` itself on a group of one."""
    if _size(group) == 1:
        return t
    x = t.detach().to(torch.float32, copy=True) if t.is_floating_point() \
        else t.detach().clone()
    dist.all_reduce(x, op=op, group=group)
    _record("all-reduce", x, group)
    return x.to(t.dtype)


def _gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape everywhere), stacked: [n, *x.shape]
    (the group's ranks in order; the default group for None)."""
    n = dist.get_world_size(group)
    flat = x.detach().reshape(-1).contiguous()
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    _record("all-gather", out, group)
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
    _record("reduce-scatter", out, group)
    return out.reshape(shape).to(t.dtype)


def _all_to_all(t: torch.Tensor, group, split_dim: int,
                cat_dim: int) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return t
    parts = torch.stack(t.detach().chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out.reshape(-1), parts.reshape(-1), group=group)
    _record("all-to-all", out, group)
    return torch.cat(out.unbind(0), dim=cat_dim)


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


class _ReplicaGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.n, ctx.dim, ctx.index = _size(group), dim, index
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        part = g.chunk(ctx.n, ctx.dim)[ctx.index].contiguous()
        return part, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return _all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.cat_dim, ctx.split_dim), None,
                None, None)


def _padded_gather(x, group, dim: int, total: int) -> torch.Tensor:
    """Every rank's block of at most ceil(total / n) along ``dim``, each
    padded to that size, gathered, and cut to ``total``."""
    pad = list(x.shape)
    pad[dim] = -(-total // _size(group)) - x.shape[dim]
    return all_gather(torch.cat([x, x.new_zeros(pad)], dim=dim), group,
                      dim).narrow(dim, 0, total)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, lo, total):
        ctx.dim, ctx.lo, ctx.n = dim, lo, x.shape[dim]
        return _padded_gather(x, group, dim, total)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None,
                None, None)


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


def replica_gather(x: torch.Tensor, group, dim: int,
                   index: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward, part ``index`` (this
    rank's place in ``group``) of the gradient, unsummed: every rank of
    the group computed the same gradient of the whole."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return all_gather(x, group, dim)
    return _ReplicaGather.apply(x, group, dim, index)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``x`` split along ``split_dim`` into one part per rank of
    ``group`` (the dim divides evenly), part j sent to rank j, and the
    parts received concatenated along ``cat_dim`` in rank order: x's
    dtype, every value moved exactly. Backward: the reverse all-to-all
    of the gradient (split along ``cat_dim``, concatenated along
    ``split_dim``)."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return _all_to_all(x, group, split_dim, cat_dim)
    return _AllToAll.apply(x, group, split_dim, cat_dim)


def seq_gather(x: torch.Tensor, group, dim: int, lo: int,
               total: int) -> torch.Tensor:
    """The ``total`` positions along ``dim`` from every rank's block of
    them, this rank's starting at ``lo``: blocks of ceil(total / n), the
    last ranks' shorter or empty (each padded to the full size for the
    gather, the padding cut after it). Backward: the rank's own block of
    the gradient, unsummed (what follows is the same on every rank of
    the group)."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return _padded_gather(x, group, dim, total)
    return _SeqGather.apply(x, group, dim, lo, total)


def _block_specs(stack):
    """{blk: spec tree} of a stacked period group's specs, each spec's
    leading (period) dim dropped; empty for None."""
    return {k: map_dict(lambda _n, s: s[1:], v)
            for k, v in (stack or {}).items()}


class MeshRun:
    """A mesh bound to a model's parameters on this rank: the rules, the
    process group, size and coordinate of each mesh axis, every leaf's
    spec (``param_shardings``) and this rank's shard descriptors.

    ``abstract_params``: the global tree of shapes
    (``core/api.py::abstract_params``). Executes meshes over `pod`,
    `data` and `model` (any other axis raises), in every strategy of the
    rules: ``batch_axes`` are the rules' (the axes the batch rows are
    split over, and the loss summed over), ``compute_axis`` the axis of
    TP compute (`model` under ``tp`` and ``serve``, None under
    ``fsdp``) and ``tp`` its size (1 under ``fsdp``); ``expert_axis``
    the axis an expert leaf's expert dim stays split over (`model` under
    the MoE ``ep`` plan in every strategy, else None)."""

    def __init__(self, mesh, rules: ShardingRules, abstract_params):
        sizes = axis_shape(mesh)
        other = [a for a in sizes if a not in EXECUTED_AXES]
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: the port executes meshes over "
                f"{EXECUTED_AXES}")
        self.mesh, self.rules = mesh, rules
        self.axes = tuple(sizes)
        self.sizes = sizes
        self.groups = {a: mesh.get_group(a) for a in self.axes}
        self.coords = {a: mesh.get_local_rank(a) for a in self.axes}
        self.batch_axes = tuple(rules.batch_axes)
        self.compute_axis = rules.model_compute
        self.tp = rules.tp
        # the expert dim's axis under the MoE ep plan: `model`, in every
        # strategy (``fsdp`` too, where `model` carries no TP compute)
        self.expert_axis = rules.model_axis if rules.moe == "ep" else None
        self.world = prod(sizes.values())
        self.rank = dist.get_rank()
        self.shapes = map_dict(lambda _n, t: tuple(t.shape),
                               abstract_params)
        self.specs = param_shardings(abstract_params, rules)
        self.descs = shard_descs(abstract_params, self.specs, self.coords,
                                 sizes)
        # each stacked group's block specs, the period dim dropped: the
        # decoder's (its blocks carry ln_cross / cross in Whisper) and
        # Whisper's encoder's
        self.block_specs = _block_specs(self.specs.get("periods_zo")
                                        or self.specs.get("periods_bp"))
        self.encoder_block_specs = _block_specs(
            self.specs.get("encoder", {}).get("periods"))

    # ---- groups ------------------------------------------------------- #
    @property
    def model_group(self):
        return self.groups.get("model")

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

    @property
    def whole_weights(self) -> bool:
        """Whether the model computes on whole weights: no TP compute
        (``tp`` 1: the ``fsdp`` strategy, or a `model` axis of one), so
        ``weight`` gathers every leaf whole, attention and the MLP run
        their one-device forms (``models/layers.py``), the embedding and
        the loss use the whole table, and fused probes perturb a gathered
        period (``models/transformer.py::run_periods_paired``)."""
        return self.tp == 1

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every batch axis (gradient passed through)."""
        for a in self.batch_axes:
            x = reduce_to(x, self.groups[a])
        return x

    # ---- leaves --------------------------------------------------------- #
    def kept_axes(self, names) -> tuple:
        """The axes ``weight`` leaves the leaf at ``names`` split over:
        the TP compute axis, and an expert leaf's expert axis (a
        ``moe`` block's w_gate / w_up / w_down under the ``ep`` plan)."""
        expert = "moe" in names and names[-1] in EXPERT_LEAVES
        return (self.compute_axis, self.expert_axis if expert else None)

    def weight(self, t: torch.Tensor, spec, keep=None) -> torch.Tensor:
        """A leaf shard as the model uses it. Gathered along each dim its
        spec shards over an axis not in ``keep`` (default: the TP compute
        axis; ``kept_axes`` of the leaf): the gradient reduce-scattered
        back where that axis is a batch axis (its ranks held other rows),
        the rank's own part of it where not (its ranks computed the
        same). A leaf replicated over a batch axis has its gradient
        summed there. Still sharded over the axes in ``keep``."""
        keep = (self.compute_axis,) if keep is None else keep
        spec = tuple(spec) if spec is not None else (None,) * t.dim()
        named = set()
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            if len(axes) != 1:
                raise NotImplementedError(f"spec {spec}: a dim over "
                                          "several axes")
            a = axes[0]
            named.add(a)
            if a in keep:
                continue
            if a in self.batch_axes:
                t = fsdp_gather(t, self.groups[a], dim)
            else:
                t = replica_gather(t, self.groups[a], dim, self.coords[a])
        for a in self.batch_axes:
            if a not in named:
                t = copy_to(t, self.groups[a])
        return t

    def weights(self, tree, specs):
        """``weight`` of every leaf of a tree, each with the spec at its
        own names in the spec tree ``specs`` (matched by name, not by
        order, so a tree with fewer leaves takes the right specs)."""
        def spec_at(names):
            s = specs
            for k in names:
                s = s[k]
            return s
        return map_dict(lambda names, t: self.weight(
            t, spec_at(names), self.kept_axes(names)), tree)

    def index_maps(self, descs=None):
        """The ``IndexMap`` of every leaf's shard (of ``descs``, by
        default the params')."""
        return map_dict(lambda _n, d: d.index,
                        self.descs if descs is None else descs)

    def period_maps(self, group: str, p: int, gathered: bool = False):
        """The ``IndexMap`` of period ``p``'s slice of the rank's shard of
        every leaf of the stacked tree ``group`` (its period dim is never
        sharded); with ``gathered``, of the slice as ``weights`` returns
        it: gathered over every axis but the leaf's ``kept_axes`` (whole
        under ``fsdp``, but for an expert leaf's block of E / tp experts
        under the ``ep`` plan, one contiguous run)."""
        def f(names, d):
            if gathered:
                d = kept_desc(d, self.kept_axes(names))
            return period_map(d, p)
        return map_dict(f, self.descs[group])

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
        all-gather over the world, also at one rank). On ``meta`` (the
        dry run) the gather is made and nothing compared."""
        bits = t.detach().reshape(-1)
        bits = bits.view(torch.int32) if bits.element_size() == 4 \
            else bits.to(torch.float64).view(torch.int64)
        out = _gather_flat(bits, None)
        if out.is_meta:         # the dry run: gathered, no values to hold
            return
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
    `model` for TP compute) of a table whose vocab dim has
    ``table_spec``."""
    from ..models.layers import _model_sharded
    split = not run.whole_weights and _model_sharded((table_spec,))
    return (run.model_rank * v_local if split else 0), split


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, run: MeshRun):
    """Rows of the embedding table [V, D] (spec (model, data)) for
    tokens [B, S]: gathered as ``MeshRun.weight`` says (whole under
    ``fsdp``: a plain lookup then); where its vocab rows stay split over
    `model`, each rank takes the tokens in its rows, zeros for the rest,
    and the rows are all-reduced over `model`."""
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
    [D, V_local] (gathered by ``MeshRun.weight``: whole under ``fsdp``).
    With the vocab split over `model`: the max is all-reduced (MAX, no
    gradient: a shift), then the sum of exp and the label's logit (SUM);
    otherwise ``torch.logsumexp``, as one device computes it."""
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
