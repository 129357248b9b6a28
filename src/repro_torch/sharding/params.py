"""Per-leaf specs of the LM parameter and cache trees, and each rank's
shard of a leaf.

The port of ``repro/sharding/params.py``: ``param_shardings`` and
``cache_shardings`` give every leaf its spec (a tuple of mesh axes per
dim) after the divisibility fallback, equal to the JAX package's
``PartitionSpec``s. Weights are TP-sharded over `model` on the dim the
rules pick and FSDP-sharded over `data` on a complementary dim; stacked
period leaves get an extra unsharded leading (layer) axis
(docs/design.md §5).

What the port adds: a rank's ``ShardDesc`` of a leaf (its slice of the
global leaf, its local shape, and its global flat-index map, the
``core/prng.py::IndexMap`` that the ZO noise kernels draw at; ``kept_desc``
of a shard gathered over all but some axes, ``period_map`` of a period's
slice), and ``shard_leaf`` / ``unshard_leaf`` between a global leaf and
its shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from ..core.prng import IndexMap
from .rules import ShardingRules, axes_size

STACKED = ("periods_zo", "periods_bp", "periods")


def _spec_for(path_names, leaf_name, rules: ShardingRules):
    r = rules
    n = leaf_name
    if n in ("embed",):
        return r.spec_embed()
    if n == "unembed":
        return r.spec_unembed()
    if n == "pos_embed":
        return (None, r.fsdp)
    if n in ("final_norm",):
        return (None,)
    # attention
    if n in ("wq", "wk", "wv"):
        return r.spec_attn_qkv()
    if n == "wo" and "attn" in path_names or n == "wo" and "cross" in path_names:
        return r.spec_attn_o()
    if n in ("q_norm", "k_norm"):
        return (None,)
    # dense mlp
    if n in ("w_gate", "w_up") and "moe" not in path_names:
        return r.spec_mlp_in()
    if n == "w_down" and "moe" not in path_names:
        return r.spec_mlp_out()
    # moe
    if n == "router":
        return r.spec_router()
    if n in ("w_gate", "w_up"):
        return r.spec_moe_in()
    if n == "w_down":
        return r.spec_moe_out()
    # rwkv
    if n in ("w_r", "w_k", "w_v", "w_g"):
        return (r.fsdp, r.wmodel)
    if n == "w_o":
        return (r.wmodel, r.fsdp)
    if n in ("maa_w1", "decay_w1"):
        return (r.fsdp, None)
    if n == "maa_w2":
        return (None, None, r.fsdp)
    if n == "decay_w2":
        return (None, r.wmodel)
    if n == "maa_base":
        return (None, None)
    if n in ("maa_x", "decay_base", "cm_mu_k", "cm_mu_r",
             "ln1", "ln2", "ln_attn", "ln_ffn", "ln_cross",
             "conv_b_dummy"):
        return (None,)
    if n in ("bonus", "gn_scale"):
        return (r.wmodel, None)
    if n == "cm_k":
        return (r.fsdp, r.wmodel)
    if n == "cm_v":
        return (r.wmodel, r.fsdp)
    if n == "cm_r":
        return (r.fsdp, None)
    # mamba
    if n == "in_proj":
        return (r.fsdp, r.wmodel)
    if n == "conv_w":
        return (None, r.wmodel)
    if n in ("conv_b", "dt_bias", "D_skip"):
        return (r.wmodel,)
    if n == "x_proj":
        return (r.wmodel, None)
    if n == "dt_proj":
        return (None, r.wmodel)
    if n == "A_log":
        return (r.wmodel, None)
    if n == "out_proj":
        return (r.wmodel, r.fsdp)
    if n in ("dt_norm", "B_norm", "C_norm", "norm"):
        return (None,)
    return None     # fall back to replicated-with-rank


def map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree of dicts, tuples and lists: the
    dict keys on the way (tuple and list positions add none, as the JAX
    package's ``_path_names`` reads a pytree path). Keeps the structure."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_names(fn, v, names) for v in tree)
    return fn(names, tree)


def map_dict(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree of nested dicts (a parameter tree,
    or its tree of specs, whose tuple leaves stay whole)."""
    if isinstance(tree, dict):
        return {k: map_dict(fn, v, names + (str(k),)) for k, v in tree.items()}
    return fn(names, tree)


def dict_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, in its order."""
    out = []
    map_dict(lambda _n, leaf: out.append(leaf), tree)
    return out


def _fit(spec, shape, rules: ShardingRules):
    """``spec`` padded / cut to the leaf's rank, with every sharding that
    does not divide its dim evenly dropped."""
    spec = tuple(spec)[:len(shape)] + (None,) * max(0, len(shape) - len(spec))
    return tuple(ax if ax is None or dim % axes_size(rules.sizes, ax) == 0
                 else None for dim, ax in zip(shape, spec))


def param_shardings(abstract_params, rules: ShardingRules):
    """The spec of every leaf of ``abstract_params`` (anything with a
    ``shape``: meta tensors from ``core/api.py::abstract_params``), the
    tree's structure; every leaf None without a mesh."""
    if rules.mesh is None:
        return map_dict(lambda _n, _l: None, abstract_params)

    def f(names, leaf):
        shape = tuple(leaf.shape)
        spec = _spec_for(names, names[-1], rules)
        if spec is None:
            spec = (None,) * len(shape)
        if any(p in STACKED for p in names):
            spec = (None,) + tuple(spec)
        return _fit(spec, shape, rules)

    return map_dict(f, abstract_params)


def cache_spec(name: str, shape, rules: ShardingRules):
    """The spec of a cache leaf called ``name`` of ``shape`` (fitted)."""
    if name in ("k", "v", "ck", "cv"):
        spec = rules.spec_kv_cache()
    elif name == "ssm":
        spec = rules.spec_ssm_cache()
    elif name == "wkv":
        spec = rules.spec_rwkv_cache()
    elif name == "conv":
        spec = rules.spec_conv_cache()
    elif name in ("tm_shift", "cm_shift"):
        spec = (None, rules.batch, None, None)
    else:
        spec = (None,) * len(shape)
    return _fit(spec, tuple(shape), rules)


def cache_shardings(abstract_caches, rules: ShardingRules):
    """Specs of the (zo, bp) cache tree by leaf name and rank."""
    if rules.mesh is None:
        return map_with_names(lambda _n, _l: None, abstract_caches)
    return map_with_names(lambda names, leaf: cache_spec(
        names[-1] if names else "", leaf.shape, rules), abstract_caches)


# ---------------------------------------------------------------------- #
# a rank's shard of a leaf
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShardDesc:
    """A rank's shard of a leaf of ``global_shape`` under ``spec``:
    ``starts[k]:starts[k] + local_shape[k]`` along each dim, and the
    global flat index of each local element (``index``)."""
    global_shape: Tuple[int, ...]
    spec: Tuple
    starts: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    index: IndexMap

    @property
    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(s, s + n)
                     for s, n in zip(self.starts, self.local_shape))

    @property
    def whole(self) -> bool:
        return self.local_shape == self.global_shape


def axis_index(coords: Dict[str, int], sizes: Dict[str, int], ax) -> int:
    """The shard index along a dim sharded over ``ax`` (a name or a tuple
    of names, the first the major one)."""
    i = 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        i = i * sizes[a] + coords[a]
    return i


def index_map(global_shape: Sequence[int], starts: Sequence[int],
              local_shape: Sequence[int]) -> IndexMap:
    """The flat-index map of the block ``starts + local_shape`` of a
    row-major leaf: extent-1 dims dropped, and a dim merged into the
    next outer one where the two are contiguous."""
    strides, s = [], 1
    for d in reversed(tuple(global_shape)):
        strides.append(s)
        s *= d
    strides.reverse()
    base = sum(a * b for a, b in zip(starts, strides))
    levels = []
    for n, st in zip(local_shape, strides):
        if n == 1:
            continue
        if levels and levels[-1][1] == n * st:
            levels[-1] = (levels[-1][0] * n, st)
        else:
            levels.append((n, st))
    if not levels:
        levels = [(1 if all(local_shape) else 0, 1)]
    return IndexMap(base, levels)


def shard_desc(global_shape, spec, coords: Dict[str, int],
               sizes: Dict[str, int]) -> ShardDesc:
    """The shard of the rank at mesh ``coords`` ({axis: index}) of a leaf
    of ``global_shape`` under ``spec`` (None: replicated)."""
    shape = tuple(int(d) for d in global_shape)
    spec = tuple(spec) if spec is not None else (None,) * len(shape)
    starts, local = [], []
    for dim, ax in zip(shape, spec):
        if ax is None:
            starts.append(0)
            local.append(dim)
            continue
        n = axes_size(sizes, ax)
        if dim % n:
            raise ValueError(f"a dim of {dim} does not split {n} ways "
                             f"(spec {spec}; param_shardings drops such)")
        ext = dim // n
        starts.append(axis_index(coords, sizes, ax) * ext)
        local.append(ext)
    return ShardDesc(shape, spec, tuple(starts), tuple(local),
                     index_map(shape, starts, local))


def kept_desc(desc: ShardDesc, keep) -> ShardDesc:
    """``desc`` gathered over every axis but those in ``keep``: each dim
    whose spec names another axis made whole (what
    ``sharding/collectives.py::MeshRun.weight`` returns of the shard)."""
    whole = [ax is not None and ax not in keep for ax in desc.spec]
    starts = tuple(0 if w else s for w, s in zip(whole, desc.starts))
    local = tuple(g if w else n for w, g, n in zip(
        whole, desc.global_shape, desc.local_shape))
    return ShardDesc(desc.global_shape, desc.spec, starts, local,
                     index_map(desc.global_shape, starts, local))


def period_map(desc: ShardDesc, p: int) -> IndexMap:
    """The flat-index map of period ``p``'s slice of the shard ``desc`` of
    a stacked leaf (its leading period dim unsharded): the shard's map of
    one period, its base moved by p * (the global slice's size)."""
    shape = desc.global_shape[1:]
    m = index_map(shape, desc.starts[1:], desc.local_shape[1:])
    return IndexMap(m.base + p * math.prod(shape), m.levels)


def shard_descs(abstract_tree, specs, coords, sizes):
    """``shard_desc`` of every leaf (``abstract_tree``'s shapes,
    ``specs`` of the same structure, e.g. ``param_shardings``')."""
    it = iter(dict_leaves(specs))
    return map_dict(
        lambda _n, leaf: shard_desc(tuple(leaf.shape), next(it), coords,
                                    sizes), abstract_tree)


def shard_leaf(t: torch.Tensor, desc: ShardDesc) -> torch.Tensor:
    """The rank's shard of the global leaf ``t``, its own contiguous
    memory (or ``t`` itself where the shard is the whole leaf)."""
    if tuple(t.shape) != desc.global_shape:
        raise ValueError(f"leaf of shape {tuple(t.shape)}, shard of "
                         f"{desc.global_shape}")
    if desc.whole:
        return t
    return t[desc.slices].contiguous()


def unshard_leaf(shards: Sequence[torch.Tensor],
                 descs: Sequence[ShardDesc]) -> torch.Tensor:
    """The global leaf from every rank's shard and descriptor (replicas
    write the same values)."""
    out = torch.empty(descs[0].global_shape, dtype=shards[0].dtype,
                      device=shards[0].device)
    for t, d in zip(shards, descs):
        out[d.slices] = t.reshape(d.local_shape)
    return out
