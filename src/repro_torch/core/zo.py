"""Zeroth-order (SPSA) machinery with the MeZO seed-replay trick.

The port of ``repro/core/zo.py``. The perturbation z ~ N(0, I) is never
stored: it is regenerated from a probe's uint32 seed every time it is
needed (perturb +, perturb -, update). On the card each leaf goes through
one hand-written kernel (``kernels/ops.py``): ``zo_perturb`` for theta +
scale * z (a whole leaf, or one period's slice of a stacked leaf in the
fused-probe lane), ``zo_fused_replay`` for the update, each one read and
one write of the leaf. On the CPU the same calls take the plain versions.

Noise streams are salted per leaf by the crc32 of the leaf's path string,
exactly as ``jax.tree_util.keystr`` spells it inside the tree being
perturbed, so the port draws the JAX package's z for every leaf.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from . import prng


def keystr(path: Sequence[str]) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys, e.g.
    ``['periods_zo']['blk0']['mlp']['w_gate']``."""
    return "".join(f"[{k!r}]" for k in path)


def path_salt(path: Sequence[str], prefix: str = "") -> int:
    return zlib.crc32((prefix + keystr(path)).encode()) & 0x3FFFFFFF


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, same structure. ``fn`` is
    called in ``leaves_with_path``'s order; the result keeps ``tree``'s
    key order."""
    if isinstance(tree, dict):
        out = {k: map_with_path(fn, tree[k], path + (k,))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn(path, tree)


def leaves_with_path(tree, path=()):
    """(path, leaf) for every leaf of a nested dict (a tensor or a
    ``QTensor``) in ``jax.tree_util``'s order: keys sorted. The fleet's
    wire format (a record's tail is a flat list of leaves) and the
    checkpoint format are defined in this order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def rebuild(tree, new_leaves):
    """``tree``'s structure with its leaves replaced by ``new_leaves``,
    taken in ``leaves_with_path``'s order."""
    it = iter(new_leaves)
    out = map_with_path(lambda _p, _l: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("rebuild: more leaves than the tree holds")
    return out


def device_seeds(seeds: Sequence[int], device) -> torch.Tensor:
    """Host uint32 seeds -> an int32 tensor on ``device`` holding their
    bits. To a card the copy goes from pinned memory without blocking, so
    the host never waits on the device for it."""
    t = torch.from_numpy(np.asarray(seeds, np.uint32).view(np.int32).copy())
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def leaf_noise(seed, path, leaf: torch.Tensor) -> torch.Tensor:
    """The f32 z for one leaf (the plain version's; tests and checks)."""
    seed = seed.reshape(()) if isinstance(seed, torch.Tensor) else seed
    return prng.normal(seed, path_salt(path), leaf.shape, device=leaf.device)


def perturb(params, seed: torch.Tensor, scale: float, maps=None):
    """theta + scale * z for every leaf, out of place (theta is needed
    again for the other probes and the update). seed: int32 [1] on the
    params' device. ``maps``: on a mesh, a tree like ``params`` of each
    shard's ``prng.IndexMap`` (its global flat indices), so every rank
    perturbs its shards with no communication and draws the one-device
    z of its elements."""
    return map_with_path(
        lambda path, leaf: ops.zo_perturb(leaf, seed, path_salt(path), scale,
                                          index=_at(maps, path)), params)


def perturb_slice(pparams, salts, sizes, p_idx: int, seed: torch.Tensor,
                  scale: float, maps=None):
    """theta + scale * z for one period's slice of a stacked period tree,
    z drawn so that it equals the stacked leaf's noise of that slice: the
    salt of the *stacked* leaf's path and the flat-index offset p_idx *
    size (``repro/core/zo.py::perturb_slice``). pparams: the slice;
    salts / sizes: trees of the same structure (stacked-path salt, slice
    size); seed: int32 [1] on the params' device. ``maps``: on a mesh,
    where ``pparams`` holds the rank's shards of the slice, a tree of
    their ``prng.IndexMap``s in the stacked leaf (``sharding/collectives.
    py::MeshRun.period_maps``), in place of the offsets."""
    def f(path, leaf):
        salt = _at(salts, path)
        if maps is not None:
            return ops.zo_perturb(leaf, seed, salt, scale,
                                  index=_at(maps, path))
        return ops.zo_perturb(leaf, seed, salt, scale,
                              p_idx * _at(sizes, path))
    return map_with_path(f, pparams)


def _at(tree, path):
    """The leaf of ``tree`` at ``path`` (None for a None tree)."""
    if tree is None:
        return None
    for k in path:
        tree = tree[k]
    return tree


def zo_update(params, seed: torch.Tensor, step_size: torch.Tensor,
              maps=None):
    """theta - step_size * z (z replayed from ``seed``): one-record
    ``zo_fused_replay``. step_size: an f32 scalar tensor on the params'
    device, so the update needs no device-to-host read. ``maps`` as in
    ``perturb``."""
    seeds = seed.reshape(1, 1)
    coeffs = step_size.to(torch.float32).reshape(1, 1)
    return map_with_path(
        lambda path, leaf: ops.zo_fused_replay(leaf, seeds, coeffs,
                                               path_salt(path),
                                               index=_at(maps, path)),
        params)


def projected_gradient(l_plus, l_minus, eps: float,
                       clip: Optional[float] = None):
    g = (l_plus - l_minus) / (2.0 * eps)
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


def spsa_gradient_estimate(loss_fn: Callable[[Any], torch.Tensor], params,
                           seed: torch.Tensor, eps: float,
                           clip: Optional[float] = None):
    """Two-point SPSA estimate (``repro/core/zo.py::spsa_gradient_estimate``):
    (g, l_plus, l_minus) with g = clip((l+ - l-) / 2eps). The caller
    applies ``zo_update`` with the same seed (int32 [1] on the params'
    device). Gradient-free: runs under ``torch.no_grad``, and the +eps
    copy is freed before the -eps one is made."""
    with torch.no_grad():
        l_plus = loss_fn(perturb(params, seed, eps))
        l_minus = loss_fn(perturb(params, seed, -eps))
    return projected_gradient(l_plus, l_minus, eps, clip), l_plus, l_minus
