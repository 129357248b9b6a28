"""Device dispatch for the kernels.

A CUDA tensor goes to the hand-written CUDA kernel, whose wrapper
launches it or raises; a CPU tensor goes to the plain PyTorch version in
``ref``. There is no fallback from one to the other. The three kernels a
train step reaches (``zo_perturb``, ``zo_fused_replay``,
``flash_attention``) also take ``meta`` tensors, for the dry run
(``launch/dryrun.py``): outputs of the kernel's shape and dtype, or the
kernel's in-place write, and no launch; and while a cost counter is
active (``cost.counting``) each records its launch and its cost, on
every device. The other kernels raise for ``meta``.
"""
from __future__ import annotations

import torch

from . import cost
from . import flash_attn as _flash
from . import int8_matmul as _int8_matmul
from . import paged_attn, ref, topk_mask
from . import zo_fused_replay as _replay
from . import zo_perturb as _perturb


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    return_lse: bool = False):
    """Online-softmax attention in the JAX layout: q [B,H,Sq,D], k/v
    [B,Hkv,Sk,D] (q head h reads kv head h // (H / Hkv)) -> o [B,H,Sq,D]
    in q's dtype; query row i at position ``q_offset + i``, key j at j
    (masks top-left aligned at offset 0). With ``return_lse``, (o, lse):
    each row's log-sum-exp of its scaled, masked scores, f32 [B,H,Sq].
    Forward only, as the TPU kernel is: an input that requires grad
    raises, on every device."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention has no backward; an input "
                         "requires grad")
    counter = cost.active()
    if counter is not None and q.numel():
        counter.kernel("flash_attention", q.dtype, cost.flash_attention(
            tuple(q.shape), tuple(k.shape), q.dtype, causal=causal,
            window=window, q_offset=q_offset, lse=return_lse))
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if return_lse:
        kw["return_lse"] = True
    if q.is_cuda:
        return _flash.flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, **kw)
    if q.is_meta:
        o = torch.empty_like(q)
        return (o, torch.empty(q.shape[:3], dtype=torch.float32,
                               device="meta")) if return_lse else o
    raise ValueError(f"flash_attention: no path for {q.device}")


def paged_attention_step(q, k_new, v_new, k_pool, v_pool, page_table,
                         seq_lens, *, scale: float, window: int = 0):
    """Fused paged decode step: writes the token's K/V into the pools in
    place and returns o [B,KVd,G,Dh]. Rows with no live position differ
    between the two paths (see ``ref.paged_attn_step_ref``); callers
    read active rows only."""
    if q.is_cuda:
        return paged_attn.paged_attention_step(
            q, k_new, v_new, k_pool, v_pool, page_table, seq_lens,
            scale=scale, window=window)
    if q.device.type == "cpu":
        return ref.paged_attn_step_ref(q, k_new, v_new, k_pool, v_pool,
                                       page_table, seq_lens, scale=scale,
                                       window=window)
    raise ValueError(f"paged_attention_step: no path for {q.device}")


def topk_topp_mask(logits, k, p):
    """Sort-free top-k/top-p filter. logits [B, V] f32; k [B] int (<= 0
    disables); p [B] f32 (>= 1 disables). Returns logits with filtered
    entries at -1e30; keep-set contract in ``ref.topk_topp_mask_ref``."""
    if logits.is_cuda:
        return topk_mask.topk_topp_mask(logits, k, p)
    if logits.device.type == "cpu":
        return ref.topk_topp_mask_ref(logits, k, p)
    raise ValueError(f"topk_topp_mask: no path for {logits.device}")


def zo_perturb(theta, seed, salt: int, scale: float, offset: int = 0,
               index=None):
    """theta' = cast(theta + scale * z(seed, salt, offset + flat index)).
    seed: an int32 [1] tensor on theta's device holding the uint32 seed;
    ``offset`` places theta inside a larger leaf (a period's slice of a
    stacked leaf draws that leaf's noise); ``index`` (a
    ``core/prng.py::IndexMap``) places a rank's shard of a sharded leaf
    at its global flat indices."""
    counter = cost.active()
    if counter is not None and theta.numel():
        shard = index is not None and not (
            index.is_contiguous and index.max_index < 2**32)
        counter.kernel("zo_perturb", theta.dtype, (
            cost.zo_perturb_shard if shard else cost.zo_perturb)(
                theta.numel(), theta.dtype))
    if theta.is_cuda:
        return _perturb.zo_perturb(theta, seed, salt, scale, offset, index)
    if theta.device.type == "cpu":
        return ref.zo_perturb_ref(theta, seed, salt, scale, offset, index)
    if theta.is_meta:
        return torch.empty_like(theta)
    raise ValueError(f"zo_perturb: no path for {theta.device}")


def zo_fused_replay(theta, seeds, coeffs, salt: int, out=None, index=None):
    """S steps x P probes of (seed, coeff) records applied to one leaf,
    accumulate-then-cast per step. seeds int32 [S, P] (uint32 values),
    coeffs f32 [S, P], on theta's device. ``out`` may be theta itself
    (an in-place update); ``index`` as in ``zo_perturb``."""
    counter = cost.active()
    if counter is not None and theta.numel():
        shard = index is not None and not (index.is_contiguous
                                           and index.base == 0)
        counter.kernel("zo_fused_replay", theta.dtype, (
            cost.zo_fused_replay_shard if shard else cost.zo_fused_replay)(
                theta.numel(), theta.dtype, seeds.numel()))
    if theta.is_cuda:
        return _replay.zo_fused_replay(theta, seeds, coeffs, salt, out=out,
                                       index=index)
    if theta.device.type == "cpu":
        new = ref.zo_fused_replay_ref(theta, seeds, coeffs, salt,
                                      index=index)
        return new if out is None else out.copy_(new)
    if theta.is_meta:
        return torch.empty_like(theta) if out is None else out
    raise ValueError(f"zo_fused_replay: no path for {theta.device}")


def _leaves_device(name: str, thetas):
    dev = thetas[0].device
    if any(t.device != dev for t in thetas):
        raise ValueError(f"{name}: the leaves are not on one device")
    return dev


def int8_perturb_leaves(thetas, seed, salts, k: int, r_max: int, p_zero):
    """theta' = clamp(theta + k * z, -127, 127) on every int8 leaf of
    ``thetas``, z the int8 lane's sparse uniform noise from (seed, the
    leaf's salt, the leaf's flat index). seed: an int32 [1] tensor on the
    leaves' device holding the uint32 seed; k, r_max and p_zero are host
    numbers shared by all leaves. On the card one launch covers up to
    ``zo_perturb.MAX_LEAVES`` leaves and the new leaves are views into one
    buffer; on the CPU each leaf takes the plain version. Returns the new
    leaves in order."""
    if not thetas:
        return []
    dev = _leaves_device("int8_perturb", thetas)
    if dev.type == "cuda":
        return _perturb.int8_perturb_leaves(thetas, seed, salts, k, r_max,
                                            p_zero)
    if dev.type == "cpu":
        return [ref.int8_perturb_ref(t, seed, salt, k, r_max, p_zero)
                for t, salt in zip(thetas, salts)]
    raise ValueError(f"int8_perturb: no path for {dev}")


def zo_fused_replay_int8_leaves(thetas, seeds, gs, salts, r_max: int, p_zero,
                                shift: int, outs=None):
    """S steps x P probes of (seed, ternary g) records applied to every
    int8 leaf of ``thetas`` (each leaf its own salt), int32 accumulate
    then one clamp per step. seeds int32 [S, P] (uint32 values), gs int32
    [S, P], on the leaves' device; one launch on the card as
    ``int8_perturb_leaves``. ``outs`` may be ``thetas`` itself (an
    in-place update). Returns the new leaves (or ``outs``) in order."""
    if not thetas:
        return []
    dev = _leaves_device("zo_fused_replay_int8", thetas)
    if dev.type == "cuda":
        return _replay.zo_fused_replay_int8_leaves(
            thetas, seeds, gs, salts, r_max, p_zero, shift, outs=outs)
    if dev.type == "cpu":
        new = [ref.zo_fused_replay_int8_ref(t, seeds, gs, salt, r_max, p_zero,
                                            shift)
               for t, salt in zip(thetas, salts)]
        return new if outs is None else [o.copy_(n) for o, n in zip(outs, new)]
    raise ValueError(f"zo_fused_replay_int8: no path for {dev}")


def int8_matmul(a, w):
    """int8 a [M, K] x int8 w [K, N] -> (int32 [M, N], max|out| int32 0-d
    tensor)."""
    if a.is_cuda:
        return _int8_matmul.int8_matmul(a, w)
    if a.device.type == "cpu":
        return ref.int8_matmul_ref(a, w)
    raise ValueError(f"int8_matmul: no path for {a.device}")
