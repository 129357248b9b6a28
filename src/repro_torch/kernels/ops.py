"""Device dispatch for the kernels.

A CUDA tensor goes to the hand-written CUDA kernel, whose wrapper
launches it or raises; a CPU tensor goes to the plain PyTorch version in
``ref``. There is no fallback from one to the other.
"""
from __future__ import annotations

from . import paged_attn, ref, topk_mask


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
