"""Transformer layers: RMS and per-head group norms, RoPE, GQA attention,
SwiGLU MLP.

The port of ``repro/models/layers.py`` for one device: the attention plan
is the single-device one (no KV-head duplication, no Q-head padding).
Attention covers what serving and training run: self-attention over the
whole sequence for prefill and train (causal; non-causal in Whisper's
encoder) and cross-attention over external keys and values (Whisper's
decoder over the encoder output), each through the flash kernel where no
gradient is needed and the JAX package's chunked eager attention where
autograd differentiates it; and the paged decode step, both through
``kernels.ops``; and the dense-cache decode step of the static-batch
baseline (``serve/engine.py::DenseServer``) in plain torch, as the JAX
package computes it outside any kernel. Parameter layouts are the JAX
package's: wq/wk/wv [d, heads, Dh], wo [H, Dh, d].
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops

Q_CHUNK = 4096          # query block size for chunked attention


# --------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, dtype, *, fan_in: int):
    """N(0, 1/fan_in) weights drawn in f32 on the generator's device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


# --------------------------------------------------------------------- #
# norms and RoPE
# --------------------------------------------------------------------- #
def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def group_norm_heads(x, scale, eps=1e-5):
    """Per-head group norm over the last dim; x: [..., H, Dh]."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def rope(x, positions, theta):
    """x: [B, S, H, Dh], positions: [B, S] int."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs                # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def init_attention(gen, cfg: ModelConfig, dtype, lead=()):
    """Attention weights, stacked over the leading dims ``lead``."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, H, Dh), dtype, fan_in=d),
        "wk": dense_init(gen, lead + (d, KV, Dh), dtype, fan_in=d),
        "wv": dense_init(gen, lead + (d, KV, Dh), dtype, fan_in=d),
        "wo": dense_init(gen, lead + (H, Dh, d), dtype, fan_in=H * Dh),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones(lead + (Dh,), dtype=dtype, device=gen.device)
    return p


def _attend_block(q, k, v, mask, scale):
    """q: [B,Sq,KVd,G,Dh], k/v: [B,T,KVd,Dh], mask: [B or 1, Sq, T].

    Scores and the weighted sum accumulate in f32; the weights are cast
    to v's dtype first, as the JAX package does."""
    scores = torch.einsum("bskgh,btkh->bksgt", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, :, None, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bksgt,btkh->bskgh", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention(p, x, cfg: ModelConfig, positions, *, causal=True, window=0,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_len: Optional[int] = None,
              paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Returns (y, (k, v)).

    Prefill, train and encode (``paged`` and ``cache`` None):
    self-attention over positions 0..S-1, causal unless ``causal`` is
    False (Whisper's encoder); (k, v) are this call's full-length [B, S,
    KV, Dh] keys and values. ``kv_override`` = (k, v) [B, T, KV', Dh]
    attends over those instead (cross-attention; ``causal`` False), with
    no k_norm and no RoPE on them, as in the JAX package. When none of
    q, k, v requires grad (the ZO head's probe forwards, serving) it runs
    the flash kernel, which has no backward; otherwise (the BP tail) the
    chunked eager attention that autograd differentiates.
    Decode (``paged`` = (page_table [B, P], seq_lens [B])): ``cache``
    holds one layer's (k_pool, v_pool) [N_pages, ps, KV, Dh]; the token's
    K/V is written into them in place by the paged step.
    Dense decode (``paged`` None, ``cache`` given): ``cache`` is (k, v)
    [B, T, KV, Dh] holding positions 0..cache_len - 1 (a ring of the
    window's T slots, slot = position mod T, when ``window`` is set); the
    token's K/V is written at ``cache_len`` in place, and the token
    attends over the cache (``DenseServer``).
    """
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0 and kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    KV = k.shape[2]

    if paged is not None:
        page_table, seq_lens = paged
        k_pool, v_pool = cache
        y = ops.paged_attention_step(
            q[:, 0].reshape(B, KV, H // KV, Dh), k[:, 0], v[:, 0], k_pool,
            v_pool, page_table, seq_lens, scale=scale, window=window)[:, None]
    elif cache is not None:
        y = _dense_decode(q.reshape(B, S, KV, H // KV, Dh), k, v, cache,
                          cache_len, window, scale)
    elif not (q.requires_grad or k.requires_grad or v.requires_grad):
        # positions is arange(S) in "prefill" and "train"
        # (core/api.py::_positions), so the kernel's top-left causal and
        # window masks are the model's; head h reads KV head h // G, the
        # grouping of q.reshape(B, S, KV, G, Dh)
        y = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, scale=scale).transpose(1, 2)
    else:
        y = _chunked_self_attention(q.reshape(B, S, KV, H // KV, Dh), k, v,
                                    positions, window, scale, causal=causal)
    out = torch.einsum("bshk,hkd->bsd", y.reshape(B, S, H, Dh), p["wo"])
    return out, (k, v)


def _dense_decode(q, k, v, cache, cache_len: int, window: int, scale):
    """The S = 1 step against a dense cache (``repro/models/layers.py``
    ``attention``'s cache branch and ``_ring_write``)."""
    k_cache, v_cache = cache
    B, S = q.shape[:2]
    T = k_cache.shape[1]
    pos_w = cache_len % T if window > 0 else cache_len
    k_cache[:, pos_w:pos_w + S] = k.to(k_cache.dtype)
    v_cache[:, pos_w:pos_w + S] = v.to(v_cache.dtype)
    t_pos = torch.arange(T, device=q.device)
    if window > 0:
        # slot t holds absolute position cache_len - ((pos_w - t) mod T)
        abs_pos = cache_len - torch.remainder(pos_w - t_pos, T)
        valid = (abs_pos >= 0) & (abs_pos <= cache_len) \
            & (abs_pos > cache_len - window)
    else:
        valid = t_pos <= cache_len
    mask = valid[None, None, :].expand(B, S, T)
    return _attend_block(q, k_cache, v_cache, mask, scale)


def _chunked_self_attention(q, k, v, positions, window, scale, *,
                            causal=True):
    """Block-causal (optionally banded) attention, query-chunked; with
    ``causal`` False every query sees all T keys (Whisper's encoder and
    cross-attention, T = k.shape[1] of its own).

    q: [B,S,KVd,G,Dh]; k,v: [B,T,KVd,Dh]. Chunks of cq = S // nq rows;
    the last chunk also takes the S - nq * cq remainder rows."""
    B, S = q.shape[:2]
    T = k.shape[1]
    nq = max(1, S // Q_CHUNK)
    cq = S // nq
    outs = []
    for i in range(nq):
        q_hi = S if i == nq - 1 else (i + 1) * cq
        q_i = q[:, i * cq:q_hi]
        if not causal:
            mask = torch.ones((1, q_hi - i * cq, T), dtype=torch.bool,
                              device=q.device)
            outs.append(_attend_block(q_i, k, v, mask, scale))
            continue
        q_pos = positions[:, i * cq:q_hi]
        kv_hi = min(q_hi, T)
        # lowest kv position any query in this chunk can see, chunk-aligned
        kv_lo = max(0, ((i * cq - window + 1) // cq) * cq) if window > 0 else 0
        t_pos = positions[:, kv_lo:kv_hi]
        mask = t_pos[:, None, :] <= q_pos[:, :, None]
        if window > 0:
            mask &= t_pos[:, None, :] > q_pos[:, :, None] - window
        outs.append(_attend_block(q_i, k[:, kv_lo:kv_hi], v[:, kv_lo:kv_hi],
                                  mask, scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# --------------------------------------------------------------------- #
# MLP (SwiGLU)
# --------------------------------------------------------------------- #
def init_mlp(gen, d, ff, dtype, lead=()):
    lead = tuple(lead)
    return {
        "w_gate": dense_init(gen, lead + (d, ff), dtype, fan_in=d),
        "w_up": dense_init(gen, lead + (d, ff), dtype, fan_in=d),
        "w_down": dense_init(gen, lead + (ff, d), dtype, fan_in=ff),
    }


def mlp(p, x):
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])
