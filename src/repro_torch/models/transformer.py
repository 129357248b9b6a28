"""Decoder-only LM stacks: dense, MoE, RWKV6 and the Mamba/attention
hybrid.

The port of ``repro/models/transformer.py`` for what serving and
training run, the fused antithetic probe pair (``run_periods_paired``)
included; the encoder-decoder (Whisper) and image-token (LLaVA) stacks
are not ported. Layout: params = {embed, periods, final_norm, unembed};
``periods`` holds every block's weights stacked over a leading period dim
(one period is one repetition of ``cfg.pattern``). ``run_periods`` is a
Python loop over periods where the JAX package scans; it takes zero
periods too (a one-period stack's empty BP tail).
"""
from __future__ import annotations

import torch

from ..configs.base import ATTN, MAMBA, RWKV, ModelConfig
from ..core import zo
from .layers import attention, dense_init, init_attention, init_mlp, mlp, rms_norm
from .moe import init_moe, moe_ffn
from .ssm import (init_mamba_block, init_mamba_state, init_rwkv_block,
                  init_rwkv_state, mamba_block, rwkv_block)

CE_CHUNKS = 4            # sequence chunks for the cross-entropy epilogue


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_layers or cfg.num_image_tokens or cfg.rope_theta <= 0:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only stacks with RoPE; the "
            "encoder-decoder and image-token stacks are not ported")


def _ffn_is_moe(cfg: ModelConfig, pos_in_period: int) -> bool:
    return cfg.is_moe and pos_in_period % cfg.moe_every == cfg.moe_offset


def init_block(gen, cfg: ModelConfig, kind: str, pos: int, dtype, lead=()):
    """One pattern position's weights, stacked over ``lead``."""
    d, dev = cfg.d_model, gen.device
    lead = tuple(lead)
    if kind == RWKV:
        return {"rwkv": init_rwkv_block(gen, cfg, dtype, lead)}
    p = {}
    if kind == ATTN:
        p["ln_attn"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
        p["attn"] = init_attention(gen, cfg, dtype, lead=lead)
    else:                                                  # MAMBA
        p["mamba"] = init_mamba_block(gen, cfg, dtype, lead)
    p["ln_ffn"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
    if _ffn_is_moe(cfg, pos):
        p["moe"] = init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, lead=lead)
    return p


def init_lm(cfg: ModelConfig, *, seed: int, device, dtype=None):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (not the JAX package's stream: parity tests
    convert JAX parameters with ``repro_torch.convert``)."""
    _check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, Vp, n = cfg.d_model, cfg.padded_vocab, cfg.num_periods
    periods = {f"blk{i}": init_block(gen, cfg, kind, i, dtype, lead=(n,))
               for i, kind in enumerate(cfg.pattern)}
    return {
        "embed": dense_init(gen, (Vp, d), dtype, fan_in=Vp),
        "periods": periods,
        "final_norm": torch.ones(d, dtype=dtype, device=device),
        "unembed": dense_init(gen, (d, Vp), dtype, fan_in=d),
    }


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/tuple/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def num_periods(periods) -> int:
    """The leading (period) dim of a stacked period tree."""
    while isinstance(periods, dict):
        periods = next(iter(periods.values()))
    return periods.shape[0]


def apply_block(p, x, cfg: ModelConfig, kind: str, *, positions, mode: str,
                cache=None, cache_len=None, paged=None, full_kv=False):
    """One block of kind ``kind``. Returns (x, cache entry).

    mode "prefill": the entry is this block's new state: {"k", "v"}
    [B, S, KV, Dh] for attention (full length with ``full_kv``, which the
    paged pool needs, as it stores absolute positions and applies a
    sliding window as a mask; otherwise a window's ring, slot = position
    mod window, for the dense cache), {"conv", "ssm"} for Mamba,
    {"tm_shift", "cm_shift", "wkv"} for RWKV6. mode "decode": ``cache``
    is this block's entry (the paged pools with ``paged``, else the dense
    cache at ``cache_len``); it is written in place, recurrent state
    included, and returned. mode "train": the full causal sequence, no
    cache; the entry is None.
    """
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    state = cache if mode == "decode" else None
    if kind == RWKV:
        x, new = rwkv_block(p["rwkv"], x, cfg, state)
        return x, _entry(mode, cache, new)
    if kind == ATTN:
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        window = cfg.sliding_window
        if mode == "decode":
            y, _ = attention(p["attn"], h, cfg, positions, window=window,
                             cache=(cache["k"], cache["v"]),
                             cache_len=cache_len, paged=paged)
            new = None                           # written in place
        else:
            y, (k, v) = attention(p["attn"], h, cfg, positions,
                                  window=window)
            if window and k.shape[1] > window and not full_kv:
                p0 = k.shape[1] - window             # ring-align the cache
                k = torch.roll(k[:, -window:], p0 % window, dims=1)
                v = torch.roll(v[:, -window:], p0 % window, dims=1)
            new = {"k": k, "v": v}
        x = x + y
    else:                                                  # MAMBA
        x, new = mamba_block(p["mamba"], x, cfg, state)
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    y = moe_ffn(p["moe"], h, cfg) if "moe" in p else mlp(p["mlp"], h)
    return x + y, _entry(mode, cache, new)


def _entry(mode: str, cache, new):
    if mode == "train":
        return None
    if mode == "decode":
        for name, t in (new or {}).items():
            cache[name].copy_(t)
        return cache
    return new


def run_periods(periods, x, cfg: ModelConfig, *, positions, mode,
                caches=None, cache_len=None, paged=None, full_kv=False):
    """Run the stacked periods in order. caches: one entry (a dict) per
    pattern position, stacked like the params (leading dim = periods).
    Returns (x, caches): prefill stacks the new entries (an empty dict
    per position over zero periods); decode returns ``caches``, updated
    in place; train returns None."""
    entries = [[] for _ in cfg.pattern]
    for i in range(num_periods(periods)):
        for j, kind in enumerate(cfg.pattern):
            ci = None if caches is None \
                else {name: a[i] for name, a in caches[j].items()}
            x, e = apply_block(
                tree_map(lambda a: a[i], periods[f"blk{j}"]), x, cfg, kind,
                positions=positions, mode=mode, cache=ci,
                cache_len=cache_len, paged=paged, full_kv=full_kv)
            if mode == "prefill":
                entries[j].append(e)
    if mode == "decode":
        return x, caches
    if mode == "train":
        return x, None
    return x, tuple({name: torch.stack([e[name] for e in es])
                     for name in (es[0] if es else ())} for es in entries)


def run_periods_paired(periods, x_pair, cfg: ModelConfig, *, positions,
                       seed, eps: float, salts, sizes):
    """Fused antithetic forward (``repro/models/transformer.py::
    run_periods_paired``): advance the theta + eps z and theta - eps z
    streams through the period stack together, perturbing one period's
    slice at a time, so no perturbed copy of the whole stack exists.

    Exactness: each slice's noise is the stacked leaf's (``salts`` are the
    stacked leaves' path salts, ``sizes`` the slice sizes, and
    ``core/zo.py::perturb_slice`` draws over the flat offset p * size), so
    both streams are bitwise the unfused path's. Train mode, no gradient
    (the ZO head is never differentiated); each perturbed slice is freed
    before the next is made. seed: int32 [1] on the params' device.
    Returns (hp, hm)."""
    h = list(x_pair)
    with torch.no_grad():
        for i in range(num_periods(periods)):
            pparams = tree_map(lambda a: a[i], periods)
            for s, scale in enumerate((eps, -eps)):
                pert = zo.perturb_slice(pparams, salts, sizes, i, seed, scale)
                for j, kind in enumerate(cfg.pattern):
                    h[s], _ = apply_block(pert[f"blk{j}"], h[s], cfg, kind,
                                          positions=positions, mode="train")
                del pert
    return h[0], h[1]


def embed(params, tokens):
    return params["embed"][tokens.to(torch.int64)]


def head_logits(params, x, cfg: ModelConfig):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, params["unembed"])


def lm_loss(params, x, labels, mask, cfg: ModelConfig):
    """Cross-entropy over the padded vocab in ``CE_CHUNKS`` sequence
    chunks (f32 logits), masked mean over tokens. labels [B, S] in
    [0, padded_vocab); mask [B, S] f32. Returns an f32 scalar."""
    S = x.shape[1]
    n = CE_CHUNKS if S % CE_CHUNKS == 0 and S >= CE_CHUNKS else 1
    c = S // n
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    tot = cnt = 0.0
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        logits = torch.einsum("bsd,dv->bsv", h[:, sl],
                              params["unembed"]).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels[:, sl].to(torch.int64)[..., None])[..., 0]
        mc = mask[:, sl].float()
        tot = tot + ((logz - ll) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def _state_entry(cfg: ModelConfig, kind: str, B: int, dtype, device):
    make = init_mamba_state if kind == MAMBA else init_rwkv_state
    return make(cfg, B, dtype, device=device, lead=(cfg.num_periods,))


def make_caches(cfg: ModelConfig, B: int, seq_len: int, *, device,
                dtype=None):
    """Zero dense caches, one entry per pattern position, stacked
    [periods, B, ...]: attention {"k", "v"} [periods, B, T, KV, Dh] with
    T = seq_len capped at the sliding window, recurrent state per row."""
    _check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    T = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.num_periods, B, T, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
                 if kind == ATTN else _state_entry(cfg, kind, B, dtype, device)
                 for kind in cfg.pattern)


def make_paged_caches(cfg: ModelConfig, slots: int, num_pages: int,
                      page_size: int, *, device, dtype=None):
    """Paged serve caches, the structure of ``make_caches``: attention KV
    in a page pool {"k", "v"} [periods, num_pages, page_size, KV, Dh]
    shared by every sequence (page 0 is the null page); recurrent state
    (Mamba, RWKV6) is fixed-size, so it stays dense per decode slot,
    [periods, slots, ...]."""
    _check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.num_periods, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
                 if kind == ATTN
                 else _state_entry(cfg, kind, slots, dtype, device)
                 for kind in cfg.pattern)
