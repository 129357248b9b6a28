"""Decoder-only LM stack for dense, attention-only architectures.

The port of ``repro/models/transformer.py`` for what serving and
training run, the fused antithetic probe pair (``run_periods_paired``)
included.
Layout: params = {embed, periods, final_norm, unembed}; ``periods`` holds
every block's weights stacked over a leading period dim (one period is
one repetition of ``cfg.pattern``). ``run_periods`` is a Python loop over
periods where the JAX package scans.
"""
from __future__ import annotations

import torch

from ..configs.base import ATTN, ModelConfig
from ..core import zo
from .layers import attention, dense_init, init_attention, init_mlp, mlp, rms_norm

CE_CHUNKS = 4            # sequence chunks for the cross-entropy epilogue


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_moe or cfg.encoder_layers or cfg.num_image_tokens \
            or any(k != ATTN for k in cfg.pattern) or cfg.rope_theta <= 0:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention-only decoders with "
            "RoPE; MoE, SSM, encoder-decoder and VLM stacks are not ported")


def init_lm(cfg: ModelConfig, *, seed: int, device, dtype=None):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (not the JAX package's stream: parity tests
    convert JAX parameters with ``repro_torch.convert``)."""
    _check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, Vp, n = cfg.d_model, cfg.padded_vocab, cfg.num_periods
    periods = {}
    for i in range(len(cfg.pattern)):
        periods[f"blk{i}"] = {
            "ln_attn": torch.ones((n, d), dtype=dtype, device=device),
            "attn": init_attention(gen, cfg, dtype, lead=(n,)),
            "ln_ffn": torch.ones((n, d), dtype=dtype, device=device),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype, lead=(n,)),
        }
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


def apply_block(p, x, cfg: ModelConfig, *, positions, mode: str,
                cache=None, paged=None):
    """One attention block. Returns (x, cache entry).

    mode "prefill": the entry is this block's full-length {"k", "v"}
    [B, S, KV, Dh] (the paged pool stores absolute positions and applies
    a sliding window as a mask). mode "decode": ``cache`` is this layer's
    {"k", "v"} pool, written in place, and is returned as is. mode
    "train": the full causal sequence, no cache; the entry is None.
    """
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    if mode == "decode":
        y, _ = attention(p["attn"], h, cfg, positions,
                         window=cfg.sliding_window,
                         cache=(cache["k"], cache["v"]), paged=paged)
        entry = cache
    elif mode in ("prefill", "train"):
        y, (k, v) = attention(p["attn"], h, cfg, positions,
                              window=cfg.sliding_window)
        entry = {"k": k, "v": v} if mode == "prefill" else None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + y
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), entry


def run_periods(periods, x, cfg: ModelConfig, *, positions, mode,
                caches=None, paged=None):
    """Run the stacked periods in order. caches: one {"k","v"} dict per
    pattern position, stacked like the params (leading dim = periods).
    Returns (x, caches): prefill stacks the new full-length caches;
    decode returns ``caches``, updated in place; train returns None."""
    n = periods["blk0"]["ln_attn"].shape[0]
    entries = [[] for _ in cfg.pattern]
    for i in range(n):
        for j in range(len(cfg.pattern)):
            ci = None if caches is None \
                else {name: a[i] for name, a in caches[j].items()}
            x, e = apply_block(
                tree_map(lambda a: a[i], periods[f"blk{j}"]), x, cfg,
                positions=positions, mode=mode, cache=ci, paged=paged)
            if mode == "prefill":
                entries[j].append(e)
    if mode == "decode":
        return x, caches
    if mode == "train":
        return x, None
    return x, tuple({name: torch.stack([e[name] for e in es])
                     for name in es[0]} for es in entries)


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
    n = periods["blk0"]["ln_attn"].shape[0]
    with torch.no_grad():
        for i in range(n):
            pparams = tree_map(lambda a: a[i], periods)
            for s, scale in enumerate((eps, -eps)):
                pert = zo.perturb_slice(pparams, salts, sizes, i, seed, scale)
                for j in range(len(cfg.pattern)):
                    h[s], _ = apply_block(pert[f"blk{j}"], h[s], cfg,
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


def make_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int, *,
                      device, dtype=None):
    """Zero paged KV pools, one {"k", "v"} per pattern position, each
    [periods, num_pages, page_size, KV, Dh] (page 0 is the null page)."""
    _check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.num_periods, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
                 for _ in cfg.pattern)
