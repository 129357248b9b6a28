"""LM stacks: decoder-only (dense, MoE, RWKV6 and the Mamba/attention
hybrid), Whisper's encoder-decoder, and LLaVA's image-token prefix.

The port of ``repro/models/transformer.py`` for what serving and
training run, the fused antithetic probe pair (``run_periods_paired``)
included. Layout: params = {embed, periods, final_norm, unembed [,
pos_embed, encoder]}; ``periods`` holds every block's weights stacked
over a leading period dim (one period is one repetition of
``cfg.pattern``). ``pos_embed`` [max_seq, d] holds the learned absolute
positions of a stack without RoPE (``rope_theta <= 0``), and ``encoder``
= {pos_embed [encoder_seq, d], periods, final_norm} Whisper's encoder,
whose decoder blocks carry cross-attention (``ln_cross``, ``cross``).
Image tokens arrive as embeddings [B, num_image_tokens, d] and go before
the text (``embed``). ``run_periods`` is a Python loop over periods
where the JAX package scans; it takes zero periods too (a one-period
stack's empty BP tail).

On a mesh (``run``, a ``sharding/collectives.py::MeshRun``; the
training forward of every stack: decoder-only, the MoE stacks, RWKV6,
the Mamba / attention hybrid with its MoE FFNs (Jamba), Whisper's
encoder-decoder and LLaVA's image-token prefix) each block gathers its
weights just before use and drops them after (``MeshRun.weights``: the
FSDP shards over `data`, and over `model` too under the ``fsdp``
strategy, but for the expert leaves' expert dim under the MoE ``ep``
plan), attention takes the rules' form (``layers.py::
attention_on_mesh``), RWKV6 and Mamba run on the rank's heads or d_inner
channels where `model` splits them (``ssm.py``), the MoE FFN takes its
plan's form (``moe.py::moe_ffn``: the dispatch all-to-all, the rank's
own experts, or d_ff split over `model`), the embedding and the loss are
vocab-parallel over `model` where it carries TP compute (a whole table
under ``fsdp``), and the loss is summed over every batch axis
(``lm_loss``). Whisper's encoder runs its blocks under their own specs
on the rank's rows of ``frames``, and its decoder blocks cross-attend in
the same form; the learned positions and LLaVA's image rows join the
embedding as on one device. The fused probe pair runs there too, and so
do prefill and decode: each block's cache entry is the rank's shard in
the JAX package's layout (``make_caches(..., run=)``), and the head's
logits are the rank's vocab columns (``head_logits(..., run=)``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ATTN, MAMBA, RWKV, ModelConfig
from ..core import zo
from .layers import (attention, attention_on_mesh, cache_kv,
                     cross_decode_on_mesh, cross_kv,
                     decode_attention_on_mesh, dense_init, init_attention,
                     init_mlp, mlp, rms_norm)
from .moe import init_moe, moe_ffn
from .ssm import (init_mamba_block, init_mamba_state, init_rwkv_block,
                  init_rwkv_state, mamba_block, rwkv_block)

CE_CHUNKS = 4            # sequence chunks for the cross-entropy epilogue


def _ffn_is_moe(cfg: ModelConfig, pos_in_period: int) -> bool:
    return cfg.is_moe and pos_in_period % cfg.moe_every == cfg.moe_offset


def init_block(gen, cfg: ModelConfig, kind: str, pos: int, dtype, lead=(),
               cross_attn: bool = False):
    """One pattern position's weights, stacked over ``lead``; an
    attention block of Whisper's decoder (``cross_attn``) also holds
    ``ln_cross`` and the cross-attention's ``cross``."""
    d, dev = cfg.d_model, gen.device
    lead = tuple(lead)
    if kind == RWKV:
        return {"rwkv": init_rwkv_block(gen, cfg, dtype, lead)}
    p = {}
    if kind == ATTN:
        p["ln_attn"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
        p["attn"] = init_attention(gen, cfg, dtype, lead=lead)
        if cross_attn:
            p["ln_cross"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
            p["cross"] = init_attention(gen, cfg, dtype, lead=lead)
    else:                                                  # MAMBA
        p["mamba"] = init_mamba_block(gen, cfg, dtype, lead)
    p["ln_ffn"] = torch.ones(lead + (d,), dtype=dtype, device=dev)
    if _ffn_is_moe(cfg, pos):
        p["moe"] = init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, lead=lead)
    return p


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config Whisper's encoder blocks run under: attention only, no
    MoE, no window, no RoPE (its positions are learned)."""
    return dataclasses.replace(cfg, block_pattern=(ATTN,), num_experts=0,
                               sliding_window=0, rope_theta=0.0)


def init_lm(cfg: ModelConfig, *, seed: int, device, dtype=None,
            max_seq: int = None):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (not the JAX package's stream: parity tests
    convert JAX parameters with ``repro_torch.convert``). A stack with
    learned positions (``rope_theta <= 0``) needs ``max_seq``, the rows
    of ``pos_embed`` (the JAX package's ``shape.seq_len``)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, Vp, n = cfg.d_model, cfg.padded_vocab, cfg.num_periods
    cross = cfg.encoder_layers > 0
    periods = {f"blk{i}": init_block(gen, cfg, kind, i, dtype, lead=(n,),
                                     cross_attn=cross)
               for i, kind in enumerate(cfg.pattern)}
    params = {
        "embed": dense_init(gen, (Vp, d), dtype, fan_in=Vp),
        "periods": periods,
        "final_norm": torch.ones(d, dtype=dtype, device=device),
        "unembed": dense_init(gen, (d, Vp), dtype, fan_in=d),
    }
    if cfg.rope_theta <= 0:                      # learned absolute positions
        if not max_seq:
            raise ValueError(f"{cfg.name} learns its positions: init needs "
                             "max_seq, the rows of pos_embed")
        params["pos_embed"] = dense_init(gen, (max_seq, d), dtype,
                                         fan_in=max_seq)
    if cross:
        S = cfg.encoder_seq
        params["encoder"] = {
            "pos_embed": dense_init(gen, (S, d), dtype, fan_in=S),
            "periods": {"blk0": init_block(gen, encoder_config(cfg), ATTN,
                                           0, dtype,
                                           lead=(cfg.encoder_layers,))},
            "final_norm": torch.ones(d, dtype=dtype, device=device),
        }
    return params


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor of a nested dict/tuple/list, and to
    the same-placed leaves of the same-shaped trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def num_periods(periods) -> int:
    """The leading (period) dim of a stacked period tree."""
    while isinstance(periods, dict):
        periods = next(iter(periods.values()))
    return periods.shape[0]


def _block_on_mesh(p, x, cfg: ModelConfig, kind: str, positions, run,
                   j: int, gathered: bool = False, mode: str = "train",
                   enc_out=None, cache=None, cache_len=None):
    """One block of kind ``kind`` on a mesh: its weights gathered
    (``MeshRun.weights``; ``gathered``: the caller did). RWKV6 runs
    ``ssm.py::rwkv_block`` and Mamba ``ssm.py::mamba_block`` on the
    rank's heads or d_inner channels where `model` splits them (their
    state, ``wkv``, ``ssm`` and ``conv``, split the same way; the token
    shifts by rows only); attention takes the rules' form; the MLP
    after an attention or Mamba block runs on the rank's d_ff slice
    where `model` carries TP compute, or the MoE FFN in its plan's form
    (``moe.py::moe_ffn``). ``mode`` "encode" is a block of Whisper's
    encoder (its own block specs, ``MeshRun.encoder_block_specs``):
    non-causal self-attention. A decoder block with ``ln_cross`` then
    cross-attends to ``enc_out`` (the rank's rows of the encoder output,
    the same on every `model` rank). "prefill": the entry is the rank's
    shard of the block's cache in the layout of ``sharding/params.py::
    cache_shardings`` (``layers.py::cache_kv``: its KV groups under the
    ``tp`` plan, its slots where the rules split them; Whisper's ck /
    cv alike). "decode": ``cache`` is the rank's shard of this block's
    entry, written in place (``layers.py::decode_attention_on_mesh``,
    ``cross_decode_on_mesh``). Returns (x, entry)."""
    encode = mode == "encode"
    specs = (run.encoder_block_specs if encode else run.block_specs)[
        f"blk{j}"]
    if not gathered:
        p = run.weights(p, specs)
    state = cache if mode == "decode" else None
    if kind == RWKV:
        x, new = rwkv_block(p["rwkv"], x, cfg, state, specs["rwkv"], run)
        return x, _entry(mode, cache, new)
    new = {}
    window = cfg.sliding_window
    if kind == MAMBA:
        x, new = mamba_block(p["mamba"], x, cfg, state, specs["mamba"], run)
        if mode not in ("prefill", "decode"):
            new = {}
    else:
        h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
        if mode == "decode":
            x = x + decode_attention_on_mesh(p["attn"], h, cfg, positions,
                                             specs["attn"], run,
                                             (cache["k"], cache["v"]),
                                             cache_len, window)
        else:
            y = attention_on_mesh(p["attn"], h, cfg, positions,
                                  specs["attn"], run, causal=not encode,
                                  window=window, keep_kv=mode == "prefill")
            if mode == "prefill":
                y, kv = y
                new = dict(zip(("k", "v"), cache_kv(*kv, run, window)))
                del kv
            x = x + y
            del y
    if "ln_cross" in p:
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        if mode == "decode":
            x = x + cross_decode_on_mesh(p["cross"], h, cfg, specs["cross"],
                                         run, cache["ck"], cache["cv"])
        else:
            y = attention_on_mesh(p["cross"], h, cfg, positions,
                                  specs["cross"], run, causal=False,
                                  kv_x=enc_out, keep_kv=mode == "prefill")
            if mode == "prefill":
                y, kv = y
                new.update(zip(("ck", "cv"), cache_kv(*kv, run)))
                del kv
            x = x + y
            del y
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    if "moe" in p:
        x = x + moe_ffn(p["moe"], h, cfg, specs["moe"], run)
    else:
        x = x + mlp(p["mlp"], h, specs["mlp"], run)
    return x, _entry(mode, cache, new)


def apply_block(p, x, cfg: ModelConfig, kind: str, *, positions, mode: str,
                cache=None, cache_len=None, paged=None, full_kv=False,
                enc_out=None, run=None, j: int = 0, gathered: bool = False):
    """One block of kind ``kind``. Returns (x, cache entry).

    mode "prefill": the entry is this block's new state: {"k", "v"}
    [B, S, KV, Dh] for attention (full length with ``full_kv``, which the
    paged pool needs, as it stores absolute positions and applies a
    sliding window as a mask; otherwise a window's ring, slot = position
    mod window, for the dense cache), plus {"ck", "cv"} [B, encoder_seq,
    KV, Dh], the cross-attention's keys and values of ``enc_out``, in
    Whisper's decoder; {"conv", "ssm"} for Mamba, {"tm_shift",
    "cm_shift", "wkv"} for RWKV6. mode "decode": ``cache`` is this
    block's entry (the paged pools with ``paged``, else the dense cache
    at ``cache_len``; ``ck`` / ``cv`` dense per row either way); it is
    written in place, recurrent state included, and returned. mode
    "train": the full causal sequence, no cache; the entry is None. mode
    "encode": as "train", but the self-attention is not causal
    (Whisper's encoder blocks). ``run`` (a mesh, every mode but the
    paged one): the block is pattern position ``j``, its leaves the
    rank's shards (or, with ``gathered``, already gathered for use), its
    cache entry the rank's shard (``_block_on_mesh``).
    """
    if mode not in ("prefill", "decode", "train", "encode"):
        raise ValueError(f"unknown mode {mode!r}")
    if run is not None:
        if paged is not None or full_kv:
            raise NotImplementedError("the paged caches run on one device")
        return _block_on_mesh(p, x, cfg, kind, positions, run, j, gathered,
                              mode, enc_out, cache, cache_len)
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
                                  causal=mode != "encode", window=window)
            if window and k.shape[1] > window and not full_kv:
                p0 = k.shape[1] - window             # ring-align the cache
                k = torch.roll(k[:, -window:], p0 % window, dims=1)
                v = torch.roll(v[:, -window:], p0 % window, dims=1)
            new = {"k": k, "v": v}
        x = x + y
        if "ln_cross" in p:                      # decoder cross-attention
            h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
            if mode == "decode":
                kv = (cache["ck"], cache["cv"])
            else:
                kv = cross_kv(p["cross"], enc_out)
                new.update(ck=kv[0], cv=kv[1])
            y, _ = attention(p["cross"], h, cfg, positions, causal=False,
                             kv_override=kv)
            x = x + y
    else:                                                  # MAMBA
        x, new = mamba_block(p["mamba"], x, cfg, state)
    h = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    y = moe_ffn(p["moe"], h, cfg) if "moe" in p else mlp(p["mlp"], h)
    return x + y, _entry(mode, cache, new)


def _entry(mode: str, cache, new):
    if mode in ("train", "encode"):
        return None
    if mode == "decode":
        for name, t in (new or {}).items():
            cache[name].copy_(t)
        return cache
    return new


def run_periods(periods, x, cfg: ModelConfig, *, positions, mode,
                caches=None, cache_len=None, paged=None, full_kv=False,
                enc_out=None, run=None):
    """Run the stacked periods in order. caches: one entry (a dict) per
    pattern position, stacked like the params (leading dim = periods).
    ``enc_out`` [B, encoder_seq, d] is what Whisper's decoder blocks
    cross-attend to (prefill and train; decode reads the cached ck / cv).
    Returns (x, caches): prefill stacks the new entries (an empty dict
    per position over zero periods); decode returns ``caches``, updated
    in place; train returns None. ``run``: the mesh (the caches the
    rank's shards)."""
    entries = [[] for _ in cfg.pattern]
    for i in range(num_periods(periods)):
        for j, kind in enumerate(cfg.pattern):
            ci = None if caches is None \
                else {name: a[i] for name, a in caches[j].items()}
            x, e = apply_block(
                tree_map(lambda a: a[i], periods[f"blk{j}"]), x, cfg, kind,
                positions=positions, mode=mode, cache=ci,
                cache_len=cache_len, paged=paged, full_kv=full_kv,
                enc_out=enc_out, run=run, j=j)
            if mode == "prefill":
                entries[j].append(e)
    if mode == "decode":
        return x, caches
    if mode in ("train", "encode"):
        return x, None
    return x, tuple({name: torch.stack([e[name] for e in es])
                     for name in (es[0] if es else ())} for es in entries)


def run_periods_paired(periods, x_pair, cfg: ModelConfig, *, positions,
                       seed, eps: float, salts, sizes,
                       enc_pair=(None, None), run=None):
    """Fused antithetic forward (``repro/models/transformer.py::
    run_periods_paired``): advance the theta + eps z and theta - eps z
    streams through the period stack together, perturbing one period's
    slice at a time, so no perturbed copy of the whole stack exists.
    ``enc_pair`` holds each stream's own encoder output (Whisper).

    Exactness: each slice's noise is the stacked leaf's (``salts`` are the
    stacked leaves' path salts, ``sizes`` the global slice sizes, and
    ``core/zo.py::perturb_slice`` draws over the flat offset p * size), so
    both streams are bitwise the unfused path's. Train mode, no gradient
    (the ZO head is never differentiated); each perturbed slice is freed
    before the next is made. seed: int32 [1] on the params' device.

    On a mesh (``run``; ``periods`` the rank's shards of the stacked
    ``periods_zo`` tree): where the model computes on whole weights
    (``MeshRun.whole_weights``: ``fsdp``, or a `model` axis of one),
    each period's slice is gathered once and both signs' copies are made
    from it locally (JAX's ``:246-251``), at the gathered slice's
    flat-index maps (``MeshRun.period_maps(..., gathered=True)``: the
    offset p * size of a whole leaf, an expert leaf's block of E / tp
    experts under the ``ep`` plan); the gathered slice is freed before
    the next period. Otherwise (``tp``, ``serve``) the rank's
    shard of the slice is perturbed at its flat-index map
    (``MeshRun.period_maps``: the shard's map, moved by p * size) and
    each stream's copy is gathered in its block.
    Returns (hp, hm)."""
    h = list(x_pair)
    whole = run is not None and run.whole_weights
    with torch.no_grad():
        for i in range(num_periods(periods)):
            pparams = tree_map(lambda a: a[i], periods)
            maps = None
            if whole:
                pparams = run.weights(pparams, run.block_specs)
            if run is not None:
                maps = run.period_maps("periods_zo", i, gathered=whole)
            for s, scale in enumerate((eps, -eps)):
                pert = zo.perturb_slice(pparams, salts, sizes, i, seed, scale,
                                        maps)
                for j, kind in enumerate(cfg.pattern):
                    h[s], _ = apply_block(pert[f"blk{j}"], h[s], cfg, kind,
                                          positions=positions, mode="train",
                                          enc_out=enc_pair[s], run=run, j=j,
                                          gathered=whole)
                del pert
            del pparams
    return h[0], h[1]


def embed(params, tokens, positions=None, img=None, run=None):
    """Token embeddings [B, S, d], after ``img`` [B, n_img, d] (LLaVA's
    image-token embeddings) when given, plus ``pos_embed[positions]``
    where the stack learns its positions (positions [B, n_img + S]).
    On a mesh (``run``; tokens and ``img`` the rank's rows) the table's
    FSDP shards are gathered and, where its vocab rows are sharded over
    `model`, each rank looks up the tokens in its rows (zeros elsewhere)
    and the rows are all-reduced over `model`: one nonzero term a row, so
    the lookup is exact; ``pos_embed`` is gathered by its spec
    (``MeshRun.weight``), in the same order as on one device."""
    if run is not None:
        from ..sharding.collectives import vocab_embed
        x = vocab_embed(params["embed"], tokens, run)
    else:
        x = params["embed"][tokens.to(torch.int64)]
    if img is not None:
        x = torch.cat([img.to(x.dtype), x], dim=1)
    if "pos_embed" in params:
        pos = params["pos_embed"] if run is None else run.weight(
            params["pos_embed"], run.specs["pos_embed"])
        x = x + pos[positions.to(torch.int64)]
    return x


def run_encoder(params, frames, cfg: ModelConfig, run=None):
    """Whisper's encoder over frames [B, encoder_seq, d] (the stubbed
    front end's frame embeddings): learned positions, then
    ``encoder_layers`` non-causal attention blocks, then the RMS norm
    (``repro/models/transformer.py::run_encoder``). On a mesh (``run``)
    ``frames`` are the rank's rows, ``pos_embed`` and ``final_norm`` are
    gathered by their specs and the blocks run in their mesh form (the
    ``seq`` plan splits the frames' query rows over `model`)."""
    enc = params["encoder"]
    pos_embed, norm = enc["pos_embed"], enc["final_norm"]
    if run is not None:
        specs = run.specs["encoder"]
        pos_embed = run.weight(pos_embed, specs["pos_embed"])
        norm = run.weight(norm, specs["final_norm"])
    B, S = frames.shape[:2]
    x = (frames + pos_embed[None, :S]).to(frames.dtype)
    positions = torch.arange(S, dtype=torch.int64,
                             device=frames.device).expand(B, S)
    x, _ = run_periods(enc["periods"], x, encoder_config(cfg),
                       positions=positions, mode="encode", run=run)
    return rms_norm(x, norm, cfg.norm_eps)


def head_logits(params, x, cfg: ModelConfig, run=None):
    """The logits [B, S, Vp] of the final norm and the unembedding. On a
    mesh (``run``) the rank's vocab columns where `model` carries TP
    compute (``MeshRun.weight``: the unembedding stays split there, a
    whole table under ``fsdp``); ``collectives.vocab_argmax`` takes the
    greedy token over them."""
    if run is None:
        norm, unembed = params["final_norm"], params["unembed"]
    else:
        norm = run.weight(params["final_norm"], run.specs["final_norm"])
        unembed = run.weight(params["unembed"], run.specs["unembed"])
    h = rms_norm(x, norm, cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, unembed)


def lm_loss(params, x, labels, mask, cfg: ModelConfig, run=None):
    """Cross-entropy over the padded vocab in ``CE_CHUNKS`` sequence
    chunks (f32 logits), masked mean over tokens. labels [B, S] in
    [0, padded_vocab); mask [B, S] f32. Returns an f32 scalar. On a mesh
    (``run``; the rank's rows) the unembedding's vocab columns stay
    sharded over `model` where it carries TP compute (a vocab-parallel
    log-sum-exp and label logit; under ``fsdp`` the gathered whole
    table and a local one), and the sums over tokens and over the mask
    are all-reduced over every batch axis (``MeshRun.batch_sum``), so
    every rank returns the global mean."""
    S = x.shape[1]
    n = CE_CHUNKS if S % CE_CHUNKS == 0 and S >= CE_CHUNKS else 1
    c = S // n
    if run is not None:
        from ..sharding.collectives import vocab_parallel_ce
        norm = run.weight(params["final_norm"], run.specs["final_norm"])
        unembed = run.weight(params["unembed"], run.specs["unembed"])
        h = rms_norm(x, norm, cfg.norm_eps)
    else:
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    tot = cnt = 0.0
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        lab = labels[:, sl].to(torch.int64)
        if run is not None:
            nll = vocab_parallel_ce(h[:, sl], unembed, lab, run)
        else:
            logits = torch.einsum("bsd,dv->bsv", h[:, sl],
                                  params["unembed"]).float()
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lab[..., None])[..., 0]
            nll = logz - ll
        mc = mask[:, sl].float()
        tot = tot + (nll * mc).sum()
        cnt = cnt + mc.sum()
    if run is not None:
        tot = run.batch_sum(tot)
        cnt = run.batch_sum(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def _state_entry(cfg: ModelConfig, kind: str, B: int, dtype, device):
    make = init_mamba_state if kind == MAMBA else init_rwkv_state
    return make(cfg, B, dtype, device=device, lead=(cfg.num_periods,))


def _cross_entry(cfg: ModelConfig, rows: int, dtype, device, kv_dup: int = 1):
    """Whisper's cross-attention keys and values, dense per row (a batch
    row, or a decode slot of the paged engine): {"ck", "cv"} [periods,
    rows, encoder_seq, KV * kv_dup, Dh]; empty for a stack without an
    encoder."""
    if not cfg.encoder_layers:
        return {}
    shape = (cfg.num_periods, rows, cfg.encoder_seq,
             cfg.num_kv_heads * kv_dup, cfg.head_dim)
    return {"ck": torch.zeros(shape, dtype=dtype, device=device),
            "cv": torch.zeros(shape, dtype=dtype, device=device)}


def make_caches(cfg: ModelConfig, B: int, seq_len: int, *, device,
                dtype=None, kv_dup: int = 1, run=None):
    """Zero dense caches, one entry per pattern position, stacked
    [periods, B, ...]: attention {"k", "v"} [periods, B, T, KV * kv_dup,
    Dh] with T = seq_len capped at the sliding window (and Whisper's
    {"ck", "cv"}), recurrent state per row. On a mesh (``run``) the
    rank's shards of the global caches in the JAX package's layout
    (``repro/models/transformer.py::make_caches``: KV * kv_dup heads
    under the rules' ``tp`` plan), split by ``sharding/params.py::
    cache_shardings`` (``MeshRun.cache_descs``), B the global batch."""
    dtype = dtype or getattr(torch, cfg.dtype)
    if run is not None:
        plan = run.rules.attn
        whole = make_caches(cfg, B, seq_len, device="meta", dtype=dtype,
                            kv_dup=plan.kv_dup if plan.kind == "tp" else 1)
        return tree_map(lambda t, d: torch.zeros(d.local_shape, dtype=t.dtype,
                                                 device=device),
                        whole, run.cache_descs(whole))
    T = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.num_periods, B, T, cfg.num_kv_heads * kv_dup, cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device),
                  **_cross_entry(cfg, B, dtype, device, kv_dup)}
                 if kind == ATTN else _state_entry(cfg, kind, B, dtype, device)
                 for kind in cfg.pattern)


def make_paged_caches(cfg: ModelConfig, slots: int, num_pages: int,
                      page_size: int, *, device, dtype=None):
    """Paged serve caches, the structure of ``make_caches``: attention KV
    in a page pool {"k", "v"} [periods, num_pages, page_size, KV, Dh]
    shared by every sequence (page 0 is the null page); recurrent state
    (Mamba, RWKV6) and Whisper's cross-attention keys and values are
    fixed-size, so they stay dense per decode slot, [periods, slots,
    ...]."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.num_periods, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device),
                  **_cross_entry(cfg, slots, dtype, device)}
                 if kind == ATTN
                 else _state_entry(cfg, kind, slots, dtype, device)
                 for kind in cfg.pattern)
