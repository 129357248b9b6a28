"""Transformer layers: RMS and per-head group norms, RoPE, GQA attention,
SwiGLU MLP.

The port of ``repro/models/layers.py``. On one device the attention plan
is the single-device one (no KV-head duplication, no Q-head padding); on
a mesh (``run``, a ``sharding/collectives.py::MeshRun``) the training
forward runs the rules' ``tp`` plan on the rank's heads
(``_attention_tp``: KV heads duplicated to the TP degree, Q heads padded,
as ``repro/models/layers.py:153-186``) and the SwiGLU MLP on the rank's
d_ff slice, each closing with an all-reduce over `model`.
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

On a mesh the attention form follows the rules (``attention_on_mesh``):
the ``tp`` plan on the rank's heads, the ``seq`` plan on the rank's
query rows (``_attention_seq``: weights whole over `model`, the flash
kernel at the rows' query offset), and plain attention on gathered
weights where no axis carries TP compute (the ``fsdp`` strategy). A
prefill on a mesh keeps its keys and values in the cache's layout
(``cache_kv``); a decode step writes and attends the rank's shard of the
cache (``decode_attention_on_mesh``, ``cross_decode_on_mesh``), its
partials combined across ranks where the rules split the cache's slots.
"""
from __future__ import annotations

import contextlib
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
_DRAW_HOOKS = []


@contextlib.contextmanager
def draw_hook(fn):
    """Inside, every ``dense_init`` draw returns ``fn(weight)`` (the
    sharded init keeps a rank's slice of each leaf as it is drawn)."""
    _DRAW_HOOKS.append(fn)
    try:
        yield
    finally:
        _DRAW_HOOKS.pop()


def dense_init(gen: torch.Generator, shape, dtype, *, fan_in: int):
    """N(0, 1/fan_in) weights drawn in f32 on the generator's device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    w = (w * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)
    return _DRAW_HOOKS[-1](w) if _DRAW_HOOKS else w


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


def cross_kv(p, enc_out):
    """The cross-attention's keys and values [B, encoder_seq, KV, Dh] of
    the encoder output."""
    if enc_out is None:
        raise ValueError("a cross-attention block needs the encoder output")
    return (torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]),
            torch.einsum("bsd,dhk->bshk", enc_out, p["wv"]))


def _model_sharded(spec) -> bool:
    return spec is not None and any(
        "model" in (ax if isinstance(ax, tuple) else (ax,)) for ax in spec)


def _rank_part(w, spec, dim, idx, run):
    """The rank's part (indices ``idx`` along ``dim``) of a weight whose
    ``dim`` is replicated over `model` (its gradient summed there), or
    the weight itself where ``spec`` shards it over `model`."""
    if _model_sharded(spec):
        return w
    from ..sharding.collectives import copy_to
    w = copy_to(w, run.model_group)
    return w.index_select(dim, torch.as_tensor(idx, device=w.device))


def attention_on_mesh(p, x, cfg: ModelConfig, positions, specs, run, *,
                      causal: bool = True, window: int = 0, kv_x=None,
                      keep_kv: bool = False):
    """Attention over the whole sequence on a mesh (``run``: a training
    forward, Whisper's encoder, or a prefill), in the form the rules
    give: the ``seq`` plan (``_attention_seq``), plain attention where
    there is no TP compute (``MeshRun.whole_weights``: weights already
    gathered whole, x the rank's rows), else the ``tp`` plan
    (``_attention_tp``). ``kv_x`` [B, T, d] (Whisper's encoder output,
    the rank's rows; ``causal`` False): cross-attention, K and V from
    ``kv_x`` with no k_norm and no RoPE, as on one device. Returns y
    [B, S, d]; with ``keep_kv`` (a prefill), (y, (k, v)): every
    position's keys and values [B, T, heads, Dh] of the rank's heads
    (its KVd / tp groups under the ``tp`` plan; every head otherwise),
    for ``cache_kv`` to lay out."""
    if run.rules.attn.kind == "seq":
        out = _attention_seq(p, x, cfg, positions, run, causal=causal,
                             window=window, kv_x=kv_x, keep_kv=keep_kv)
    elif run.whole_weights:
        kv = None if kv_x is None else cross_kv(p, kv_x)
        out = attention(p, x, cfg, positions, causal=causal, window=window,
                        kv_override=kv)
    else:
        out = _attention_tp(p, x, cfg, positions, specs, run, causal=causal,
                            window=window, kv_x=kv_x)
    return out if keep_kv else out[0]


def _tp_qkv(p, x, cfg: ModelConfig, positions, specs, run, kv_x=None):
    """Q, K and V of the rank's heads under the rules' ``tp`` plan: q
    [B, S, Hp / tp, Dh] (its padded Q heads [r Hp/tp, (r+1) Hp/tp), Hp
    = H + q_pad, zeros past H), k and v [B, T, KVd / tp, Dh] (its KV
    groups [r KVd/tp, (r+1) KVd/tp) of KVd = KV * kv_dup, group j
    reading KV head j // kv_dup; from ``kv_x`` for cross-attention, with
    no k_norm and no RoPE), and the rank's real Q heads. Weights
    replicated over `model` (a head count the mesh does not divide) are
    indexed to those heads (``_rank_part``); x and ``kv_x`` are
    ``copy_to`` `model`, so their gradients, each rank's share from its
    heads, are summed there."""
    from ..sharding.collectives import copy_to
    plan = run.rules.attn
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp, r = run.tp, run.model_rank
    dup = plan.kv_dup
    Hp, KVd = H + plan.q_pad, KV * dup
    hq, kvl = Hp // tp, KVd // tp
    h0, j0 = r * hq, r * kvl
    real = list(range(h0, min(h0 + hq, H)))
    kv_heads = [j // dup for j in range(j0, j0 + kvl)]
    xm = copy_to(x, run.model_group)
    src = xm if kv_x is None else copy_to(kv_x, run.model_group)
    wq = _rank_part(p["wq"], specs["wq"], 1, real, run)
    wk = _rank_part(p["wk"], specs["wk"], 1, kv_heads, run)
    wv = _rank_part(p["wv"], specs["wv"], 1, kv_heads, run)
    q = torch.einsum("bsd,dhk->bshk", xm, wq)
    k = torch.einsum("bsd,dhk->bshk", src, wk)
    v = torch.einsum("bsd,dhk->bshk", src, wv)
    if cfg.qk_norm:
        q = rms_norm(q, copy_to(p["q_norm"], run.model_group), cfg.norm_eps)
        if kv_x is None:
            k = rms_norm(k, copy_to(p["k_norm"], run.model_group),
                         cfg.norm_eps)
    if cfg.rope_theta > 0 and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if len(real) < hq:                           # padded Q heads
        q = torch.cat([q, q.new_zeros(B, S, hq - len(real), Dh)], dim=2)
    return q, k, v, real


def _attention_tp(p, x, cfg: ModelConfig, positions, specs, run, *,
                  causal: bool, window: int, kv_x=None):
    """Attention over the whole sequence on the rank's heads under the
    rules' ``tp`` plan (``_tp_qkv``; cross-attention's K and V of the
    rank's KV groups repeated kv_dup times, as the JAX package's
    ``_cross_kv`` repeats them). The output projection's partial sum is
    all-reduced over `model` (``_row_parallel``). Returns (y, (k, v))."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q, k, v, real = _tp_qkv(p, x, cfg, positions, specs, run, kv_x)
    hq, kvl = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    if not (q.requires_grad or k.requires_grad or v.requires_grad):
        y = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, scale=scale).transpose(1, 2)
    else:
        y = _chunked_self_attention(q.reshape(B, S, kvl, hq // kvl, Dh), k,
                                    v, positions, window, scale,
                                    causal=causal)
    y = y.reshape(B, S, hq, Dh)[:, :, :len(real)]
    wo = _rank_part(p["wo"], specs["wo"], 0, real, run)
    return _row_parallel("bshk,hkd->bsd", y, wo, run), (k, v)


def seq_rows(S: int, tp: int, r: int) -> Tuple[int, int]:
    """The query rows [lo, hi) of `model` rank ``r`` of ``tp`` under the
    ``seq`` plan: blocks of ceil(S / tp), the last ones shorter or empty
    (as GSPMD pads a dim the mesh does not divide)."""
    c = -(-S // tp)
    return min(r * c, S), min((r + 1) * c, S)


def _attention_seq(p, x, cfg: ModelConfig, positions, run, *, causal: bool,
                   window: int, kv_x=None, keep_kv: bool = False):
    """Self-attention of a training forward under the rules' ``seq``
    plan (``repro/models/layers.py``'s constraint of q's sequence dim
    over `model`): the Q/K/V/O weights are whole on every `model` rank;
    rank r takes the query rows [lo, hi) of ``seq_rows``, computes K and
    V for the positions they can see (0 .. hi - 1; all S where not
    causal) from the replicated input, and attends its rows through the
    flash kernel at ``q_offset = lo`` (forwards without a gradient) or
    the chunked attention at the rows' positions (the BP tail). A rank
    with no rows launches nothing. The output projection runs on the
    rank's rows, then the rows are gathered along the sequence over
    `model` (``seq_gather``: its backward is the rank's own rows of the
    gradient, what follows being replicated over `model`); the input and
    the weights are ``copy_to`` `model`, so their gradients, each rank's
    share from its rows, are summed there. Cross-attention (``kv_x``,
    the encoder output, the same on every `model` rank): the rank's rows
    against every encoder position, K and V from all of ``kv_x``, which
    is ``copy_to`` `model` too. Returns (y, (k, v)). With ``keep_kv``
    (a prefill) K and V are computed for every position from the
    replicated input, so each rank holds the keys and values of the
    cache slots it keeps, a window's ring slots included, whichever
    rank's rows their positions are; flash still reads keys 0 .. hi - 1
    only."""
    from ..sharding.collectives import copy_to, seq_gather
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = run.model_group
    lo, hi = seq_rows(S, run.tp, run.model_rank)
    scale = 1.0 / math.sqrt(Dh)
    xm = copy_to(x, g)
    w = {name: copy_to(t, g) for name, t in p.items()}
    src = xm[:, :hi if causal and not keep_kv else S] if kv_x is None \
        else copy_to(kv_x, g)
    q = torch.einsum("bsd,dhk->bshk", xm[:, lo:hi], w["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, w["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, w["wv"])
    T = k.shape[1]
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        if kv_x is None:
            k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0 and kv_x is None:
        q = rope(q, positions[:, lo:hi], cfg.rope_theta)
        k = rope(k, positions[:, :T], cfg.rope_theta)
    kept = k, v
    if keep_kv and causal and kv_x is None:
        k, v = k[:, :hi], v[:, :hi]
    n = hi - lo
    if not (q.requires_grad or k.requires_grad or v.requires_grad):
        y = q.new_zeros(q.shape) if n == 0 else ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale,
            q_offset=lo if causal else 0).transpose(1, 2)
    else:
        y = _chunked_self_attention(q.reshape(B, n, KV, H // KV, Dh), k, v,
                                    positions, window, scale, causal=causal,
                                    q_offset=lo)
    out = torch.einsum("bshk,hkd->bsd", y.reshape(B, n, H, Dh), w["wo"])
    return seq_gather(out, g, 1, lo, S), kept


def cache_kv(k, v, run, window: int = 0):
    """The rank's cache entries of a prefill's keys and values [B, S,
    heads, Dh] (every position; ``attention_on_mesh(keep_kv=True)``), in
    the layout of ``MeshRun.kv_layout``: a window's ring first, slot =
    position mod window, as on one device, then the rank's block of the
    slots where the rules split them."""
    if window and k.shape[1] > window:
        p0 = k.shape[1] - window
        k = torch.roll(k[:, -window:], p0 % window, dims=1)
        v = torch.roll(v[:, -window:], p0 % window, dims=1)
    axes, t0, n = run.kv_layout(k.shape[1])
    if axes:
        k, v = k[:, t0:t0 + n], v[:, t0:t0 + n]
    return k.contiguous(), v.contiguous()


def _decode_qkv(p, x, cfg: ModelConfig, positions, specs, run):
    """(q [B, 1, heads, Dh], k, v [B, 1, kv heads, Dh], the rank's real Q
    heads or None) of a decode token: the rank's heads under the
    ``tp`` plan with TP compute (``_tp_qkv``), every head otherwise (the
    ``seq`` plan's whole weights, or ``fsdp``'s gathered ones)."""
    if run.rules.attn.kind == "tp" and not run.whole_weights:
        return _tp_qkv(p, x, cfg, positions, specs, run)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v, None


def _decode_out(y, p, specs, run, real):
    """The output projection of a decode's heads y [B, 1, heads, Dh]:
    row-parallel over `model` on the rank's real Q heads (``tp`` plan),
    the whole ``wo`` otherwise."""
    B, S = y.shape[:2]
    if real is None:
        return torch.einsum("bshk,hkd->bsd", y, p["wo"])
    y = y[:, :, :len(real)]
    wo = _rank_part(p["wo"], specs["wo"], 0, real, run)
    return _row_parallel("bshk,hkd->bsd", y, wo, run)


def _attend_partial(q, k, v, mask, scale):
    """A rank's share of a softmax attention over its keys: q [B, Sq, KV,
    G, Dh], k / v [B, T, KV, Dh], mask [B or 1, Sq, T]. Returns (o
    [B, Sq, KV, G, Dh] f32, unnormalised: sum_t exp(s_t - m) v_t; m and
    l [B, Sq, KV, G] f32, the row max (-1e30 for a row that sees none of
    the keys) and the row sum of exp(s_t - m)), for
    ``sharding/collectives.py::attend_combine``."""
    s = torch.einsum("bskgh,btkh->bskgt", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[:, :, None, None, :], -1e30)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bskgt,btkh->bskgh", e, v.float())
    return o, m, e.sum(dim=-1)


def decode_attention_on_mesh(p, x, cfg: ModelConfig, positions, specs, run,
                             cache, cache_len: int, window: int = 0):
    """The S = 1 self-attention step against the rank's dense cache
    shard (k, v) [B, T_loc, heads, Dh], laid out by
    ``MeshRun.kv_layout`` of the decode's ``MeshRun.decode_slots``, the
    cache written in place. The token's K / V is written by the rank
    that holds its slot (``cache_len``, or ``cache_len % T`` in a
    window's ring; a ring slot's position is read from the slot, so the
    ring splits like any cache). Where the slots are not split, the
    one-device form, ``_dense_decode``, on the rank's heads; where they
    are (the ``seq`` plan at decode: over `model`; ``cache_seq_axes``,
    a batch below the batch axes' size: over `data`, or `pod` and
    `data`), each rank attends over its own slots with their validity
    mask (``_attend_partial``) and the partials are combined across the
    split (``collectives.attend_combine``). Then the output projection:
    row-parallel on the rank's heads under the ``tp`` plan, whole
    otherwise. Returns y [B, 1, d]."""
    from ..sharding.collectives import attend_combine
    B, S, _ = x.shape
    Dh = cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)
    q, k, v, real = _decode_qkv(p, x, cfg, positions, specs, run)
    k_cache, v_cache = cache
    T = run.decode_slots()
    axes, t0, n = run.kv_layout(T)
    kvl = k_cache.shape[2]
    if k_cache.shape[1] != n or k.shape[2] != kvl:
        raise ValueError(f"cache shard {tuple(k_cache.shape)}: the rules "
                         f"lay out {n} slots and {k.shape[2]} heads a rank")
    q = q.reshape(B, S, kvl, q.shape[2] // kvl, Dh)
    if not axes:
        y = _dense_decode(q, k, v, cache, cache_len, window, scale)
        return _decode_out(y.reshape(B, S, -1, Dh), p, specs, run, real)
    pos_w = cache_len % T if window > 0 else cache_len
    if t0 <= pos_w < t0 + n:
        k_cache[:, pos_w - t0:pos_w - t0 + S] = k.to(k_cache.dtype)
        v_cache[:, pos_w - t0:pos_w - t0 + S] = v.to(v_cache.dtype)
    t_pos = torch.arange(t0, t0 + n, device=q.device)
    if window > 0:
        abs_pos = cache_len - torch.remainder(pos_w - t_pos, T)
        valid = (abs_pos >= 0) & (abs_pos <= cache_len) \
            & (abs_pos > cache_len - window)
    else:
        valid = t_pos <= cache_len
    o, m, l = _attend_partial(q, k_cache, v_cache,
                              valid[None, None, :].expand(B, S, n), scale)
    y = attend_combine(o, m, l, [run.groups[a] for a in axes])
    return _decode_out(y.to(v_cache.dtype).reshape(B, S, -1, Dh), p, specs,
                       run, real)


def cross_decode_on_mesh(p, x, cfg: ModelConfig, specs, run, ck, cv):
    """Whisper's decoder cross-attention at a decode step on a mesh,
    against the rank's shard of the cached ck / cv [B, T_loc, heads, Dh]
    (``MeshRun.kv_layout`` of the encoder's length): the rank's heads
    under the ``tp`` plan, every head otherwise, through the flash
    kernel as on one device (non-causal; no RoPE, no k_norm). Where the
    encoder positions are split (the length divides the axes), flash
    returns each row's log-sum-exp too, and the normalised partials are
    combined across the split (``collectives.attend_combine`` with m =
    lse, l = 1). Returns y [B, 1, d]."""
    from ..sharding.collectives import attend_combine
    B, S, _ = x.shape
    Dh = cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)
    if run.rules.attn.kind == "tp" and not run.whole_weights:
        q, _, _, real = _tp_qkv(p, x, cfg, None, specs, run,
                                kv_x=x[:, :0])
    else:
        real = None
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    axes, _, n = run.kv_layout(cfg.encoder_seq)
    if ck.shape[1] != n:
        raise ValueError(f"ck shard {tuple(ck.shape)}: the rules lay out "
                         f"{n} encoder positions a rank")
    qt, kt, vt = q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
    if not axes:
        y = ops.flash_attention(qt, kt, vt, causal=False, scale=scale)
    else:
        o, lse = ops.flash_attention(qt, kt, vt, causal=False, scale=scale,
                                     return_lse=True)
        y = attend_combine(o.float().transpose(1, 2),
                           lse.transpose(1, 2),
                           torch.ones_like(lse.transpose(1, 2)),
                           [run.groups[a] for a in axes]
                           ).to(q.dtype).transpose(1, 2)
    return _decode_out(y.transpose(1, 2), p, specs, run, real)


def _row_parallel(eq: str, x, w, run):
    """A product whose contraction is split over `model`: each rank's
    partial sum in f32, all-reduced, rounded once to x's dtype (as one
    device rounds the whole sum once). On one `model` rank, the plain
    product."""
    from ..sharding.collectives import reduce_to
    if run.whole_weights:
        return torch.einsum(eq, x, w)
    out = torch.einsum(eq, x.float(), w.float())
    return reduce_to(out, run.model_group).to(x.dtype)


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
                            causal=True, q_offset: int = 0):
    """Block-causal (optionally banded) attention, query-chunked; with
    ``causal`` False every query sees all T keys (Whisper's encoder and
    cross-attention, T = k.shape[1] of its own).

    q: [B,S,KVd,G,Dh]; k,v: [B,T,KVd,Dh]; query row i at
    ``positions[:, q_offset + i]`` and key j at ``positions[:, j]`` (a
    rank's rows of the ``seq`` plan start at its offset). Chunks of cq =
    S // nq rows; the last chunk also takes the S - nq * cq remainder
    rows. No rows (S = 0): an empty result, still a function of k and v
    for autograd."""
    B, S = q.shape[:2]
    T = k.shape[1]
    if S == 0:
        return _attend_block(q, k, v, torch.zeros((1, 0, T), dtype=torch.bool,
                                                  device=q.device), scale)
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
        q_lo, q_hi = q_offset + i * cq, q_offset + q_hi
        q_pos = positions[:, q_lo:q_hi]
        kv_hi = min(q_hi, T)
        # lowest kv position any query in this chunk can see, chunk-aligned
        kv_lo = max(0, ((q_lo - window + 1) // cq) * cq) if window > 0 else 0
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


def mlp(p, x, specs=None, run=None):
    """SwiGLU. On a mesh (``run``) with d_ff sharded over `model` (its
    ``specs``), each rank computes its d_ff slice and the down
    projection's partial sum is all-reduced over `model`
    (``_row_parallel``)."""
    sharded = run is not None and not run.whole_weights \
        and _model_sharded(specs["w_gate"])
    if sharded:
        from ..sharding.collectives import copy_to
        x = copy_to(x, run.model_group)
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["w_up"])
    if sharded:
        return _row_parallel("bsf,fd->bsd", h, p["w_down"], run)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])
