"""Model API: init, the train step, prefill and the decode steps.

The port of ``repro/core/api.py``. Parameters keep the JAX package's
ElasticZO split: ``periods_zo`` (the zeroth-order head) and
``periods_bp`` (the back-propagated tail of ``tail_periods`` periods;
empty for a one-period stack). Serving runs both in order, for every
decoder family the port has (dense, MoE, RWKV6, the Mamba hybrid);
training perturbs the head and differentiates the tail
(``core/elastic.py``), for dense attention-only stacks so far.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..configs.base import ATTN, LaneConfig, ModelConfig
from ..models.transformer import (embed, head_logits, init_lm, lm_loss,
                                  num_periods, run_periods,
                                  run_periods_paired, tree_map)
from . import elastic, zo


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; no silent
    fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def f32_products():
    """Full-f32 products inside: TF32 off for cuBLAS matmuls and cuDNN
    convolutions (PyTorch leaves cuDNN's on by default), the flags
    restored on exit. The JAX reference computes LeNet-5 and PointNet in
    f32, so every benchmark entry point that trains them runs inside
    this. It only sets flags, so it costs nothing on the CPU."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside: every op that has a
    nondeterministic (atomic) path on the card takes its deterministic
    one, and an op that has none raises. cuBLAS products are
    deterministic only with a fixed workspace configuration, which
    cuBLAS reads once, at its first product: the process must set
    ``CUBLAS_WORKSPACE_CONFIG`` (e.g. ``:4096:8``) before it, as the fleet
    launcher and ``chip_smoke.py`` do, and a product on the card raises
    here when it is unset. Uninitialised outputs are not filled. The
    previous settings are restored on exit."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def tail_periods(cfg: ModelConfig, lane: LaneConfig) -> int:
    """BP-tail size in periods (>=1, < num_periods)."""
    plen = len(cfg.pattern)
    k = max(1, -(-lane.bp_tail_layers // plen))          # ceil
    return min(k, cfg.num_periods - 1)


def split_caches(caches, cfg: ModelConfig, lane: LaneConfig):
    """{"zo": first periods, "bp": tail periods}; views, not copies."""
    pz = cfg.num_periods - tail_periods(cfg, lane)
    return {"zo": tree_map(lambda a: a[:pz], caches),
            "bp": tree_map(lambda a: a[pz:], caches)}


def init(cfg: ModelConfig, lane: Optional[LaneConfig] = None, *,
         seed: int = 0, device, dtype=None):
    """Random parameters with the periods split into zo and bp. Each half
    is a leading-dim slice of one stacked tensor, so it is contiguous."""
    params = init_lm(cfg, seed=seed, device=device, dtype=dtype)
    split = split_caches(params.pop("periods"), cfg, lane or LaneConfig())
    params["periods_zo"], params["periods_bp"] = split["zo"], split["bp"]
    return params


def _backbone(params, cfg: ModelConfig, tokens, positions, mode, *,
              caches=None, **kw):
    x = embed(params, tokens)
    x, cz = run_periods(params["periods_zo"], x, cfg, positions=positions,
                        mode=mode, **kw,
                        caches=None if caches is None else caches["zo"])
    x, cb = run_periods(params["periods_bp"], x, cfg, positions=positions,
                        mode=mode, **kw,
                        caches=None if caches is None else caches["bp"])
    return x, {"zo": cz, "bp": cb}


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int64, device=tokens.device).expand(B, S)


# ---------------------------------------------------------------------- #
# train
# ---------------------------------------------------------------------- #
def _check_trainable(cfg: ModelConfig) -> None:
    if cfg.is_moe or any(k != ATTN for k in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: the port trains dense attention-only stacks; "
            "training the MoE, SSM and hybrid families is the next slice "
            "of the port (serving them is ported)")


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy of batch {"tokens", "labels", "mask"}
    (each [B, S]). The ZO head is never differentiated: its leaves do not
    require grad, so autograd records nothing before ``periods_bp`` (the
    port's form of the JAX package's ``stop_gradient`` cut)."""
    tokens = batch["tokens"]
    x, _ = _backbone(params, cfg, tokens, _positions(tokens), "train")
    return lm_loss(params, x, batch["labels"], batch["mask"], cfg)


def paired_loss(bp_part, zo_part, cfg: ModelConfig, lane: LaneConfig, batch,
                seed):
    """(l+, l-) of one antithetic probe pair, the two ZO-head streams
    advanced together (``repro/core/api.py`` ``paired_loss``): ``embed``
    perturbed whole, the ``periods_zo`` stack one period's slice at a time
    (``run_periods_paired``), then the BP tail and ``lm_loss`` for each
    stream. Bitwise the unfused path's two losses, with no perturbed copy
    of the head. seed: int32 [1] on the params' device."""
    _check_trainable(cfg)
    tokens = batch["tokens"]
    positions = _positions(tokens)
    rest = {k: v for k, v in zo_part.items() if k != "periods_zo"}
    with torch.no_grad():
        xp = embed(zo.perturb(rest, seed, lane.zo_eps), tokens)
        xm = embed(zo.perturb(rest, seed, -lane.zo_eps), tokens)
    periods = zo_part["periods_zo"]
    n = num_periods(periods)
    salts = zo.map_with_path(
        lambda p, _: zo.path_salt(p, "['periods_zo']"), periods)
    sizes = zo.map_with_path(lambda p, a: a.numel() // n, periods)
    xp, xm = run_periods_paired(periods, (xp, xm), cfg, positions=positions,
                                seed=seed, eps=lane.zo_eps, salts=salts,
                                sizes=sizes)
    losses = []
    for x in (xp, xm):
        x, _ = run_periods(bp_part["periods_bp"], x, cfg, positions=positions,
                           mode="train")
        losses.append(lm_loss(bp_part, x, batch["labels"], batch["mask"],
                              cfg))
    return losses[0], losses[1]


def make_train_step(cfg: ModelConfig, lane: LaneConfig):
    """The ElasticZO step of ``lane`` over ``loss_fn``:
    (state, batch, probe_mask) -> (state, metrics). With
    ``lane.fused_probes`` an elastic_zo step takes each probe pair through
    ``paired_loss``."""
    _check_trainable(cfg)
    paired = None
    if lane.fused_probes and lane.lane == "elastic_zo":
        paired = lambda bp, zo_part, batch, seed: paired_loss(  # noqa: E731
            bp, zo_part, cfg, lane, batch, seed)
    return elastic.make_elastic_step(lambda p, b: loss_fn(p, cfg, b), lane,
                                     paired_loss_fn=paired)


# ---------------------------------------------------------------------- #
# serve
# ---------------------------------------------------------------------- #
def prefill_logits(params, cfg: ModelConfig, tokens, last_pos):
    """Prefill of tokens [B, S]. Returns (logits [B, Vp] f32 at each row's
    ``last_pos`` (right-padded prompts are allowed for attention-only
    stacks; recurrent state absorbs every position), the new caches
    {"zo", "bp"} for paged admission: full-length attention KV [periods,
    B, S, KV, Dh] and each row's recurrent state after position S - 1)."""
    B = tokens.shape[0]
    x, caches = _backbone(params, cfg, tokens, _positions(tokens), "prefill",
                          full_kv=True)
    xl = x[torch.arange(B, device=x.device), last_pos.to(torch.int64)]
    return head_logits(params, xl[:, None], cfg)[:, 0].float(), caches


def decode_step_paged(params, cfg: ModelConfig, tokens, caches, page_table,
                      seq_lens):
    """One continuous-batching decode step against the paged caches.

    tokens [B, 1], one row a decode slot; page_table [B, P] int (physical
    page per logical page, 0 = null); seq_lens [B] int (tokens already
    cached per row, also the write position of this step's token). Rows
    with seq_len 0 and an all-null table are inactive padding slots. The
    caches are written in place: the KV pools by the paged kernel, each
    row's recurrent state into its slot. Returns logits [B, Vp] f32.
    """
    positions = seq_lens.to(torch.int64)[:, None]
    x, _ = _backbone(params, cfg, tokens, positions, "decode",
                     caches=caches, paged=(page_table, seq_lens))
    return head_logits(params, x, cfg)[:, 0].float()


def prefill_step(params, cfg: ModelConfig, tokens):
    """The dense baseline's prefill of tokens [B, S], no padding. Returns
    (the greedy next token [B, 1] int64, caches {"zo", "bp"}: attention KV
    [periods, B, S, KV, Dh], a window's ring when S exceeds it, and the
    recurrent state)."""
    x, caches = _backbone(params, cfg, tokens, _positions(tokens), "prefill")
    logits = head_logits(params, x[:, -1:], cfg)
    return torch.argmax(logits.float(), dim=-1), caches


def decode_step(params, cfg: ModelConfig, tokens, caches, cache_len: int):
    """One dense decode step: tokens [B, 1] at position ``cache_len``
    against caches grown by ``serve.kv_pages.grow_dense_caches``, which
    are written in place. Returns (the greedy next token [B, 1] int64,
    caches)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int64,
                           device=tokens.device)
    x, caches = _backbone(params, cfg, tokens, positions, "decode",
                          caches=caches, cache_len=cache_len)
    logits = head_logits(params, x, cfg)
    return torch.argmax(logits.float(), dim=-1), caches
