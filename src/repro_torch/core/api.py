"""Model API: init, the train step, prefill and the decode steps.

The port of ``repro/core/api.py``. Parameters keep the JAX package's
ElasticZO split: ``periods_zo`` (the zeroth-order head) and
``periods_bp`` (the back-propagated tail of ``tail_periods`` periods;
empty for a one-period stack). Serving runs both in order, and training
perturbs the head and differentiates the tail (``core/elastic.py``), for
every stack the port has: the decoder families (dense, MoE, RWKV6, the
Mamba hybrid), Whisper's encoder-decoder and LLaVA's image-token prefix.

On a mesh (a ``sharding/collectives.py::MeshRun``, ``run=``) the params
are the rank's shards: ``init`` draws one leaf at a time and keeps the
rank's slice, ``loss_fn`` runs the sharded forward on the rank's rows of
the batch (``batch_shardings`` says which; Whisper's ``frames`` and
LLaVA's ``img`` follow the tokens' rows), and the train step perturbs
and updates each shard at its global flat indices
(``core/engine.py``); every stack runs there.

Whisper's encoder runs on ``frames`` [B, encoder_seq, d] wherever the
decoder sees a whole sequence (prefill, train); a decode step reads the
cross-attention's cached keys and values instead. LLaVA's ``img`` [B,
num_image_tokens, d] goes before the text: positions span the image
tokens and the text, the loss drops the image rows, and a prefill's
``last_pos`` counts the image tokens. Both inputs are the stubbed front
ends' embeddings, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ..configs.base import LaneConfig, ModelConfig
from ..models.transformer import (embed, head_logits, init_lm, lm_loss,
                                  num_periods, run_encoder, run_periods,
                                  run_periods_paired, tree_map)
from . import zo
from .engine import Fp32Engine


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
    cuBLAS reads once, at its first product: importing ``repro_torch``
    sets ``CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8`` unless the caller set
    it, and a product on the card raises here when it is unset. Uninitialised outputs are not filled. The
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
    """BP-tail size in periods: ``ceil(bp_tail_layers / len(pattern))``,
    at least 1, but below ``num_periods``. So a one-period stack (reduced
    Jamba, or one period of the full one) gets 0: its BP part is the
    final norm and the unembedding only, as in the reference."""
    plen = len(cfg.pattern)
    k = max(1, -(-lane.bp_tail_layers // plen))          # ceil
    return min(k, cfg.num_periods - 1)


def split_caches(caches, cfg: ModelConfig, lane: LaneConfig):
    """{"zo": first periods, "bp": tail periods}; views, not copies."""
    pz = cfg.num_periods - tail_periods(cfg, lane)
    return {"zo": tree_map(lambda a: a[:pz], caches),
            "bp": tree_map(lambda a: a[pz:], caches)}


def init(cfg: ModelConfig, lane: Optional[LaneConfig] = None, *,
         seed: int = 0, device, dtype=None, max_seq: Optional[int] = None,
         run=None):
    """Random parameters with the periods split into zo and bp. Each half
    is a leading-dim slice of one stacked tensor, so it is contiguous.
    ``max_seq``: the rows of a learned ``pos_embed`` (stacks without
    RoPE); the serve engine takes its ``max_seq_len``, training its
    sequence length, as the JAX package does. On a mesh (``run``) each
    leaf is drawn whole, in the same order from the same generator, and
    only the rank's shard is kept before the next is drawn: bitwise the
    one-device init's slice, with one leaf's draw at a time on top of
    the shards. On ``device="meta"`` (the dry run) nothing is drawn: the
    init runs under a fake-tensor mode and each leaf (the rank's shard
    on a mesh) becomes a ``meta`` tensor of its shape and dtype, the two
    halves of each stacked leaf views of one storage as on a device."""
    if torch.device(device).type == "meta":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            params = _draw(cfg, seed, "cpu", dtype, max_seq, run)
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"), params)
    else:
        params = _draw(cfg, seed, device, dtype, max_seq, run)
    split = split_caches(params.pop("periods"), cfg, lane or LaneConfig())
    params["periods_zo"], params["periods_bp"] = split["zo"], split["bp"]
    return params


def _draw(cfg: ModelConfig, seed, device, dtype, max_seq, run):
    if run is None:
        return init_lm(cfg, seed=seed, device=device, dtype=dtype,
                       max_seq=max_seq)
    return _init_shards(cfg, seed, device, dtype, max_seq, run)


def _init_shards(cfg: ModelConfig, seed, device, dtype, max_seq, run):
    """``init_lm`` keeping the rank's shard of each drawn leaf. The draw
    order and each draw's leaf come from a run of the init under a fake
    tensor mode (no memory, no draws); a leaf the init does not draw (a
    constant: norm scales, RWKV6's gn_scale, Mamba's conv_b, dt_bias,
    A_log, D_skip) is made whole and cut to the rank's shard after it.
    Under a fake-tensor mode already active (``init`` on ``meta``) the
    order is taken under that one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models import layers
    from ..sharding.params import (map_dict, param_shardings, shard_desc,
                                   shard_leaf)
    active = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    drawn = []
    with (contextlib.nullcontext() if active else FakeTensorMode()), \
            layers.draw_hook(lambda w: drawn.append(w) or w):
        fake = init_lm(cfg, seed=seed, device="cpu", dtype=dtype,
                       max_seq=max_seq)
    where = {}
    map_dict(lambda names, t: where.setdefault(id(t), names), fake)
    specs = param_shardings(fake, run.rules)
    leaf_desc = map_dict(lambda names, t: shard_desc(
        tuple(t.shape), zo._at(specs, names), run.coords, run.sizes), fake)
    order = [zo._at(leaf_desc, where[id(w)]) for w in drawn]
    del fake, drawn
    descs = iter(order)
    with layers.draw_hook(lambda w: shard_leaf(w, next(descs))):
        params = init_lm(cfg, seed=seed, device=device, dtype=dtype,
                         max_seq=max_seq)
    if next(descs, None) is not None:
        raise AssertionError("the sharded init drew fewer leaves than the "
                             "fake one")
    return map_dict(lambda names, t: shard_leaf(t, zo._at(leaf_desc, names))
                    if tuple(t.shape) == zo._at(leaf_desc, names).global_shape
                    else t, params)


def abstract_params(cfg: ModelConfig, lane: Optional[LaneConfig] = None, *,
                    max_seq: Optional[int] = None):
    """``init``'s tree with ``meta`` tensors of its shapes and dtypes: a
    restore template that holds no memory (the reference's
    ``abstract_params``, a ``jax.eval_shape`` of the init). The init runs
    under a fake-tensor mode, which draws nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = init(cfg, lane, seed=0, device="cpu", max_seq=max_seq)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)


def _check_inputs(cfg: ModelConfig, tokens, frames, img):
    B = tokens.shape[0]
    if cfg.encoder_layers and (frames is None or tuple(frames.shape) != (
            B, cfg.encoder_seq, cfg.d_model)):
        raise ValueError(f"{cfg.name} needs frames [{B}, {cfg.encoder_seq}, "
                         f"{cfg.d_model}], got "
                         f"{None if frames is None else tuple(frames.shape)}")
    n = cfg.num_image_tokens
    if n and (img is None or tuple(img.shape) != (B, n, cfg.d_model)):
        raise ValueError(f"{cfg.name} needs img [{B}, {n}, {cfg.d_model}], "
                         f"got {None if img is None else tuple(img.shape)}")


def stub_inputs(cfg: ModelConfig, B: int, device) -> dict:
    """The zero frame embeddings (Whisper) and image-token embeddings
    (LLaVA) of a batch of B rows where the front end is a stub (the serve
    engines and the launchers, as in the JAX package), in the config's
    dtype; empty for a text-only stack."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=dt, device=device)
    if cfg.num_image_tokens:
        out["img"] = torch.zeros((B, cfg.num_image_tokens, cfg.d_model),
                                 dtype=dt, device=device)
    return out


def _backbone(params, cfg: ModelConfig, tokens, positions, mode, *,
              caches=None, frames=None, img=None, run=None, **kw):
    enc_out = None
    if mode != "decode":
        _check_inputs(cfg, tokens, frames, img)
        if cfg.encoder_layers:
            enc_out = run_encoder(params, frames, cfg, run=run)
    x = embed(params, tokens, positions, img, run=run)
    x, cz = run_periods(params["periods_zo"], x, cfg, positions=positions,
                        mode=mode, enc_out=enc_out, run=run, **kw,
                        caches=None if caches is None else caches["zo"])
    x, cb = run_periods(params["periods_bp"], x, cfg, positions=positions,
                        mode=mode, enc_out=enc_out, run=run, **kw,
                        caches=None if caches is None else caches["bp"])
    return x, {"zo": cz, "bp": cb}


def _positions(tokens, cfg: ModelConfig):
    """arange over the image tokens and the text, [B, n_img + S]."""
    B, S = tokens.shape
    S += cfg.num_image_tokens
    return torch.arange(S, dtype=torch.int64, device=tokens.device).expand(B, S)


# ---------------------------------------------------------------------- #
# train
# ---------------------------------------------------------------------- #
def loss_fn(params, cfg: ModelConfig, batch, run=None):
    """Mean next-token cross-entropy of batch {"tokens", "labels", "mask"}
    (each [B, S]; with "frames" for Whisper, "img" for LLaVA, whose image
    rows the loss drops). The ZO head is never differentiated: its leaves
    do not require grad, so autograd records nothing before
    ``periods_bp`` (the port's form of the JAX package's
    ``stop_gradient`` cut; Whisper's encoder output, made by ZO leaves,
    carries no gradient either). On a mesh (``run``): the rank's shards
    and rows, the global mean on every rank."""
    tokens = batch["tokens"]
    x, _ = _backbone(params, cfg, tokens, _positions(tokens, cfg), "train",
                     frames=batch.get("frames"), img=batch.get("img"),
                     run=run)
    x = x[:, cfg.num_image_tokens:]
    return lm_loss(params, x, batch["labels"], batch["mask"], cfg, run=run)


def paired_loss(bp_part, zo_part, cfg: ModelConfig, lane: LaneConfig, batch,
                seed, run=None):
    """(l+, l-) of one antithetic probe pair, the two ZO-head streams
    advanced together (``repro/core/api.py`` ``paired_loss``): the
    leaves outside ``periods_zo`` (``embed``, and ``pos_embed`` and
    ``encoder`` where the stack has them) perturbed whole, Whisper's
    encoder run once a sign, the ``periods_zo`` stack one period's slice
    at a time (``run_periods_paired``), then the BP tail and ``lm_loss``
    for each stream. Each stream's tail cross-attends to its own
    encoder's output, as in the unfused step (the JAX package gives both
    the +eps one). Bitwise the unfused path's two losses, with no
    perturbed copy of the head. seed: int32 [1] on the params' device.
    On a mesh (``run``; the parts the rank's shards, the batch its rows)
    ``embed`` is perturbed at its shard's index map and the periods go
    through ``run_periods_paired``'s mesh forms; both losses are the
    global ones on every rank."""
    tokens = batch["tokens"]
    frames, img = batch.get("frames"), batch.get("img")
    _check_inputs(cfg, tokens, frames, img)
    positions = _positions(tokens, cfg)
    rest = {k: v for k, v in zo_part.items() if k != "periods_zo"}
    maps = None if run is None else run.index_maps()
    xs, encs = [], []
    with torch.no_grad():
        for scale in (lane.zo_eps, -lane.zo_eps):
            pert = zo.perturb(rest, seed, scale, maps)
            encs.append(run_encoder(pert, frames, cfg, run=run)
                        if cfg.encoder_layers else None)
            xs.append(embed(pert, tokens, positions, img, run=run))
            del pert
    periods = zo_part["periods_zo"]
    n = num_periods(periods)
    salts = zo.map_with_path(
        lambda p, _: zo.path_salt(p, "['periods_zo']"), periods)
    if run is None:
        sizes = zo.map_with_path(lambda p, a: a.numel() // n, periods)
    else:                   # the global slice: the offset form's stride
        sizes = zo.map_with_path(
            lambda p, a: math.prod(zo._at(run.shapes["periods_zo"], p)[1:]),
            periods)
    xs = run_periods_paired(periods, xs, cfg, positions=positions,
                            seed=seed, eps=lane.zo_eps, salts=salts,
                            sizes=sizes, enc_pair=encs, run=run)
    losses = []
    for x, enc_out in zip(xs, encs):
        x, _ = run_periods(bp_part["periods_bp"], x, cfg, positions=positions,
                           mode="train", enc_out=enc_out, run=run)
        losses.append(lm_loss(bp_part, x[:, cfg.num_image_tokens:],
                              batch["labels"], batch["mask"], cfg, run=run))
    return losses[0], losses[1]


def train_engine(cfg: ModelConfig, lane: LaneConfig, run=None):
    """(engine, loss) that ``lane``'s step is built from: the step is
    ``engine.make_step(loss)``, and ``core/engine.py::
    profile_step_phases(engine, loss, ...)`` times its phases. With
    ``lane.fused_probes`` an elastic_zo step takes each probe pair
    through ``paired_loss``. On a mesh (``run``) the engine perturbs and
    updates shards and the loss (and the fused pair) is the sharded
    one."""
    paired = None
    if lane.fused_probes and lane.lane == "elastic_zo":
        paired = lambda bp, zo_part, batch, seed: paired_loss(  # noqa: E731
            bp, zo_part, cfg, lane, batch, seed, run=run)
    return (Fp32Engine(lane, paired_loss_fn=paired, run=run),
            lambda p, b: loss_fn(p, cfg, b, run=run))


def make_train_step(cfg: ModelConfig, lane: LaneConfig, run=None):
    """The ElasticZO step of ``lane`` over ``loss_fn``:
    (state, batch, probe_mask) -> (state, metrics)."""
    engine, loss = train_engine(cfg, lane, run)
    return engine.make_step(loss)


def input_specs(cfg: ModelConfig, shape, lane: LaneConfig) -> dict:
    """The global inputs of a step of ``shape`` (a ``ShapeConfig``), as
    ``meta`` tensors (shapes and dtypes, no memory; the reference's
    ``build_input_specs``): train ``tokens``, ``labels``
    (int32 [B, S_tok]), ``mask`` (f32) and ``probe_mask`` (f32 [probes],
    always a host tensor: the step reads it on the host); prefill
    ``tokens``; decode ``tokens`` [B, 1] and ``cache_len`` (int32 []).
    ``S_tok = S - num_image_tokens`` for train and prefill, which carry
    Whisper's ``frames`` [B, encoder_seq, d] and LLaVA's ``img`` [B,
    num_image_tokens, d] in the config's dtype."""
    B, S = shape.global_batch, shape.seq_len
    n_img = cfg.num_image_tokens
    dtype = getattr(torch, cfg.dtype)
    S_tok = S - n_img if shape.kind in ("train", "prefill") else S

    def empty(dims, dt):
        return torch.empty(dims, dtype=dt, device="meta")
    specs = {}
    if shape.kind == "train":
        specs["tokens"] = empty((B, S_tok), torch.int32)
        specs["labels"] = empty((B, S_tok), torch.int32)
        specs["mask"] = empty((B, S_tok), torch.float32)
        specs["probe_mask"] = torch.ones(lane.zo_num_probes,
                                         dtype=torch.float32)
    elif shape.kind == "prefill":
        specs["tokens"] = empty((B, S_tok), torch.int32)
    else:                                                # decode
        specs["tokens"] = empty((B, 1), torch.int32)
        specs["cache_len"] = empty((), torch.int32)
    if cfg.encoder_layers and shape.kind in ("train", "prefill"):
        specs["frames"] = empty((B, cfg.encoder_seq, cfg.d_model), dtype)
    if n_img and shape.kind in ("train", "prefill"):
        specs["img"] = empty((B, n_img, cfg.d_model), dtype)
    return specs


def batch_shardings(specs, rules):
    """The spec of each entry of a train batch (``specs``: {name: shape
    or anything with ``shape``}; ``repro/core/api.py::batch_shardings``):
    rows over the batch axes, ``probe_mask`` / ``cache_len`` replicated,
    and an entry whose rows the batch axes do not divide replicated (a
    tiny batch). Every entry None without a mesh."""
    from ..sharding.rules import axes_size
    if rules.mesh is None:
        return {k: None for k in specs}
    out = {}
    for k, v in specs.items():
        shape = tuple(getattr(v, "shape", v))
        if k in ("probe_mask", "cache_len"):
            out[k] = ()
        elif len(shape) == 3:
            out[k] = (rules.batch, None, None)
        else:
            out[k] = (rules.batch, None)
        bsize = axes_size(rules.sizes, rules.batch) if rules.batch else 1
        if shape and shape[0] % max(bsize, 1) != 0:
            out[k] = (None,) * len(shape)
    return out


# ---------------------------------------------------------------------- #
# serve
# ---------------------------------------------------------------------- #
def prefill_logits(params, cfg: ModelConfig, tokens, last_pos, frames=None,
                   img=None):
    """Prefill of tokens [B, S] (with Whisper's ``frames``, LLaVA's
    ``img``). Returns (logits [B, Vp] f32 at each row's ``last_pos``, an
    absolute position that counts the image tokens (right-padded prompts
    are allowed for attention-only stacks; recurrent state absorbs every
    position), the new caches {"zo", "bp"} for paged admission:
    full-length attention KV [periods, B, n_img + S, KV, Dh], Whisper's
    cross-attention ck / cv and each row's recurrent state after the
    last position)."""
    B = tokens.shape[0]
    x, caches = _backbone(params, cfg, tokens, _positions(tokens, cfg),
                          "prefill", frames=frames, img=img, full_kv=True)
    xl = x[torch.arange(B, device=x.device), last_pos.to(torch.int64)]
    return head_logits(params, xl[:, None], cfg)[:, 0].float(), caches


def decode_step_paged(params, cfg: ModelConfig, tokens, caches, page_table,
                      seq_lens):
    """One continuous-batching decode step against the paged caches.

    tokens [B, 1], one row a decode slot; page_table [B, P] int (physical
    page per logical page, 0 = null); seq_lens [B] int (tokens already
    cached per row, image tokens included, also the write position of
    this step's token). Rows with seq_len 0 and an all-null table are
    inactive padding slots. The caches are written in place: the KV pools
    by the paged kernel, each row's recurrent state into its slot.
    Returns logits [B, Vp] f32.
    """
    positions = seq_lens.to(torch.int64)[:, None]
    x, _ = _backbone(params, cfg, tokens, positions, "decode",
                     caches=caches, paged=(page_table, seq_lens))
    return head_logits(params, x, cfg)[:, 0].float()


def prefill_step(params, cfg: ModelConfig, tokens, frames=None, img=None):
    """The dense baseline's prefill of tokens [B, S], no padding (with
    Whisper's ``frames``, LLaVA's ``img``). Returns (the greedy next
    token [B, 1] int64, caches {"zo", "bp"}: attention KV [periods, B,
    n_img + S, KV, Dh], a window's ring when that exceeds it, Whisper's
    ck / cv, and the recurrent state)."""
    x, caches = _backbone(params, cfg, tokens, _positions(tokens, cfg),
                          "prefill", frames=frames, img=img)
    logits = head_logits(params, x[:, -1:], cfg)
    return torch.argmax(logits.float(), dim=-1), caches


def decode_step(params, cfg: ModelConfig, tokens, caches, cache_len: int):
    """One dense decode step: tokens [B, 1] at position ``cache_len``
    (image tokens included) against caches grown by
    ``serve.kv_pages.grow_dense_caches``, which are written in place.
    Returns (the greedy next token [B, 1] int64, caches)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int64,
                           device=tokens.device)
    x, caches = _backbone(params, cfg, tokens, positions, "decode",
                          caches=caches, cache_len=cache_len)
    logits = head_logits(params, x, cfg)
    return torch.argmax(logits.float(), dim=-1), caches
