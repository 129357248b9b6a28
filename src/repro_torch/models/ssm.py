"""RWKV6 (Finch) and Mamba blocks in chunk-parallel form.

The port of ``repro/models/ssm.py``. Prefill evaluates each recurrence
chunk-parallel: intra-chunk terms as batched products and cumsums, the
state carried across chunk boundaries. Where the reference combines the
chunk boundaries with ``jax.lax.associative_scan`` (a log-depth tree),
the port walks the chunks in order: the same recurrence, summed in
another order, so the two agree within float tolerance, not bitwise.
Decode (S = 1 with a state) takes the exact O(1) step, no chunking.

On a mesh (``specs``, ``run``: a training forward, no state) each block
takes its leaves' specs: where `model` splits RWKV6's heads or Mamba's
d_inner, a rank computes its heads or channels (the WKV walk, the group
norm, the causal conv and the selective scan act per head or channel,
and the sequence is never split) and the row-parallel projections are
all-reduced over `model` (``layers.py::_row_parallel``). Where it
splits neither (``fsdp``'s whole weights, or a count tp does not
divide), every rank computes the one-device block.

Per-step log decays are clamped to ``>= -DECAY_CLAMP`` and chunks kept at
``CHUNK`` steps, so the factored rescaling ``exp(lc_i - lc_j)`` stays in
f32 range (the reference's bound, e^(CHUNK * DECAY_CLAMP)). The
recurrent states ``wkv`` and ``ssm`` are f32 in any model dtype; the
token-shift and conv carries are in the model's dtype. Neither block
reaches a Pallas kernel in the reference, so plain torch is the port.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import (_model_sharded, _rank_part, _row_parallel, dense_init,
                     group_norm_heads, rms_norm)

CHUNK = 16
DECAY_CLAMP = 4.0        # per-step |log decay| bound
SEGMENT = 1024           # outer segments of the mamba scan (memory bound)
LORA = 32                # rank of the time-mix interpolation deltas
DECAY_LORA = 64          # rank of the data-dependent decay


# ===================================================================== #
# RWKV6 (Finch)
# ===================================================================== #
def init_rwkv_block(gen, cfg: ModelConfig, dtype, lead=()):
    """Weights stacked over ``lead``; scales are the reference's
    (``dense_init``'s default fan-in there is the leading dim)."""
    d, ff, Dh = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    H = d // Dh
    lead = tuple(lead)
    dev = gen.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    def w(shape, fan_in):
        return dense_init(gen, lead + shape, dtype, fan_in=fan_in)

    return {
        "ln1": full((d,), 1.0), "ln2": full((d,), 1.0),
        # time-mix (ddlerp): base mus + low-rank data-dependent deltas
        "maa_x": full((d,), 0.0),
        "maa_base": full((5, d), 0.0),                    # r, k, v, w, g
        "maa_w1": w((d, 5 * LORA), d),
        "maa_w2": w((5, LORA, d), LORA),
        "w_r": w((d, d), d), "w_k": w((d, d), d), "w_v": w((d, d), d),
        "w_g": w((d, d), d), "w_o": w((d, d), d),
        # data-dependent decay: base + low-rank
        "decay_base": full((d,), -1.0),
        "decay_w1": w((d, DECAY_LORA), d),
        "decay_w2": w((DECAY_LORA, d), DECAY_LORA),
        "bonus": w((H, Dh), H),                           # u
        "gn_scale": full((H, Dh), 1.0),
        # channel-mix
        "cm_mu_k": full((d,), 0.0), "cm_mu_r": full((d,), 0.0),
        "cm_k": w((d, ff), d),
        "cm_v": w((ff, d), ff),
        "cm_r": w((d, d), d),
    }


def _split(specs, name: str, run) -> bool:
    """Whether a block on a mesh (``run``) computes the rank's part of
    the dim that leaf ``name`` (of its heads or channels) is sharded
    over `model` by its spec."""
    return run is not None and not run.whole_weights and \
        _model_sharded(specs[name])


def _whole_over_model(p, specs, run):
    """``p``'s leaves whole on every `model` rank where the block does
    not split its heads or channels but a leaf of it is sharded there
    (tp divides d_model, or Mamba's 2 d_inner, and not the heads or
    d_inner): each such leaf all-gathered along its `model` dim, its
    gradient the rank's own part of the whole one (every rank computes
    the same block)."""
    if run is None or run.whole_weights:
        return p
    from ..sharding.collectives import replica_gather
    out = {}
    for name, t in p.items():
        dims = [d for d, ax in enumerate(specs[name] or ())
                if _model_sharded((ax,))]
        out[name] = replica_gather(t, run.model_group, dims[0],
                                   run.model_rank) if dims else t
    return out


def _token_shift(x, last: Optional[torch.Tensor]):
    """Shift the sequence right by one; ``last`` [B, 1, D] is the previous
    token (decode carry), zeros at t = 0 otherwise."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv_time_mix(p, x, cfg: ModelConfig, state, specs=None, run=None):
    """x: [B, S, D]. state: {"tm_shift" [B, 1, D], "wkv" [B, H, Dk, Dv]
    f32, ...} or None. Returns (y, {"tm_shift", "wkv"}).

    On a mesh with the heads split over `model` (``specs["bonus"]``):
    the ddlerp runs whole on every rank (its leaves are whole there), the
    lerped inputs of w_r / w_k / w_v / w_g and tanh(xw @ decay_w1) are
    ``copy_to`` `model` (each rank's share of their gradient, from its
    heads, summed there, so the ddlerp's leaves get whole, equal
    gradients), r / k / v / g and the decay are the rank's heads' columns
    (``decay_base``, whole, indexed to them by ``_rank_part``), the WKV
    walk and the group norm run on those heads, and w_o is row-parallel
    (``_row_parallel``)."""
    split = _split(specs, "bonus", run)
    if not split:
        p = _whole_over_model({k: t for k, t in p.items()
                               if not k.startswith("cm_")}, specs, run)
    B, S, D = x.shape
    Dh = cfg.rwkv_head_dim
    H = p["bonus"].shape[0]                      # the rank's heads
    xprev = _token_shift(x, state["tm_shift"] if state is not None else None)
    xx = xprev - x
    # ddlerp, computed per projection to avoid a [B, S, 5, D] residency
    xxx = x + xx * p["maa_x"]
    mk = torch.tanh(torch.einsum("bsd,dl->bsl", xxx, p["maa_w1"]))
    mk = mk.reshape(B, S, 5, -1)

    def lerped(i):
        mu = p["maa_base"][i] + torch.einsum("bsl,ld->bsd", mk[:, :, i],
                                             p["maa_w2"][i])
        return x + xx * mu

    xr, xk, xv, xw, xg = (lerped(i) for i in range(5))
    dw = torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["decay_w1"]))
    decay_base = p["decay_base"]
    if split:
        from ..sharding.collectives import copy_to
        g_ = run.model_group
        xr, xk, xv, xg, dw = (copy_to(t, g_) for t in (xr, xk, xv, xg, dw))
        lo = run.model_rank * H * Dh
        decay_base = _rank_part(decay_base, specs["decay_base"], 0,
                                range(lo, lo + H * Dh), run)
    r = torch.einsum("bsd,de->bse", xr, p["w_r"]).reshape(B, S, H, Dh)
    k = torch.einsum("bsd,de->bse", xk, p["w_k"]).reshape(B, S, H, Dh)
    v = torch.einsum("bsd,de->bse", xv, p["w_v"]).reshape(B, S, H, Dh)
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["w_g"]))

    decay_logit = decay_base + torch.einsum("bsd,de->bse", dw, p["decay_w2"])
    # log w_t in [-DECAY_CLAMP, -1e-4] (clamped data-dependent decay)
    logw = -torch.clamp(torch.exp(decay_logit.float()), 1e-4,
                        DECAY_CLAMP).reshape(B, S, H, Dh)
    u = p["bonus"].float()

    if S == 1 and state is not None:
        # the exact decode step
        wkv = state["wkv"]                                 # [B, H, Dk, Dv]
        r1, k1, v1 = (t.reshape(B, H, Dh).float() for t in (r, k, v))
        cur = wkv + (u[None] * k1)[..., None] * v1[:, :, None, :]
        o = torch.einsum("bhk,bhkv->bhv", r1, cur)
        new_wkv = torch.exp(logw.reshape(B, H, Dh))[..., None] * wkv \
            + k1[..., None] * v1[:, :, None, :]
        out = o.reshape(B, 1, H, Dh)
        new_state = {"tm_shift": x, "wkv": new_wkv}
    else:
        out, last_wkv = _wkv_chunked(
            r, k, v, logw, u,
            init=state["wkv"] if state is not None else None)
        new_state = {"tm_shift": x[:, -1:], "wkv": last_wkv}

    out = group_norm_heads(out.to(x.dtype), p["gn_scale"], cfg.norm_eps)
    out = out.reshape(B, S, H * Dh) * g
    if split:
        return _row_parallel("bsd,de->bse", out, p["w_o"], run), new_state
    return torch.einsum("bsd,de->bse", out, p["w_o"]), new_state


def _wkv_chunked(r, k, v, logw, u, init=None):
    """Chunked WKV6: r, k, v [B, S, H, Dh]; logw [B, S, H, Dh] (<= 0);
    u [H, Dh]. Returns (out [B, S, H, Dh] f32, final state [B, H, Dk, Dv]
    f32)."""
    B, S, H, Dh = r.shape
    c = min(CHUNK, S)
    S0 = S
    if S % c:
        # pad to a chunk multiple: k = v = 0 adds nothing and logw = 0
        # keeps the state (decay 1), exactly
        pad = c - S % c
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
        S += pad
    N = S // c
    rc, kc, vc = (t.float().reshape(B, N, c, H, Dh) for t in (r, k, v))
    lw = logw.reshape(B, N, c, H, Dh)

    lc = torch.cumsum(lw, dim=2)                           # inclusive
    lc_prev = lc - lw                                      # exclusive
    total = lc[:, :, -1]                                   # [B, N, H, Dh]

    # intra-chunk: scores[i, j] = sum_d r_i k_j exp(lc_prev_i - lc_j), j < i
    q_s = rc * torch.exp(lc_prev)
    k_s = kc * torch.exp(-lc)
    scores = torch.einsum("bnihd,bnjhd->bnhij", q_s, k_s)
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                      diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    # bonus diagonal (j == i): r_i (u * k_i) v_i
    diag = torch.einsum("bnihd,bnihd->bnhi", rc, kc * u)
    out = torch.einsum("bnhij,bnjhd->bnihd", scores, vc)
    out = out + diag[..., None].permute(0, 1, 3, 2, 4) * vc

    # chunk states: S_n = exp(total_n) * S_{n-1} + sum_j exp(total_n -
    # lc_j) k_j v_j^T, walked in order
    contrib = torch.einsum("bnjhk,bnjhv->bnhkv",
                           kc * torch.exp(total[:, :, None] - lc), vc)
    decay = torch.exp(total)[..., None]                    # [B, N, H, Dk, 1]
    state = torch.zeros_like(contrib[:, 0]) if init is None else init.float()
    starts = []
    for n in range(N):
        starts.append(state)
        state = decay[:, n] * state + contrib[:, n]
    # inter-chunk: o_i += (r_i * exp(lc_prev_i))^T S_start
    out = out + torch.einsum("bnihk,bnhkv->bnihv", q_s,
                             torch.stack(starts, dim=1))
    return out.reshape(B, S, H, Dh)[:, :S0], state


def rwkv_channel_mix(p, x, state, specs=None, run=None):
    """On a mesh with d_ff split over `model` (``specs["cm_k"]``): xk is
    ``copy_to`` `model`, k the rank's d_ff columns, cm_v row-parallel;
    cm_r is whole, so r is the same on every rank."""
    split = _split(specs, "cm_k", run)
    xprev = _token_shift(x, state["cm_shift"] if state is not None else None)
    xx = xprev - x
    xk = x + xx * p["cm_mu_k"]
    xr = x + xx * p["cm_mu_r"]
    if split:
        from ..sharding.collectives import copy_to
        xk = copy_to(xk, run.model_group)
    k = torch.square(F.relu(torch.einsum("bsd,df->bsf", xk, p["cm_k"])))
    if split:
        v = _row_parallel("bsf,fd->bsd", k, p["cm_v"], run)
    else:
        v = torch.einsum("bsf,fd->bsd", k, p["cm_v"])
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["cm_r"]))
    return r * v, {"cm_shift": x[:, -1:]}


def rwkv_block(p, x, cfg: ModelConfig, state, specs=None, run=None):
    """The whole RWKV6 block. state: None (train or prefill from zeros)
    or the dict of ``init_rwkv_state``. Returns (x, new state). On a mesh
    (``run``: a training forward) ``p`` holds the leaves as
    ``MeshRun.weights`` gives them and ``specs`` their specs."""
    h, tm_state = rwkv_time_mix(p, rms_norm(x, p["ln1"], cfg.norm_eps),
                                cfg, state, specs, run)
    x = x + h
    h, cm_state = rwkv_channel_mix(p, rms_norm(x, p["ln2"], cfg.norm_eps),
                                   state, specs, run)
    return x + h, {**tm_state, **cm_state}


def init_rwkv_state(cfg: ModelConfig, B: int, dtype, *, device, lead=()):
    d, Dh = cfg.d_model, cfg.rwkv_head_dim
    H = d // Dh
    lead = tuple(lead)
    return {
        "tm_shift": torch.zeros(lead + (B, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros(lead + (B, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros(lead + (B, H, Dh, Dh), dtype=torch.float32,
                           device=device),
    }


# ===================================================================== #
# Mamba (Jamba's SSM blocks)
# ===================================================================== #
def init_mamba_block(gen, cfg: ModelConfig, dtype, lead=()):
    d, N, W = cfg.d_model, cfg.ssm_state_dim, cfg.ssm_conv_width
    di = cfg.ssm_expand * d
    dt_rank = max(d // 16, 1)
    lead = tuple(lead)
    dev = gen.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    def w(shape, fan_in):
        return dense_init(gen, lead + shape, dtype, fan_in=fan_in)

    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev)).expand(lead + (di, N))
    return {
        "norm": full((d,), 1.0),
        "in_proj": w((d, 2 * di), d),
        "conv_w": w((W, di), W),
        "conv_b": full((di,), 0.0),
        "x_proj": w((di, dt_rank + 2 * N), di),
        "dt_proj": w((dt_rank, di), dt_rank),
        "dt_bias": full((di,), -4.6),                     # softplus^-1(0.01)
        "A_log": a_log.to(dtype).contiguous(),
        "D_skip": full((di,), 1.0),
        "out_proj": w((di, d), di),
        # Jamba adds RMS norms on dt, B and C
        "dt_norm": full((dt_rank,), 1.0),
        "B_norm": full((N,), 1.0),
        "C_norm": full((N,), 1.0),
    }


def _causal_conv(x, w, b, carry):
    """Depthwise causal conv; x [B, S, di], w [W, di], carry [B, W-1, di]
    or None. Returns (y, new carry)."""
    W = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_carry = xp[:, -(W - 1):] if W > 1 else carry
    return out + b, new_carry


def in_proj_channels(h, in_proj, run):
    """(xs, z) [B, S, di / tp] each, the rank's d_inner channels of h @
    in_proj, from the rank's contiguous column shard of in_proj [d,
    2 di / tp] (whose columns are not its xs and z channels: at tp 2
    rank 0 holds all of xs): h is ``copy_to`` `model`, the product's
    blocks are all-gathered along the last dim over `model`
    (``fsdp_gather``: the gradient reduce-scattered back, each column
    used on one rank) and the rank's xs and z columns are taken from the
    whole, so in_proj keeps its layout (which the noise's flat indices
    and the checkpoints read)."""
    from ..sharding.collectives import copy_to, fsdp_gather
    g = run.model_group
    xz = fsdp_gather(torch.einsum("bsd,de->bse", copy_to(h, g), in_proj),
                     g, 2)
    di = xz.shape[-1] // 2
    dl = di // run.tp
    lo = run.model_rank * dl
    return xz[..., lo:lo + dl], xz[..., di + lo:di + lo + dl]


def mamba_block(p, x, cfg: ModelConfig, state, specs=None, run=None):
    """x: [B, S, D]; state: None or {"conv" [B, W-1, di], "ssm" [B, di, N]
    f32}. Returns (x + block(x), new state).

    On a mesh with d_inner split over `model` (``specs["conv_b"]``): the
    rank's xs and z channels come from ``in_proj_channels``; the conv and
    the scan run on those channels; x_proj's partial sums are all-reduced
    before the dt, B and C norms (``_row_parallel``), whose outputs are
    ``copy_to`` `model` (each rank's share of their gradient summed
    there, so the replicated norm scales get whole, equal gradients);
    out_proj is row-parallel."""
    split = _split(specs, "conv_b", run)
    if not split:
        p = _whole_over_model(p, specs, run)
    N = cfg.ssm_state_dim
    S = x.shape[1]
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if split:
        xs, z = in_proj_channels(h, p["in_proj"], run)
    else:
        xs, z = torch.einsum("bsd,de->bse", h, p["in_proj"]).chunk(2, dim=-1)
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"],
                                state["conv"] if state is not None else None)
    xs = F.silu(xs)

    if split:
        dbc = _row_parallel("bse,ez->bsz", xs, p["x_proj"], run)
    else:
        dbc = torch.einsum("bse,ez->bsz", xs, p["x_proj"])
    dt_rank = p["dt_proj"].shape[0]
    dt_low, Bc, Cc = torch.split(dbc, [dt_rank, N, N], dim=-1)
    dt_low = rms_norm(dt_low, p["dt_norm"], cfg.norm_eps)
    Bc = rms_norm(Bc, p["B_norm"], cfg.norm_eps)
    Cc = rms_norm(Cc, p["C_norm"], cfg.norm_eps)
    if split:
        from ..sharding.collectives import copy_to
        dt_low, Bc, Cc = (copy_to(t, run.model_group)
                          for t in (dt_low, Bc, Cc))
    dt = F.softplus(torch.einsum("bsr,re->bse", dt_low, p["dt_proj"])
                    + p["dt_bias"].float())                # [B, S, di] f32
    A = -torch.exp(p["A_log"].float())                     # [di, N]
    xdt = xs.float() * dt
    skip = p["D_skip"].float() * xs.float()

    if S == 1 and state is not None:
        # the exact decode step
        la = dt[:, 0, :, None] * A[None]                   # [B, di, N]
        ssm = torch.exp(la) * state["ssm"] \
            + xdt[:, 0, :, None] * Bc[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", ssm, Cc[:, 0].float())[:, None] + skip
    else:
        y, ssm = _mamba_chunked(
            xdt, dt, A, Bc.float(), Cc.float(),
            init=state["ssm"] if state is not None else None)
        y = y + skip

    y = (y * F.silu(z.float())).to(x.dtype)
    if split:
        out = _row_parallel("bse,ed->bsd", y, p["out_proj"], run)
    else:
        out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return x + out, {"conv": new_conv, "ssm": ssm}


def _mamba_chunked(xdt, dt, A, Bc, Cc, init=None):
    """Chunk-parallel selective-SSM scan. xdt, dt: [B, S, di] f32; A
    [di, N]; Bc, Cc [B, S, N] f32. h_t = exp(dt_t A) * h_{t-1} + xdt_t B_t,
    y_t = h_t . C_t. Segments of SEGMENT tokens bound the [B, seg, di, N]
    intermediates."""
    B, S, di = xdt.shape
    seg = min(SEGMENT, S)
    carry = init if init is not None else torch.zeros(
        (B, di, A.shape[1]), dtype=torch.float32, device=xdt.device)
    ys = []
    for s0 in range(0, S, seg):
        y, carry = _mamba_segment(
            xdt[:, s0:s0 + seg], dt[:, s0:s0 + seg], A,
            Bc[:, s0:s0 + seg], Cc[:, s0:s0 + seg], carry)
        ys.append(y)
    return (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), carry


def _mamba_segment(xdt, dt, A, Bc, Cc, carry):
    B, S, di = xdt.shape
    N = A.shape[1]
    c = min(CHUNK, S)
    S0 = S
    if S % c:
        # dt = 0 gives decay exp(0) = 1 and no contribution: exact
        pad = c - S % c
        xdt, dt, Bc, Cc = (F.pad(t, (0, 0, 0, pad)) for t in (xdt, dt, Bc, Cc))
        S += pad
    NC = S // c
    # per-step log decay, clamped
    la = torch.clamp(dt[..., None] * A[None, None], min=-DECAY_CLAMP)
    lc = torch.cumsum(la.reshape(B, NC, c, di, N), dim=2)   # inclusive
    total = lc[:, :, -1]                                   # [B, NC, di, N]
    xc = xdt.reshape(B, NC, c, di)
    bc = Bc.reshape(B, NC, c, N)
    cc = Cc.reshape(B, NC, c, N)
    xb = xc[..., None] * bc[:, :, :, None, :]              # [B, NC, c, di, N]

    # intra-chunk: Z[l] = cumsum_{j <= l} (x_j B_j) exp(-lc_j)
    Z = torch.cumsum(xb * torch.exp(-lc), dim=2)
    y_intra = torch.sum(torch.exp(lc) * Z * cc[:, :, :, None, :], dim=-1)
    # chunk boundary states, walked in order
    chunk_contrib = torch.sum(xb * torch.exp(total[:, :, None] - lc), dim=2)
    decay = torch.exp(total)
    state, starts = carry, []
    for n in range(NC):
        starts.append(state)
        state = decay[:, n] * state + chunk_contrib[:, n]
    start = torch.stack(starts, dim=1)                     # [B, NC, di, N]
    # inter-chunk: y_l += C_l . (exp(lc_l) * h_start)
    y_inter = torch.sum(torch.exp(lc) * start[:, :, None]
                        * cc[:, :, :, None, :], dim=-1)
    return (y_intra + y_inter).reshape(B, S, di)[:, :S0], state


def init_mamba_state(cfg: ModelConfig, B: int, dtype, *, device, lead=()):
    di = cfg.ssm_expand * cfg.d_model
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (B, cfg.ssm_conv_width - 1, di),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (B, di, cfg.ssm_state_dim),
                           dtype=torch.float32, device=device),
    }
