"""Plain PyTorch versions of the kernels (the allclose ground truth).

Each function repeats ``repro/kernels/ref.py`` op for op. The CPU tests
hold them against the JAX package, ``chip_smoke.py`` holds the CUDA
kernels against them on the card, and ``kernels/ops.py`` takes them for
tensors on the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import prng
from ..core.prng import MASK32

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0,
                        return_lse: bool = False):
    """Dense-softmax version of the flash attention
    (``repro/kernels/ref.py::flash_attention_ref``, same layout): q
    [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> o [B,H,Sq,D] in q's dtype. Hkv divides
    H and q head h reads kv head h // (H / Hkv) (the JAX function has
    Hkv == H). Query row i sits at position ``q_offset + i`` (the JAX
    function's rows start at 0: masks top-left aligned), masked scores
    are -1e30, and the scores, softmax and weighted sum are f32. With
    ``return_lse`` also each row's log-sum-exp of those scores, f32
    [B,H,Sq] (the port's addition: the JAX function has none)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    G = H // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving uint32 key held in int64 (-0.0 is
    canonicalised to +0.0, so key order agrees with float order)."""
    s = (x.float() + 0.0).view(torch.int32).to(torch.int64)
    u = s & MASK32
    return torch.where(s < 0, (~u) & MASK32, u | 0x80000000)


def topk_topp_mask_ref(logits: torch.Tensor, k: torch.Tensor,
                       p: torch.Tensor) -> torch.Tensor:
    """Sort-free top-k/top-p filter: threshold-refine partial selection.

    logits [B, V] f32; k [B] int (<= 0 disables); p [B] f32 (>= 1
    disables). Returns logits with filtered entries at NEG_INF. Top-k
    keeps every value >= the exact k-th largest value (found by a 4-round
    byte-radix descent over the monotone key). Top-p finds the boundary
    value T where the nucleus mass crosses p and G, the mass strictly
    above T; the tied run at T is split in index order (rank r kept iff
    G + r * p_T < p). See ``repro/kernels/ref.py::topk_topp_mask_ref``.
    """
    B, V = logits.shape
    dev = logits.device
    k = k.to(device=dev, dtype=torch.int64)
    p = p.to(device=dev, dtype=torch.float32)

    # ---- top-k: radix-select the exact k-th largest key -------------- #
    keys = _monotone_key(logits)
    krem = k.clamp(1, V)
    cand = torch.ones((B, V), dtype=torch.int64, device=dev)
    kth = torch.zeros(B, dtype=torch.int64, device=dev)
    for shift in (24, 16, 8, 0):
        byte = (keys >> shift) & 0xFF
        hist = torch.zeros((B, 256), dtype=torch.int64,
                           device=dev).scatter_add_(1, byte, cand)
        cnt_ge = hist.flip(1).cumsum(1).flip(1)
        above = cnt_ge - hist                     # strictly above bucket j
        cond = (above < krem[:, None]) & (cnt_ge >= krem[:, None])
        j = cond.to(torch.int32).argmax(1)        # the unique True
        krem = krem - above.gather(1, j[:, None])[:, 0]
        kth = kth | (j.to(torch.int64) << shift)
        cand = cand * (byte == j[:, None])
    keep = (keys >= kth[:, None]) | (k <= 0)[:, None]
    x = torch.where(keep, logits.float(), NEG_INF)

    # ---- top-p: refine the nucleus boundary value -------------------- #
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    probs = e / e.sum(dim=1, keepdim=True)
    keys = _monotone_key(x)
    cand_m = torch.ones((B, V), dtype=torch.float32, device=dev)
    above_mass = torch.zeros(B, dtype=torch.float32, device=dev)
    tkey = torch.zeros(B, dtype=torch.int64, device=dev)
    for shift in (24, 16, 8, 0):
        byte = (keys >> shift) & 0xFF
        mh = torch.zeros((B, 256), dtype=torch.float32,
                         device=dev).scatter_add_(1, byte, probs * cand_m)
        above = mh.flip(1).cumsum(1).flip(1) - mh + above_mass[:, None]
        cond = above < p[:, None]
        j = cond.to(torch.int32).argmax(1)        # lowest such bucket
        above_mass = above.gather(1, j[:, None])[:, 0]
        tkey = tkey | (j.to(torch.int64) << shift)
        cand_m = cand_m * (byte == j[:, None])
    eq = keys == tkey[:, None]
    p_t = torch.where(eq, probs, 0.0).max(dim=1).values
    eqi = eq.to(torch.int64)
    r = eqi.cumsum(1) - eqi                       # tie rank in index order
    keep_p = (keys > tkey[:, None]) \
        | (eq & (above_mass[:, None] + r * p_t[:, None] < p[:, None])) \
        | (p >= 1.0)[:, None]
    return torch.where(keep_p, x, NEG_INF)


def paged_attn_step_ref(q, k_new, v_new, k_pool, v_pool, page_table,
                        seq_lens, *, scale: float, window: int = 0):
    """Write-then-gather-then-attend version of the paged decode step.

    q [B,KVd,G,Dh]; k_new/v_new [B,KVd,Dh]; pools [N,ps,KVd,Dh];
    page_table [B,P] int; seq_lens [B] int. The token's K/V is written
    into its pool slot **in place** (the JAX package returns new pools
    instead), then the gathered [B, P*ps, KVd, Dh] cache is attended with
    the model's dense ``_attend_block``. Null table entries (page 0) are
    masked per position. A row with no live position (an inactive row:
    seq_len 0, all-null table) gets the mean of the null page's V, as the
    JAX reference does; the CUDA kernel gives 0 there, as the Pallas
    kernel does. Callers use active rows only. Returns o [B,KVd,G,Dh].
    """
    from ..models.layers import _attend_block
    from ..serve.kv_pages import NULL_PAGE
    B, KVd, G, Dh = q.shape
    ps = k_pool.shape[1]
    pos = seq_lens.to(torch.int64)
    table = page_table.to(torch.int64)
    pidx = table.gather(1, (pos // ps)[:, None])[:, 0]
    k_pool[pidx, pos % ps] = k_new.to(k_pool.dtype)
    v_pool[pidx, pos % ps] = v_new.to(v_pool.dtype)
    k = k_pool[table].reshape(B, -1, KVd, Dh)
    v = v_pool[table].reshape(B, -1, KVd, Dh)
    t = torch.arange(k.shape[1], device=q.device)
    valid = t[None, :] <= pos[:, None]
    if window > 0:
        valid &= t[None, :] > pos[:, None] - window
    valid &= (table != NULL_PAGE).repeat_interleave(ps, dim=1)
    return _attend_block(q[:, None], k, v, valid[:, None, :], scale)[:, 0]


def _scalar_seed(seed):
    """A seed as ``prng.uniform_bits`` takes it: a Python int, or a
    one-element int tensor viewed as a scalar."""
    return seed.reshape(()) if isinstance(seed, torch.Tensor) else seed


def zo_perturb_ref(theta: torch.Tensor, seed, salt: int, scale: float,
                   offset: int = 0, index=None) -> torch.Tensor:
    """theta + scale * z with z over the flat index ``offset + i``
    (``repro/kernels/ref.py::zo_perturb_ref``; offset lets a caller check
    a large leaf chunk by chunk), or at ``index``'s indices (a rank's
    shard's ``prng.IndexMap``). seed: a Python int or a one-element int
    tensor holding the uint32 seed; scale is rounded to f32."""
    flat = theta.reshape(-1)
    z = prng.normal(_scalar_seed(seed), salt, flat.shape, offset,
                    device=theta.device, index=index)
    out = flat.to(torch.float32) + float(np.float32(scale)) * z
    return out.reshape(theta.shape).to(theta.dtype)


def zo_fused_replay_ref(theta: torch.Tensor, seeds: torch.Tensor,
                        coeffs: torch.Tensor, salt: int,
                        offset: int = 0, index=None) -> torch.Tensor:
    """S steps of P (seed, coeff) records on one leaf
    (``repro/kernels/ref.py::zo_fused_replay_ref``): per step, sum
    coeff * z in probe order in f32 starting from 0, subtract once, cast
    to the leaf dtype; the next step starts from the cast value. seeds
    int [S, P] (uint32 values), coeffs f32 [S, P]. Separate eager mul and
    add kernels, so no FMA contraction; S single steps equal one S-step
    call bitwise. z over the flat index ``offset + i``, or at ``index``'s
    indices (a rank's shard's ``prng.IndexMap``)."""
    S, P = seeds.shape
    shape, dtype = theta.shape, theta.dtype
    n = theta.numel()
    x = theta.reshape(-1).to(torch.float32)
    for s in range(S):
        inner = torch.zeros_like(x)
        for p in range(P):
            z = prng.normal(seeds[s, p], salt, (n,), offset,
                            device=theta.device, index=index)
            inner = inner + coeffs[s, p] * z
        x = (x - inner).to(dtype).to(torch.float32)
    return x.reshape(shape).to(dtype)


def int8_perturb_ref(theta: torch.Tensor, seed, salt: int, k: int,
                     r_max: int, p_zero, offset: int = 0) -> torch.Tensor:
    """Alg. 2 perturbation of an int8 leaf, clamp(theta + k * z, -127, 127)
    with z over the flat index ``offset + i``
    (``repro/kernels/ref.py::int8_perturb_ref``)."""
    from ..core.int8 import int8_noise
    z = int8_noise(_scalar_seed(seed), salt, (theta.numel(),), r_max, p_zero,
                   offset, device=theta.device)
    out = torch.clamp(theta.reshape(-1).to(torch.int32) + int(k) * z,
                      -127, 127)
    return out.to(torch.int8).reshape(theta.shape)


def zo_fused_replay_int8_ref(theta: torch.Tensor, seeds: torch.Tensor,
                             gs: torch.Tensor, salt: int, r_max: int, p_zero,
                             shift: int, offset: int = 0) -> torch.Tensor:
    """S steps of P (seed, ternary g) records on one int8 leaf
    (``repro/kernels/ref.py::zo_fused_replay_int8_ref``): per step, sum
    psr(g * z, shift) in int32 in probe order, subtract once, clamp once
    to [-127, 127]. seeds int [S, P] (uint32 values), gs int [S, P]."""
    from ..core.int8 import int8_noise, psr_shift
    S, P = seeds.shape
    n = theta.numel()
    x = theta.reshape(-1).to(torch.int32)
    for s in range(S):
        acc = torch.zeros_like(x)
        for p in range(P):
            z = int8_noise(seeds[s, p], salt, (n,), r_max, p_zero, offset,
                           device=theta.device)
            acc = acc + psr_shift(gs[s, p].to(torch.int32) * z, shift)
        x = torch.clamp(x - acc, -127, 127)
    return x.to(torch.int8).reshape(theta.shape)


def int8_matmul_ref(a: torch.Tensor, w: torch.Tensor):
    """a [M,K] int8, w [K,N] int8 -> (out int32 [M,N], max|out| int32 0-d)
    (``repro/kernels/ref.py::int8_matmul_ref``). The product is taken in
    float64, which holds every partial sum exactly while K * 127^2 < 2^53,
    and runs on the card, where PyTorch has no integer product."""
    out = (a.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    if out.numel() == 0:
        return out, torch.zeros((), dtype=torch.int32, device=out.device)
    return out, out.abs().amax()
