"""NITI-style int8 training substrate (ElasticZO-INT8, Alg. 2).

The port of ``repro/core/int8.py``. Tensors are ``QTensor``s: int8 data
and an int32 exponent, representing ``data * 2^exp``. Products accumulate
in int32 through the hand-written ``int8_matmul`` kernel
(``kernels/ops.py``), activations are rescaled back to 8 bits with NITI's
dynamic-bitwidth rule, and updates use pseudo-stochastic rounding, where
the discarded low bits of the value itself are the randomness.

The contract is bitwise agreement with the JAX package. Three things make
integer arithmetic in PyTorch differ from XLA's unless written with care,
and every function here handles them the same way:

  * values that XLA holds as uint32 are held in int64 in [0, 2**32), so
    right shifts are logical and multiplies wrap (``prng.mul32``);
  * XLA gives 0 for a left or logical right shift by a count outside
    [0, 32), and the sign for an arithmetic one: ``shl`` and ``shr_logical``
    spell that out instead of leaning on the backend;
  * int32 results that may overflow are wrapped with ``wrap32``.

Exponents and shifts stay 0-d device tensors, so no function here makes
the host wait on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import prng, zo

_I64 = torch.int64
_PHI = 0x9E3779B9


class QTensor(NamedTuple):
    data: torch.Tensor          # int8
    exp: torch.Tensor           # int32, 0-d, on data's device


def qtensor(data, exp, device=None) -> QTensor:
    data = torch.as_tensor(data, device=device).to(torch.int8)
    return QTensor(data, torch.as_tensor(exp, device=data.device)
                   .to(torch.int32).reshape(()))


def dequant(q: QTensor) -> torch.Tensor:
    return q.data.to(torch.float32) * torch.exp2(q.exp.to(torch.float32))


def quant_from_float(x: torch.Tensor, bits: int = 7) -> QTensor:
    """fp32 -> QTensor with max-|x| scaling (the init and input path)."""
    m = torch.clamp(x.abs().amax(), min=1e-30)
    exp = torch.ceil(torch.log2(m)) - bits
    data = torch.clamp(torch.round(x / torch.exp2(exp)), -127, 127)
    return QTensor(data.to(torch.int8), exp.to(torch.int32))


# ------------------------------------------------------------------ #
# XLA's integer semantics on int64 tensors
# ------------------------------------------------------------------ #
def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    return ((v + 2**31) & prng.MASK32) - 2**31


def _count(s, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(s, device=like.device).to(_I64)


def shl(x: torch.Tensor, s) -> torch.Tensor:
    """int32 left shift (wrapping), 0 for a count outside [0, 32)."""
    s = _count(s, x)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, wrap32(x << s.clamp(0, 31)), 0)


def shr_logical(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of uint32 values held in int64, 0 for a count
    outside [0, 32)."""
    s = _count(s, x)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, x >> s.clamp(0, 31), 0)


def shr_arith(x: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic right shift of int32 values held in int64; a count of
    32 or more gives the sign (0 or -1), as XLA does."""
    return x >> _count(s, x).clamp(0, 31)


# ------------------------------------------------------------------ #
# pseudo-stochastic rounding (NITI §IV): the bits below the cut are the
# randomness; E[psr(x, s)] = x / 2^s.
# ------------------------------------------------------------------ #
def psr_shift(x: torch.Tensor, s) -> torch.Tensor:
    """Round x (int32) right by s bits, pseudo-stochastically. s: an int
    or a 0-d int tensor; every count is taken as XLA takes it (for
    s = 0 the threshold shift is 32 and gives 0; for s >= 32 the base is
    0 and the result is sign(x) * (|x| > thresh)). Every intermediate is
    the int32 value XLA holds, so |INT_MIN| stays INT_MIN."""
    s = _count(s, x)
    x = x.to(_I64)
    mag = wrap32(x.abs())
    base = wrap32(shr_logical(mag & prng.MASK32, s))
    rem = wrap32(mag - shl(base, s))
    h = prng.mul32(rem & prng.MASK32, _PHI) ^ (mag & prng.MASK32)
    h = h ^ (h >> 16)
    thresh = wrap32(shr_logical(h, (32 - s) & prng.MASK32))
    out = torch.where(s > 0, wrap32(base + (thresh < rem).to(_I64)), mag)
    return wrap32(torch.sign(x) * out).to(torch.int32)


def bitwidth(x_max: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x_max, 1))) + 1 as int32: the exponent field of the
    float64 value, exact for every int32 (JAX sums 31 compares)."""
    x = x_max.to(_I64).clamp(min=1).to(torch.float64)
    return ((x.view(_I64) >> 52) - 1022).to(torch.int32)


def rescale_int32(acc: torch.Tensor, exp: torch.Tensor,
                  maxabs: torch.Tensor | None = None) -> QTensor:
    """NITI forward rescale: int32 accumulator -> int8 + adjusted exponent.
    ``maxabs`` is max|acc| when the product's epilogue already has it."""
    if maxabs is None:
        maxabs = acc.abs().amax()
    shift = torch.clamp(bitwidth(maxabs) - 7, min=0)
    data = torch.clamp(psr_shift(acc, shift), -127, 127).to(torch.int8)
    return QTensor(data, exp + shift)


# ------------------------------------------------------------------ #
# int8 compute ops: every product goes through ``ops.int8_matmul``
# ------------------------------------------------------------------ #
def int8_matmul(a: torch.Tensor, w: torch.Tensor):
    """int8 a [..., K] x int8 w [K, N] -> (int32 [..., N], max|acc|)."""
    lead = a.shape[:-1]
    out, mx = ops.int8_matmul(a.reshape(-1, a.shape[-1]).contiguous(),
                              w.contiguous())
    return out.reshape(*lead, w.shape[1]), mx


def qdense(x: QTensor, w: QTensor) -> QTensor:
    acc, mx = int8_matmul(x.data, w.data)
    return rescale_int32(acc, x.exp + w.exp, mx)


def qconv2d(x: QTensor, w: QTensor, stride: int = 1) -> QTensor:
    """int8 conv via im2col (kh * kw strided slices, as the JAX package
    builds it) and one int8 product. x: [B,H,W,C]; w: [kh,kw,C,O]."""
    kh, kw, C, O = w.data.shape
    B, H, W, _ = x.data.shape
    Ho, Wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    patches = [x.data[:, i:i + Ho * stride:stride, j:j + Wo * stride:stride]
               for i in range(kh) for j in range(kw)]
    col = torch.stack(patches, dim=3).reshape(B, Ho, Wo, kh * kw * C)
    acc, mx = int8_matmul(col, w.data.reshape(kh * kw * C, O))
    return rescale_int32(acc, x.exp + w.exp, mx)


def qrelu(x: QTensor) -> QTensor:
    return QTensor(x.data.clamp_min(0), x.exp)


def qmaxpool2(x: QTensor) -> QTensor:
    """2x2 max-pool as a reshape and ``amax`` (which takes int8 on every
    device)."""
    B, H, W, C = x.data.shape
    d = x.data.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
    return QTensor(d, x.exp)


def qglobal_maxpool(x: QTensor, axis: int = 1) -> QTensor:
    return QTensor(x.data.amax(dim=axis), x.exp)


# ------------------------------------------------------------------ #
# ZO perturbation / update (Alg. 2 lines 12-24)
# ------------------------------------------------------------------ #
def keep_threshold(p_zero) -> float:
    """The keep test's f32 threshold (1 - p_zero) * 2^32, rounded in
    float32 as the JAX package computes it."""
    f = np.float32
    return float((f(1) - f(p_zero)) * f(2.0 ** 32))


def int8_noise(seed, salt: int, shape, r_max: int, p_zero,
               offset: int = 0, *, device=None) -> torch.Tensor:
    """Sparse uniform int8 perturbation z = m (.) u (int32), replayable
    from (seed, salt, flat index ``offset + i``): u = bits_u mod (2r+1) -
    r, m = float32(bits_m) < (1 - p_zero) * 2^32. seed: a Python int or
    an int tensor holding the uint32 seed."""
    bits_u = prng.uniform_bits(seed, 3 * int(salt) + 1, shape, offset,
                               device=device)
    bits_m = prng.uniform_bits(seed, 3 * int(salt) + 2, shape, offset,
                               device=device)
    u = bits_u % (2 * int(r_max) + 1) - int(r_max)
    keep = bits_m.to(torch.float32) < keep_threshold(p_zero)
    return (u * keep).to(torch.int32)


def _q_leaves(params):
    """(salts, int8 data) of the QTensor leaves of a nested dict, in
    order."""
    qs = [(path, leaf) for path, leaf in zo.leaves_with_path(params)
          if isinstance(leaf, QTensor)]
    return [zo.path_salt(p) for p, _ in qs], [leaf.data for _, leaf in qs]


def _with_data(params, datas):
    """``params`` with its QTensor leaves' data replaced, in order."""
    it = iter(datas)
    return zo.map_with_path(
        lambda path, leaf: QTensor(next(it), leaf.exp)
        if isinstance(leaf, QTensor) else leaf, params)


def perturb_int8(params, seed: torch.Tensor, k: int, r_max: int, p_zero):
    """theta <- clamp(theta + k*z, -127, 127) on every QTensor leaf, out of
    place: one ``int8_perturb`` launch for the whole tree. seed: int32 [1]
    on the leaves' device."""
    salts, datas = _q_leaves(params)
    return _with_data(params, ops.int8_perturb_leaves(datas, seed, salts, k,
                                                      r_max, p_zero))


def zo_shift(r_max: int, b_zo: int) -> int:
    """Alg. 2's update shift max(bitwidth(r_max) - b_zo, 0), on the host."""
    return max(int(r_max).bit_length() - int(b_zo), 0)


def replay_int8(params, seeds: torch.Tensor, gs: torch.Tensor, r_max: int,
                p_zero, shift: int, *, in_place: bool = False):
    """S steps x P probes of (seed, g) records on every QTensor leaf: one
    ``zo_fused_replay_int8`` launch for the whole tree. seeds and gs int32
    [S, P] on the leaves' device. In place (returns ``params``) or out of
    place."""
    salts, datas = _q_leaves(params)
    new = ops.zo_fused_replay_int8_leaves(datas, seeds, gs, salts, r_max,
                                          p_zero, shift,
                                          outs=datas if in_place else None)
    return params if in_place else _with_data(params, new)


def zo_update_int8(params, seed: torch.Tensor, g: torch.Tensor, r_max: int,
                   p_zero, b_zo: int):
    """theta <- clamp(theta - psr(g*z, shift), -127, 127) (Alg. 2 lines
    23-24), out of place: a one-record ``replay_int8``. seed: int32 [1];
    g: int32 0-d or [1], both on the leaves' device."""
    return replay_int8(params, seed.reshape(1, 1),
                       g.to(torch.int32).reshape(1, 1), r_max, p_zero,
                       zo_shift(r_max, b_zo))


# ------------------------------------------------------------------ #
# int8 backward for FC tails (NITI backward, ElasticZO-INT8's BP part)
# ------------------------------------------------------------------ #
def output_error_int8(logits: QTensor, labels: torch.Tensor) -> torch.Tensor:
    """e_L ~ 127 * (softmax - onehot) in [-127, 127] (int32), from the
    loss's integer pseudo-probabilities."""
    from .int_loss import pow2_scores
    scores = pow2_scores(logits).to(_I64)       # [B, C], <= 2^10
    tot = scores.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(labels.to(_I64),
                                         logits.data.shape[-1])
    e = torch.div(127 * scores, tot.clamp(min=1),
                  rounding_mode="floor") - 127 * onehot
    return torch.clamp(e, -127, 127).to(torch.int32)


def fc_backward_int8(w: QTensor, a_in: QTensor, e_out: torch.Tensor,
                     b_bp: int) -> Tuple[QTensor, torch.Tensor]:
    """One FC layer's NITI backward: (updated w, e_in int32 in [-127, 127]).

    g = a_in^T e_out and e_in = e_out w^T are both ``int8_matmul``
    launches on transposed contiguous copies (e_out is clipped to +-127,
    so its int8 cast is exact); their bit-widths come from the kernel's
    epilogue max. g is rounded to b_bp bits and applied in the weight's
    own scale (the exponent stays)."""
    e8 = e_out.to(torch.int8)
    g, g_max = ops.int8_matmul(a_in.data.t().contiguous(), e8.contiguous())
    shift = torch.clamp(bitwidth(g_max) - b_bp, min=0)
    upd = psr_shift(g, shift)
    new_w = QTensor(torch.clamp(w.data.to(torch.int32) - upd, -127, 127)
                    .to(torch.int8), w.exp)
    e_in, e_max = ops.int8_matmul(e8.contiguous(), w.data.t().contiguous())
    e_in = psr_shift(e_in, torch.clamp(bitwidth(e_max) - 7, min=0))
    return new_w, torch.clamp(e_in, -127, 127)
