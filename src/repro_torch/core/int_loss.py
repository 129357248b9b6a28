"""Integer-arithmetic zeroth-order gradient sign (paper §4.3, Eqs. 7-12).

The port of ``repro/core/int_loss.py``. Given two int8 logit sets
(alpha, s_alpha), (beta, s_beta) and labels, the sign of L(alpha) -
L(beta) is computed with integer operations only:

  1. rescale both to the common exponent s = min(s_a, s_b)       (Eq. 8)
  2. exp(x * 2^s) -> 2^(47274 * x * 2^(s-15))  (log2 e ~ 47274/2^15, Eq. 9)
  3. clamp exponents into a 10-bit window below the pairwise max  (p_max-10)
  4. B=1:  sign(sum_j 2^a~ - sum_j 2^b~)                          (Eq. 10)
     B>1:  sign(sum_b floor(log2 sum_j 2^a~) - ...)               (Eq. 12)

The arithmetic is the JAX package's int32 arithmetic, wrapping included,
held in int64 and wrapped back after every operation that can overflow
(``int8.wrap32``); shifts take XLA's counts (``int8.shl``,
``int8.shr_arith``).
"""
from __future__ import annotations

import torch

from .int8 import QTensor, bitwidth, shl, shr_arith, wrap32

LOG2E_Q15 = 47274          # log2(e) * 2^15
WINDOW = 10                # 2^10 clamp window (paper: p = p_max - 10)

_I64 = torch.int64


def _hat_exponents(logits: QTensor, labels: torch.Tensor,
                   s_common: torch.Tensor) -> torch.Tensor:
    """47274 * (x_j - x_i) * 2^(s-15) as int32 (held in int64) per
    (sample, class)."""
    x = shl(logits.data.to(_I64), logits.exp.to(_I64) - s_common)  # Eq. 8
    xi = torch.gather(x, -1, labels.to(_I64)[:, None])
    t = wrap32(wrap32(x - xi) * LOG2E_Q15)
    k = 15 - s_common.to(_I64)
    # t * 2^(s-15): an arithmetic shift in either direction
    return torch.where(k >= 0, shr_arith(t, k.clamp(min=0)),
                       shl(t, (-k).clamp(min=0)))


def _floor_log2(n: torch.Tensor, maxbits: int = 26) -> torch.Tensor:
    """floor(log2(max(n, 1))), saturating at maxbits - 1 (JAX sums
    maxbits - 1 compares)."""
    return torch.clamp(bitwidth(n) - 1, max=maxbits - 1).to(n.dtype)


def pow2_scores(logits: QTensor) -> torch.Tensor:
    """Integer pseudo-softmax scores 2^(x~) <= 2^10 (int32), shared with
    the int8 backward."""
    x = logits.data.to(_I64)
    t = wrap32((x - x.amax(dim=-1, keepdim=True)) * LOG2E_Q15)
    k = 15 - logits.exp.to(_I64)
    hat = torch.where(k < 0, shl(t, (-k).clamp(min=0)),
                      shr_arith(t, k.clamp(min=0)))
    hat = torch.clamp(wrap32(hat + WINDOW), 0, WINDOW)    # window below max
    return ((1 << hat) * (hat > 0)).to(torch.int32)


def int_loss_sign(alpha: QTensor, beta: QTensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """sgn(L(alpha) - L(beta)) in {-1, 0, +1} (int32 0-d), integer-only."""
    s = torch.minimum(alpha.exp, beta.exp).to(_I64)
    a_hat = _hat_exponents(alpha, labels, s)               # [B, C]
    b_hat = _hat_exponents(beta, labels, s)
    p_max = torch.maximum(a_hat.amax(dim=-1), b_hat.amax(dim=-1))
    p = wrap32(p_max - WINDOW)[:, None]
    a_t = torch.clamp(wrap32(a_hat - p), 0, WINDOW)
    b_t = torch.clamp(wrap32(b_hat - p), 0, WINDOW)
    # keep only terms >= p (clamped-to-zero exponents may still contribute
    # 2^0; the paper accepts this approximation)
    A = (1 << a_t).sum(dim=-1)
    Bv = (1 << b_t).sum(dim=-1)
    if labels.shape[0] == 1:
        diff = A[0] - Bv[0]                                # Eq. 10
    else:
        diff = (_floor_log2(A) - _floor_log2(Bv)).sum()    # Eq. 12
    return torch.sign(diff).to(torch.int32)


def float_loss(logits: QTensor, labels: torch.Tensor) -> torch.Tensor:
    """FP32 CE on dequantized logits (the INT8 column's loss)."""
    x = logits.data.to(torch.float32) * torch.exp2(
        logits.exp.to(torch.float32))
    logz = torch.logsumexp(x, dim=-1)
    ll = torch.gather(x, -1, labels.to(_I64)[:, None])[:, 0]
    return torch.mean(logz - ll)
