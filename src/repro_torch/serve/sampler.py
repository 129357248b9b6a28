"""Batched temperature / top-k / top-p sampling with per-request seeds.

The port of ``repro/serve/sampler.py``. Randomness comes from the
counter-based hash of ``core/prng.py``, keyed on (request seed, sample
index), bitwise the JAX package's bits: a request resampled with the
same seed reproduces its stream token for token, whatever batch slots it
shared. ``temperature <= 0`` rows take the greedy argmax.

``sample_tokens`` filters through the sort-free selector
(``kernels/ops.py`` ``topk_topp_mask``: the CUDA kernel on the card, the
plain version on the CPU). ``sample_tokens_reference`` keeps the
full-sort pipeline as the semantic oracle.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import prng
from ..kernels import ops

NEG_INF = -1e30
_SALT_GUMBEL = 0x5E17E_1
_STEP_MIX = 2654435761                 # Knuth multiplicative hash


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0             # 0 => greedy
    top_k: int = 0                       # 0 => disabled
    top_p: float = 1.0                   # 1 => disabled
    seed: int = 0


def greedy_tokens(logits):
    """argmax over the vocab axis (the first index on ties)."""
    return logits.argmax(dim=-1).to(torch.int32)


def _top_k_mask(logits, k):
    """Keep the k largest per row; k[b] <= 0 disables the filter."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = (k.to(torch.int64) - 1).clamp(0, V - 1)
    thresh = sorted_desc.gather(-1, idx[:, None])
    keep = (logits >= thresh) | (k <= 0)[:, None]
    return torch.where(keep, logits, NEG_INF)


def _top_p_mask(logits, p):
    """Nucleus filter; p[b] >= 1 disables. Always keeps the argmax."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(logits.gather(-1, order), dim=-1)
    keep_sorted = (probs.cumsum(-1) - probs) < p[:, None]
    keep = keep_sorted.gather(-1, torch.argsort(order, dim=-1))
    keep |= (p >= 1.0)[:, None]
    return torch.where(keep, logits, NEG_INF)


def _gumbel_noise(seed, step, V):
    """Per-row Gumbel(0, 1) stream keyed on (request seed, sample index).
    seed: [B] uint32 values in int64; step: [B] int."""
    row_seed = (seed.to(torch.int64) & prng.MASK32) ^ prng.mul32(
        step.to(torch.int64) & prng.MASK32, _STEP_MIX)
    bits = prng.uniform_bits(row_seed, _SALT_GUMBEL, (V,))
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25   # (0, 1]
    return -torch.log(-torch.log(u))


def _sample(logits, temperature, top_k, top_p, seed, step, vocab_size,
            filter_fn):
    V = logits.shape[1]
    greedy = greedy_tokens(logits)
    masked = logits
    if 0 < vocab_size < V:
        masked = torch.where(
            torch.arange(V, device=logits.device) < vocab_size, masked,
            NEG_INF)
    # temperature FIRST, filters on the actual sampling distribution
    t = temperature.clamp_min(1e-6)[:, None]
    masked = filter_fn(masked / t, top_k, top_p)
    g = _gumbel_noise(seed, step, V)
    sampled = (masked + g).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def sample_tokens(logits, temperature, top_k, top_p, seed, step,
                  vocab_size: int = 0):
    """logits [B, V] f32; per-row knobs [B] -> tokens [B] int32.

    seed: request seeds (uint32 values); step: per-request sample index.
    vocab_size > 0 masks the padded-vocab columns [vocab_size, V) out of
    the sampled branch; greedy stays unmasked.
    """
    return _sample(logits, temperature, top_k, top_p, seed, step,
                   vocab_size, ops.topk_topp_mask)


def sample_tokens_reference(logits, temperature, top_k, top_p, seed, step,
                            vocab_size: int = 0):
    """Full-sort oracle for ``sample_tokens``: the same Gumbel stream and
    greedy branch, filters via sort/argsort."""
    return _sample(logits, temperature, top_k, top_p, seed, step,
                   vocab_size,
                   lambda x, k, p: _top_p_mask(_top_k_mask(x, k), p))
