"""Serving-engine configuration (repro_torch/serve/).

Sizing contract: the paged pool must be able to hold at least one
worst-case sequence (``ceil((max_seq_len + 1) / page_size)`` pages) or the
scheduler could deadlock; ``Engine`` validates this at construction and
``Scheduler.submit`` rejects requests that can never fit.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ServeConfig:
    page_size: int = 16          # tokens per KV page
    num_pages: int = 256         # pool pages per layer (page 0 = null page)
    max_batch_slots: int = 8     # decode batch width (continuous batching)
    max_seq_len: int = 512       # hard cap: prompt + generated (+ img tokens)
    max_new_tokens: int = 64     # default per-request generation budget
    bucket_prompts: bool = False  # pow2 prompt-length bucketing (attn-only
    #                               archs; SSM state would absorb pad tokens)
    eos_id: int = -1             # -1: never stop early
    megastep: int = 32           # max decode ticks fused into one device
    #                              call while the plan is provably steady
    #                              (Scheduler.steady_horizon); 1 disables

    @property
    def max_pages_per_seq(self) -> int:
        return -(-(self.max_seq_len + 1) // self.page_size)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold `tokens` cache entries."""
        return -(-tokens // self.page_size)
