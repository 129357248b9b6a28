"""Config dataclasses for models, shapes and training lanes.

A copy of ``repro/configs/base.py`` (the port imports nothing of the JAX
package). Every architecture is a ``ModelConfig``; ``reduced`` gives the
tiny same-family config the CPU tests use.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds used in ``block_pattern`` (one period of the layer stack).
ATTN = "attn"
MAMBA = "mamba"
RWKV = "rwkv"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # -- attention details --
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 1_000_000.0
    # -- MoE --
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # -- block pattern: one period; default = all-attention --
    block_pattern: Tuple[str, ...] = ()
    # FFN is MoE when (layer_idx % moe_every) == moe_offset
    moe_every: int = 1
    moe_offset: int = 0
    # -- SSM (mamba / rwkv6) --
    ssm_state_dim: int = 16          # mamba N
    ssm_expand: int = 2              # mamba d_inner = expand * d_model
    ssm_conv_width: int = 4
    rwkv_head_dim: int = 64
    # -- encoder-decoder (whisper) --
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub frontend)
    # -- VLM (llava) --
    num_image_tokens: int = 0        # precomputed patch embeddings (stub frontend)
    # -- misc --
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # long-context capable (sub-quadratic attention path)
    subquadratic: bool = False
    notes: str = ""

    # ---- derived ----
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern if self.block_pattern else (ATTN,)

    @property
    def num_periods(self) -> int:
        p = len(self.pattern)
        if self.num_layers % p:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} is not a "
                f"multiple of the {p}-block pattern")
        return self.num_layers // p

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count."""
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        n = V * d                                    # embed
        if not self.tie_embeddings:
            n += V * d                               # unembed
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        dense_ffn = 3 * d * ff                       # SwiGLU
        if self.is_moe:
            e = self.experts_per_token if active_only else self.num_experts
            moe_ffn = e * 3 * d * ff + d * self.num_experts  # + router
        else:
            moe_ffn = dense_ffn
        d_inner = self.ssm_expand * d
        mamba = (d * 2 * d_inner                     # in_proj (x, z)
                 + d_inner * self.ssm_conv_width     # conv
                 + d_inner * (self.ssm_state_dim * 2 + d // 16)  # B,C,dt proj
                 + (d // 16) * d_inner               # dt up
                 + d_inner * self.ssm_state_dim      # A
                 + d_inner * d)                      # out proj
        rwkv = 5 * d * d + (d * self.d_ff + self.d_ff * d + d * d)
        per_layer = 0
        for li in range(self.num_layers):
            kind = self.pattern[li % len(self.pattern)]
            moe_here = self.is_moe and li % self.moe_every == self.moe_offset
            if kind == ATTN:
                per_layer += attn + (moe_ffn if moe_here else dense_ffn)
            elif kind == MAMBA:
                per_layer += mamba + (moe_ffn if moe_here else dense_ffn)
            elif kind == RWKV:
                per_layer += rwkv
        n += per_layer
        if self.encoder_layers:
            n += self.encoder_layers * (attn + dense_ffn)   # encoder blocks
            n += self.num_layers * attn                     # cross-attention
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    long_context: bool = False


@dataclass(frozen=True)
class LaneConfig:
    """Training-lane hyperparameters (the paper's knobs)."""
    lane: str = "elastic_zo"          # full_bp | full_zo | elastic_zo | elastic_zo_int8
    bp_tail_layers: int = 1           # K;  C = L - K  (paper: last 1-2 FC layers)
    bp_unembed: bool = True           # LM head trained via BP (part of the tail)
    zo_eps: float = 1e-3
    zo_num_probes: int = 1            # antithetic pairs (multi-probe variance reduction)
    zo_clip: float = 100.0            # g-clipping (paper: clip to [-g_clip, g_clip])
    learning_rate: float = 1e-2
    tail_learning_rate: Optional[float] = None
    # the paper's schedule: lr *= factor every `every` steps (0 = constant)
    lr_decay_factor: float = 1.0
    lr_decay_every: int = 0
    bp_grad_mode: str = "avg_perturbed"   # avg_perturbed (Alg.1) | clean (3rd fwd)
    fused_probes: bool = False
    # int8 lane (Alg. 2)
    int8_loss_mode: str = "int"       # int (INT8*, Eq. 7-12) | float (sgn of fp32 diff)
    int8_r_max: int = 3
    int8_p_zero: float = 0.33
    int8_b_zo: int = 1
    int8_b_bp: int = 5
    # distributed
    allow_partial_probes: bool = True
    compress_tail_grads: bool = False


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pattern = cfg.pattern
    small = dict(
        num_layers=len(pattern) if len(pattern) > 1 else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=4 if cfg.num_experts else 0,
        experts_per_token=2 if cfg.num_experts else 0,
        ssm_state_dim=8,
        rwkv_head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        sliding_window=16 if cfg.sliding_window else 0,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
