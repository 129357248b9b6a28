"""Logical-axis sharding rules with divisibility fallbacks.

The port of ``repro/sharding/rules.py``, line for line over (axis names,
axis sizes): a ``ShardingRules`` binds a mesh (an ``AbstractMesh``, a
``DeviceMesh``, or ``None`` for one device) to an architecture and
decides, at config time:

- the attention TP plan: ``tp`` (heads sharded, KV heads duplicated to the
  TP degree, Q heads activation-padded if needed) or ``seq`` (weights
  replicated over ``model``, sequence sharded inside attention);
- the MoE plan: ``ep`` (experts sharded over ``model``) or ``tp`` (every
  rank holds a d_ff/tp slice of all experts);
- per-logical-axis mesh axes.

A spec is a tuple of mesh axis names (or None, or a tuple of names) per
dim, as the JAX package's ``PartitionSpec`` holds them. The JAX
package's ``ns`` / ``wsc`` have no counterpart: placement in the port is
explicit (``sharding/params.py``, ``sharding/collectives.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig, pad_to
from ..launch.mesh import axis_shape

# Max acceptable attention-flop inflation from Q-head padding before we
# fall back to sequence-sharded attention.
PAD_WASTE_LIMIT = 0.15


@dataclass(frozen=True)
class AttnPlan:
    kind: str            # "tp" | "seq"
    kv_dup: int = 1      # KV head duplication factor (tp plan)
    q_pad: int = 0       # extra padded Q heads (activation-level, tp plan)

    @property
    def padded_heads(self) -> int:
        return self.q_pad


def choose_attn_plan(cfg: ModelConfig, tp: int) -> AttnPlan:
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if tp == 1:
        return AttnPlan("tp", kv_dup=1, q_pad=0)
    qh = pad_to(H, tp)
    waste = qh / H - 1.0
    if qh % tp == 0 and waste <= PAD_WASTE_LIMIT:
        if KV % tp == 0:
            return AttnPlan("tp", kv_dup=1, q_pad=qh - H)
        if tp % KV == 0:
            return AttnPlan("tp", kv_dup=tp // KV, q_pad=qh - H)
    return AttnPlan("seq")


def choose_moe_plan(cfg: ModelConfig, tp: int) -> str:
    if cfg.num_experts and tp > 1 and cfg.num_experts % tp == 0:
        return "ep"
    return "tp"          # d_ff sharded; all experts resident per rank


def axes_size(sizes, axes) -> int:
    """The product of the sizes of ``axes`` (a name or a tuple of names)
    in ``sizes`` ({name: size})."""
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


class ShardingRules:
    """Binds (mesh, arch, shape, strategy) -> specs.

    strategy:
      "tp"    — Megatron TP over `model` + FSDP storage over `data`.
      "fsdp"  — ZeRO-3: batch over BOTH axes, no tensor-parallel
                activation collectives; weights stay 2D-sharded for
                storage and are all-gathered per layer.
      "serve" — inference: weights TP over `model`, *replicated* over
                `data`; attention switched to the seq plan at decode so
                the KV cache context-shards over `model`.
    """

    def __init__(self, mesh, cfg: ModelConfig,
                 shape: Optional[ShapeConfig] = None,
                 strategy: str = "tp"):
        self.mesh = mesh
        self.cfg = cfg
        self.shape = shape
        self.strategy = strategy
        if mesh is not None:
            sizes = axis_shape(mesh)
            self.sizes = sizes
            names = tuple(sizes)
            batch: Tuple[str, ...] = tuple(
                n for n in ("pod", "data") if n in names)
            self.model_axis = "model" if "model" in names else None
            tp = sizes["model"] if self.model_axis else 1
            self.fsdp_axis = "data" if "data" in names else None
            if strategy == "fsdp":
                # data parallelism over every axis; no TP compute sharding
                if self.model_axis and (shape is None or
                                        shape.global_batch % (tp * max(
                                            1, axes_size(sizes, batch))) == 0):
                    batch = batch + (self.model_axis,)
                self.model_compute = None
            elif strategy == "serve":
                self.fsdp_axis = None          # replicate weights over data
                self.model_compute = self.model_axis
            else:
                self.model_compute = self.model_axis
            self.batch_axes = batch
        else:
            self.sizes = {}
            self.batch_axes = ()
            self.model_axis = None
            self.model_compute = None
            self.fsdp_axis = None
            tp = 1
        self.tp = tp if strategy != "fsdp" else 1
        self.attn = choose_attn_plan(cfg, self.tp)
        if strategy == "serve" and shape is not None and shape.kind == "decode":
            # context-parallel KV cache; no KV-head duplication
            self.attn = AttnPlan("seq")
        # MoE: expert parallelism uses the *model* axis even in the fsdp
        # lane (EP+DP: dispatch all-to-all instead of expert weight gathers)
        self.moe = choose_moe_plan(cfg, tp)
        # Long-context decode (global_batch < data size): shard cache seq
        # over the data axis (context parallelism).
        self.cache_seq_axes: Tuple[str, ...] = ()
        if (shape is not None and mesh is not None
                and shape.kind == "decode"):
            dsize = 1
            for a in self.batch_axes:
                dsize *= self.sizes[a]
            if shape.global_batch < dsize:
                self.cache_seq_axes = self.batch_axes

    # -- common specs --------------------------------------------------- #
    @property
    def batch(self):                      # logical "batch"
        return tuple(self.batch_axes) if self.batch_axes else None

    @property
    def model(self):
        """Mesh axis for TP *compute* sharding (None in the fsdp lane)."""
        return self.model_compute

    @property
    def wmodel(self):
        """Mesh axis for the TP dim of weight *storage* (always set)."""
        return self.model_axis

    @property
    def fsdp(self):
        return self.fsdp_axis

    @property
    def batch_nomodel(self):
        """Batch axes minus the model axis (for EP dispatch constraints
        where the expert dim occupies `model`)."""
        axes = tuple(a for a in self.batch_axes if a != self.model_axis)
        return axes if axes else None

    # -- parameter specs ------------------------------------------------- #
    # Weights are FSDP-sharded over `data` on one non-TP dim and
    # TP-sharded over `model`. `stacked` prepends the layer-stack dim
    # (never sharded).
    def spec_embed(self):                 # [V, D]
        return (self.wmodel, self.fsdp)

    def spec_unembed(self):               # [D, V]
        return (self.fsdp, self.wmodel)

    def spec_attn_qkv(self):              # [D, H, Dh] / [D, KV, Dh]
        if self.attn.kind == "tp" and self.model is not None:
            return (self.fsdp, self.model, None)
        return (self.fsdp, self.wmodel if self.strategy == "fsdp" else None,
                None)

    def spec_attn_o(self):                # [H, Dh, D]
        if self.attn.kind == "tp" and self.model is not None:
            return (self.model, None, self.fsdp)
        return (self.wmodel if self.strategy == "fsdp" else None, None,
                self.fsdp)

    def spec_mlp_in(self):                # [D, F]
        return (self.fsdp, self.wmodel)

    def spec_mlp_out(self):               # [F, D]
        return (self.wmodel, self.fsdp)

    def spec_moe_in(self):                # [E, D, F]
        if self.moe == "ep":
            return (self.wmodel, self.fsdp, None)
        return (None, self.fsdp, self.wmodel)

    def spec_moe_out(self):               # [E, F, D]
        if self.moe == "ep":
            return (self.wmodel, None, self.fsdp)
        return (None, self.wmodel, self.fsdp)

    def spec_router(self):                # [D, E]
        return (self.fsdp, None)

    def spec_ssm_inner(self):             # mamba [D, 2*d_inner] etc.
        return (self.fsdp, self.wmodel)

    def spec_ssm_inner_t(self):           # [d_inner, D]
        return (self.wmodel, self.fsdp)

    def spec_vec(self):                   # [D]-shaped (norm scales)
        return (None,)

    def spec_vec_inner(self):             # [d_inner]
        return (self.model,)

    # -- KV-cache specs --------------------------------------------------- #
    def spec_kv_cache(self):
        # [layers, B, S, KV*dup, Dh]
        seq = self.cache_seq_axes if self.cache_seq_axes else None
        if self.attn.kind == "tp":
            return (None, self.batch, seq, self.model, None)
        return (None, self.batch, self.model if not seq else seq, None, None)

    def spec_ssm_cache(self):
        # mamba: [layers, B, d_inner, N]; rwkv: [layers, B, H, Dk, Dv]
        return (None, self.batch, self.model, None)

    def spec_rwkv_cache(self):
        return (None, self.batch, self.model, None, None)

    def spec_conv_cache(self):
        # [layers, B, conv_w-1, d_inner]
        return (None, self.batch, None, self.model)
