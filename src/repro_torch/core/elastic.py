"""ElasticZO (Alg. 1): ZO for the first C layers, BP for the rest.

The port of ``repro/core/elastic.py``. The LM parameter tree stores the
layer stack as two period stacks, ``periods_zo`` (first P-K periods) and
``periods_bp`` (last K periods). Lanes assign top-level groups:

  elastic_zo : ZO = {embed, pos_embed, encoder, periods_zo}
               BP = {periods_bp, final_norm, unembed}
  full_zo    : ZO = everything            (paper baseline, C = L)
  full_bp    : BP = everything            (paper baseline, C = 0)

The BP-tail gradient is taken at the perturbed points and averaged
(``bp_grad_mode="clean"`` takes it at theta with a third forward; the
fused probe pair takes the gradient of the mean of the two losses). The
step itself is built by ``core/engine.py::Fp32Engine``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np

from ..configs.base import LaneConfig
from .engine import Fp32Engine

ZO_GROUPS = ("embed", "pos_embed", "encoder", "periods_zo")
BP_GROUPS = ("periods_bp", "final_norm", "unembed")


class TrainState(NamedTuple):
    params: Any
    step: int                  # host step counter
    seed: np.ndarray           # uint32[2] base PRNG key data


def partition(params: Dict[str, Any], lane: LaneConfig):
    """Split the top-level param dict into (zo_part, bp_part)."""
    if lane.lane == "full_bp":
        return {}, dict(params)
    if lane.lane == "full_zo":
        return dict(params), {}
    zo_part = {k: v for k, v in params.items() if k in ZO_GROUPS}
    bp_part = {k: v for k, v in params.items() if k in BP_GROUPS}
    leftover = set(params) - set(zo_part) - set(bp_part)
    if leftover:
        raise ValueError(f"unpartitioned param groups: {sorted(leftover)}")
    return zo_part, bp_part


def merge(zo_part, bp_part):
    return {**zo_part, **bp_part}


def make_elastic_step(loss_fn: Callable[[Any, Any], Any], lane: LaneConfig,
                      partition_fn: Optional[Callable] = None,
                      paired_loss_fn: Optional[Callable] = None):
    """Build the ElasticZO train step (fp32 numerics).

    loss_fn(params, batch) -> f32 scalar tensor. partition_fn(params) ->
    (zo_part, bp_part); defaults to the LM top-level-group partition.
    paired_loss_fn(bp_part, zo_part, batch, seed) -> (l+, l-), the fused
    antithetic pair, used for lanes with a BP tail.
    Returned step: (state, batch, probe_mask) -> (state, metrics).
    """
    return Fp32Engine(lane, partition_fn,
                      paired_loss_fn=paired_loss_fn).make_step(loss_fn)
