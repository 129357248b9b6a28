"""ElasticZO-INT8 train step (Alg. 2): integer-only hybrid ZO/BP training.

The port of ``repro/core/elastic_int8.py``. Works on any model exposing
``forward(params, x QTensor) -> (logits QTensor, acts)`` whose BP tail is
FC layers (the paper's ZO-Feat-Cls1/2 put only the last 1-2 FC layers in
the BP part).

``loss_mode``:
  "int"   -- ternary g = sgn(L+ - L-) from integer logits (INT8*, Eqs. 7-12)
  "float" -- g = sgn of the fp32 loss difference (the paper's INT8 column)

The step is built by ``core/engine.py::Int8Engine``.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ..configs.base import LaneConfig
from .engine import Int8Engine
from .int8 import QTensor


def make_int8_elastic_step(forward: Callable, partition_fn: Callable,
                           tail_fcs: List[Tuple[str, str]],
                           lane: LaneConfig, loss_mode: str = "int",
                           p_zero: float | None = None):
    """tail_fcs: [(layer_name, act_key)] in forward order, e.g.
    [("fc2", "fc2_in"), ("fc3", "fc3_in")] -- the BP part."""
    return Int8Engine(lane, partition_fn, tail_fcs=tail_fcs,
                      loss_mode=loss_mode, p_zero=p_zero).make_step(forward)


def int8_eval(forward: Callable, params, x: QTensor, y) -> torch.Tensor:
    """Accuracy (f32 0-d tensor). A tie between int8 logits goes to the
    first maximum, as ``jnp.argmax`` takes it."""
    logits, _ = forward(params, x)
    return (logits.data.argmax(-1) == y).to(torch.float32).mean()
