"""Elastic resume: training state is (params checkpoint, step).

The port of ``repro/train/elastic_runtime.py``. The contract
(docs/design.md §8):
  1. training state = (params checkpoint, step); data state = step;
  2. ZO noise is a pure function of (seed, step, global flat index)
     (``core/prng.py``), the same on any device count;
  3. checkpoints restore onto whatever devices exist now.

``resume_on_mesh`` packages this: given a checkpoint directory it builds
the step function and returns a state that continues bitwise where the
saved run stopped. This port runs on one device: ``mesh`` must be None,
and any other raises ``NotImplementedError`` until the port's
distribution slice (ROADMAP) brings sharding and ``--mesh``.

The port labels a checkpoint with the number of steps its params hold
(``train/train_loop.py``), so a resume from a checkpoint this package
wrote continues bitwise. The JAX train loop labels its periodic
checkpoints one step early (its ``step_<N>`` holds N + 1 steps), so a
resume from one of those runs one step twice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from ..configs.base import LaneConfig, ModelConfig, ShapeConfig
from ..core import api, keys
from ..core.elastic import TrainState
from ..core.engine import Fp32Engine
from . import checkpoint as ckpt
from .train_loop import init_state


class TrainModel(NamedTuple):
    """What a step is built from: ``engine.make_step(loss_fn)`` (and
    ``core/engine.py::profile_step_phases(engine, loss_fn, ...)``)."""
    engine: Fp32Engine
    loss_fn: Callable


def _single_device(mesh, strategy: str):
    if mesh is not None or strategy != "tp":
        raise NotImplementedError(
            "the port runs on one device: a mesh and its sharding strategy "
            "wait for its distribution slice (ROADMAP.md, sharding and "
            "--mesh)")


def build_for_mesh(cfg: ModelConfig, shape: ShapeConfig, lane: LaneConfig,
                   mesh=None, strategy: str = "tp"
                   ) -> Tuple[TrainModel, Callable]:
    """(model, step) of ``lane`` for ``cfg``; ``mesh`` must be None and
    ``strategy`` its default, or this raises ``NotImplementedError``.
    ``shape`` is the reference's signature and unused here (it sizes a
    learned ``pos_embed`` in ``resume_on_mesh``)."""
    _single_device(mesh, strategy)
    engine, loss_fn = api.train_engine(cfg, lane)
    return TrainModel(engine, loss_fn), engine.make_step(loss_fn)


def resume_on_mesh(ckpt_dir, cfg: ModelConfig, shape: ShapeConfig,
                   lane: LaneConfig, mesh=None, seed: int = 0,
                   strategy: str = "tp", device=None
                   ) -> Tuple[TrainState, TrainModel, Callable]:
    """Restore the newest checkpoint under ``ckpt_dir`` onto ``device``
    (the card unless the caller passes another), at its step; without
    one (or with ``ckpt_dir`` None) a fresh init from ``seed``. The key
    data comes from ``seed`` either way. Returns (state, model, step).

    The checkpoint is read into a template of shapes only
    (``api.abstract_params``): no full init is drawn and then
    overwritten, so the device holds one copy of the params."""
    model, step = build_for_mesh(cfg, shape, lane, mesh, strategy)
    dev = api.resolve_device(device)
    last: Optional[int] = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if last is None:
        params = api.init(cfg, lane, seed=seed, device=dev,
                          max_seq=shape.seq_len)
        return init_state(params, seed), model, step
    template = api.abstract_params(cfg, lane, max_seq=shape.seq_len)
    params, at_step = ckpt.restore(ckpt_dir, template, step=last, device=dev)
    return TrainState(params, at_step, keys.key_data(seed)), model, step
