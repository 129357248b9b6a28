"""Elastic resume: training state is (params checkpoint, step).

The port of ``repro/train/elastic_runtime.py``. The contract
(docs/design.md §8):
  1. training state = (params checkpoint, step); data state = step;
  2. ZO noise is a pure function of (seed, step, global flat index)
     (``core/prng.py``), the same on any device count;
  3. checkpoints restore onto whatever devices exist now.

``resume_on_mesh`` packages this: given a checkpoint directory and a
mesh (a ``launch/mesh.py::make_mesh`` ``DeviceMesh``, or None for one
device) it builds the rules, the shard descriptors and the step function,
and returns a state that continues where the saved run stopped, whatever
mesh saved it: bitwise on the mesh that saved it, within the sharded
reductions' rounding on another. The strategy (``tp``, ``fsdp`` or
``serve``, ``sharding/rules.py``) may differ from the saving run's: the
checkpoint format is mesh-independent, and each rank keeps its slice
under the new specs (of a MoE stack's expert leaves under the ``ep``
plan, its block of E / tp experts in every strategy). Every stack runs
there: the attention stacks, the MoE stacks, RWKV6 and the Mamba /
attention hybrid (Jamba).

The port labels a checkpoint with the number of steps its params hold
(``train/train_loop.py``), so a resume from a checkpoint this package
wrote continues bitwise. The JAX train loop labels its periodic
checkpoints one step early (its ``step_<N>`` holds N + 1 steps), so a
resume from one of those runs one step twice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

from ..configs.base import LaneConfig, ModelConfig, ShapeConfig
from ..core import api, keys
from ..core.elastic import TrainState
from ..core.engine import Fp32Engine
from . import checkpoint as ckpt
from .train_loop import init_state

STRATEGIES = ("tp", "fsdp", "serve")        # sharding/rules.py


class TrainModel(NamedTuple):
    """What a step is built from: ``engine.make_step(loss_fn)`` (and
    ``core/engine.py::profile_step_phases(engine, loss_fn, ...)``);
    ``run``, the ``MeshRun`` of a mesh (None on one device)."""
    engine: Fp32Engine
    loss_fn: Callable
    run: Any = None


def build_for_mesh(cfg: ModelConfig, shape: ShapeConfig, lane: LaneConfig,
                   mesh=None, strategy: str = "tp"
                   ) -> Tuple[TrainModel, Callable]:
    """(model, step) of ``lane`` for ``cfg`` on ``mesh`` (None: one
    device). A mesh binds ``ShardingRules(mesh, cfg, shape, strategy)``
    and the params' specs and shard descriptors (``model.run``). Without
    a mesh every strategy is the one-device step, as the JAX package's
    ``ShardingRules(None, ...)`` is."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: want one of {STRATEGIES}")
    run = api.mesh_run(cfg, shape, lane, mesh, strategy)
    engine, loss_fn = api.train_engine(cfg, lane, run)
    return TrainModel(engine, loss_fn, run), engine.make_step(loss_fn)


def resume_on_mesh(ckpt_dir, cfg: ModelConfig, shape: ShapeConfig,
                   lane: LaneConfig, mesh=None, seed: int = 0,
                   strategy: str = "tp", device=None
                   ) -> Tuple[TrainState, TrainModel, Callable]:
    """Restore the newest checkpoint under ``ckpt_dir`` onto ``device``
    (the card unless the caller passes another; a rank's own device on
    a mesh), at its step; without one (or with ``ckpt_dir`` None) a
    fresh init from ``seed``. The key data comes from ``seed`` either
    way. Returns (state, model, step). On a mesh the params are the
    rank's shards (``model.run.descs``), restored or drawn one leaf at a
    time.

    The checkpoint is read into a template of shapes only
    (``api.abstract_params``): no full init is drawn and then
    overwritten, so the device holds one copy of the params."""
    model, step = build_for_mesh(cfg, shape, lane, mesh, strategy)
    dev = api.resolve_device(device)
    run = model.run
    last: Optional[int] = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if last is None:
        params = api.init(cfg, lane, seed=seed, device=dev,
                          max_seq=shape.seq_len, run=run)
        return init_state(params, seed), model, step
    template = api.abstract_params(cfg, lane, max_seq=shape.seq_len)
    params, at_step = ckpt.restore(ckpt_dir, template, step=last, device=dev,
                                   shardings=None if run is None
                                   else run.descs)
    return TrainState(params, at_step, keys.key_data(seed)), model, step
