"""LM training launcher: ``python -m repro_torch.launch.train --arch <id>``

Trains ``--arch`` (any arch: dense, MoE, RWKV6, the Mamba hybrid,
Whisper's encoder-decoder on zero frames, LLaVA behind zero image tokens,
whose ``--seq`` counts the image tokens; random weights from seed 0) on
the synthetic token stream with the ElasticZO step of ``--lane``, on the
card unless ``--device cpu`` is given (use that with ``--smoke``, the
reduced same-family config). The flags and defaults are those of
``repro.launch.train``, the flight recorder's ``--trace``,
``--metrics``, ``--memory`` and ``--quiet`` included. The batches come
from ``data/pipeline.py::lm_batch_fn`` (seed 1) and reach the device
through its ``Prefetcher``. ``--ckpt-dir`` checkpoints every 50 steps and
at the end, and resumes from the newest checkpoint there
(``train/elastic_runtime.py::resume_on_mesh``). ``--profile-phases``
first times the engine's step phases one by one on a copy of the state
(``core/engine.py::profile_step_phases``) and logs them.

``--mesh DPxTP:data,model`` (or ``PxDPxTP:pod,data,model``) trains
across a mesh of ranks (``launch/mesh.py``) in the rules' ``tp``
strategy: Megatron tensor parallelism over `model`, FSDP storage over
`data`, the batch over `pod` and `data`, every stack: decoder-only,
Mixtral and Phi-3.5-MoE (experts over `model` under the ``ep`` plan,
d_ff over `model` where tp does not divide the experts), RWKV6 (its
heads over `model`), Jamba (its Mamba blocks' d_inner over `model`,
beside its attention and MoE blocks), Whisper's encoder-decoder and
LLaVA's image-token prefix. As in the JAX package the CLI has no
strategy flag; ``setup(..., strategy=)`` takes ``fsdp`` or ``serve``.
Under
``torchrun`` each process is a rank (``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``); otherwise the launcher
spawns the mesh's ranks itself and rendezvouses them at ``--dist-init``
(a fresh ``file://`` store by default). ``--dist-backend`` is ``nccl``
(a card a rank) or ``gloo``; the default is nccl on ``cuda`` and gloo on
``cpu``; gloo on ``cuda`` shares cards between ranks, and the first log
line says so. Each rank draws or restores its shards, makes the global
batch and keeps its rows; rank 0 logs and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from math import prod
from typing import Any, Callable, Dict, Optional

import torch

from .. import obs
from ..configs import LaneConfig, ModelConfig, ShapeConfig, get_arch, reduced
from ..core import api
from ..core.elastic import TrainState
from ..core.engine import profile_step_phases
from ..data.pipeline import (HostBatch, Prefetcher, device_put_batch,
                             lm_batch_fn, rank_rows, stub_dtypes)
from . import mesh as mesh_lib
from ..train.elastic_runtime import resume_on_mesh
from ..train.train_loop import LoopConfig, run


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--lane", default="elastic_zo",
                    choices=["elastic_zo", "full_zo", "full_bp"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--bp-tail-layers", type=int, default=1)
    ap.add_argument("--probes", type=int, default=1)
    ap.add_argument("--probe-drop", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--profile-phases", action="store_true",
                    help="time the engine's canonical step phases "
                         "(separate diagnostic calls with device syncs; "
                         "the production step is untouched)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="",
                    help="e.g. '2x2:data,model' or '2x1x2:pod,data,model' "
                         "to shard across ranks")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--dist-init", default=None,
                    help="rendezvous of spawned ranks (default: a new "
                         "file:// store)")
    obs.add_observability_args(ap)
    return ap.parse_args(argv)


@dataclass
class Trainer:
    lane: LaneConfig
    device: torch.device
    engine: Any
    loss_fn: Callable
    step_fn: Callable
    state: TrainState
    batch_fn: Callable[[int], Any]          # step -> batch on the device
    loop: LoopConfig
    host_batch_fn: Callable[[int], HostBatch]
    dtypes: Dict[str, torch.dtype]
    run: Any = None                          # the MeshRun on a mesh


def lane_from_args(args: argparse.Namespace) -> LaneConfig:
    return LaneConfig(lane=args.lane, bp_tail_layers=args.bp_tail_layers,
                      zo_num_probes=args.probes, learning_rate=args.lr,
                      zo_eps=args.eps)


def setup(args: argparse.Namespace, lane: Optional[LaneConfig] = None,
          cfg: Optional[ModelConfig] = None, mesh=None,
          strategy: str = "tp") -> Trainer:
    """Everything ``main`` runs, from parsed flags: the state from
    ``resume_on_mesh`` (the newest checkpoint under ``--ckpt-dir``, else
    weights drawn from seed 0 on ``--device``) and the batches of
    ``lm_batch_fn(cfg, shape, seed=1)``, whose ``frames`` / ``img`` stay
    in the config's dtype. ``lane`` replaces the flags' lane (as
    ``launch/dryrun.py --fused`` builds ``LaneConfig(fused_probes=True)``;
    the CLI has no fused-probe flag), and ``cfg`` the config that ``--arch``
    and ``--smoke`` name (a stack cut in depth, say). ``mesh``: a
    ``launch/mesh.py::make_mesh`` mesh that this process is a rank of
    (its shards and its rows, on the rank's device), sharded by the
    rules' ``strategy`` (``tp``, ``fsdp`` or ``serve``)."""
    device = api.resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = reduced(cfg)
    lane = lane or lane_from_args(args)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    state, model, step_fn = resume_on_mesh(args.ckpt_dir, cfg, shape, lane,
                                           mesh=mesh, seed=0,
                                           strategy=strategy, device=device)
    rows = None if model.run is None else rank_rows(
        shape, model.run.rules, model.run.coords)
    host_batch_fn = lm_batch_fn(cfg, shape, seed=1, rows=rows)
    dtypes = stub_dtypes(cfg)

    def batch_fn(step):
        return device_put_batch(host_batch_fn(step), device, dtypes)

    loop = LoopConfig.for_lane(lane, total_steps=args.steps,
                               log_every=max(args.steps // 10, 1),
                               probe_drop_rate=args.probe_drop,
                               ckpt_dir=args.ckpt_dir)
    return Trainer(lane, device, model.engine, model.loss_fn, step_fn, state,
                   batch_fn, loop, host_batch_fn, dtypes, model.run)


@contextlib.contextmanager
def prefetched(t: Trainer):
    """A ``batch_fn`` for ``train_loop.run`` that takes the batches from a
    ``Prefetcher`` started at the trainer's state's step; it raises if
    the loop asks for another step than the next one. The worker is
    joined on exit."""
    pf = Prefetcher(t.host_batch_fn, t.state.step, t.device, t.dtypes)

    def batch_fn(step):
        got, batch = pf.get()
        if got != step:
            raise RuntimeError(f"the prefetcher holds step {got}, the loop "
                               f"asked for step {step}")
        return batch
    try:
        yield batch_fn
    finally:
        pf.close()


def profile_phases(t: Trainer):
    """``--profile-phases``: {phase: mean us} of the trainer's engine on
    step 0's batch, each logged; ``t.state`` is left as it was."""
    phases = profile_step_phases(t.engine, t.loss_fn, t.state, t.batch_fn(0))
    for name, us in phases.items():
        obs.log("train", f"phase {name:10s} {us:10.1f} us")
    return phases


def train(args: argparse.Namespace, mesh=None):
    """One process's run of ``main``: the whole run, or a rank's on
    ``mesh`` (only rank 0 logs). Returns the logged (step, loss)
    history, the same on every rank."""
    t = setup(args, mesh=mesh)
    lead = t.run is None or t.run.rank == 0
    if args.profile_phases:
        profile_phases(t)
    t0 = time.perf_counter()
    with prefetched(t) as batch_fn:
        state, history = run(t.step_fn, t.state, batch_fn, t.loop,
                             param_shardings=t.run)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(t.device) \
        if t.device.type == "cuda" else "cpu"
    if lead:
        ranks = "" if t.run is None else f" ({t.run.world} ranks, " \
            f"mesh {t.run.sizes})"
        obs.log("train", f"done at step {state.step}; logged {len(history)} "
                f"loss points in {dt:.2f}s on {where}{ranks}")
        obs.write_outputs(args)
    return history


def _mesh_rank(rank: int, argv, backend: str, init_method: str, out: str):
    """A spawned rank: joins the group, builds the mesh, trains; rank 0
    writes its history to ``out``."""
    import torch.distributed as dist
    args = parse_args(argv)
    obs.configure_from_args(args)
    if args.device == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    shape, axes = mesh_lib.parse_mesh(args.mesh)
    mesh_lib.init_ranks(backend, args.device, rank, prod(shape), init_method)
    try:
        history = train(args, mesh_lib.make_mesh(shape, axes))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(history, f)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    obs.configure_from_args(args)
    if not args.mesh:
        return train(args)
    import torch.distributed as dist
    shape, axes = mesh_lib.parse_mesh(args.mesh)
    world = prod(shape)
    backend = args.dist_backend or mesh_lib.default_backend(args.device)
    env = mesh_lib.env_rank()
    # the ranks on this host's cards: torchrun's local world, or all of them
    mesh_lib.check_world(backend, args.device, world if env is None
                         else env[3])
    note = mesh_lib.sharing_note(backend, args.device, world)
    if env is not None or dist.is_initialized():
        # torchrun (or a caller that made the group): this process is a rank
        if not dist.is_initialized():
            rank, _, local, local_world = env
            mesh_lib.init_ranks(backend, args.device, local, world,
                                "env://", rank=rank, local_world=local_world)
        if note and dist.get_rank() == 0:
            obs.log("train", note)
        return train(args, mesh_lib.make_mesh(shape, axes))
    if note:
        obs.log("train", note)
    tmp = tempfile.mkdtemp(prefix="repro_train_")
    init = args.dist_init or "file://" + os.path.join(tmp, "store")
    out = os.path.join(tmp, "history.json")
    try:
        mesh_lib.spawn(_mesh_rank, world, (argv, backend, init, out))
        with open(out) as f:
            return [tuple(h) for h in json.load(f)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
