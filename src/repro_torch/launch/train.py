"""LM training launcher: ``python -m repro_torch.launch.train --arch <id>``

Trains ``--arch`` (any decoder-only arch: dense, MoE, RWKV6 or the
Mamba hybrid; random weights from seed 0) on the synthetic token stream
with the ElasticZO step of ``--lane``, on the card unless ``--device
cpu`` is given (use that with ``--smoke``, the reduced same-family
config). The flags and defaults are those of ``repro.launch.train``, the
flight recorder's ``--trace``, ``--metrics``, ``--memory`` and
``--quiet`` included. ``--ckpt-dir`` checkpoints every 50 steps and at
the end, and resumes from the newest checkpoint there
(``train/checkpoint.py``). ``--profile-phases`` first times the engine's
step phases one by one on a copy of the state
(``core/engine.py::profile_step_phases``) and logs them. ``--mesh`` is
not ported.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from .. import obs
from ..configs import LaneConfig, ModelConfig, get_arch, reduced
from ..core import api
from ..core.elastic import TrainState
from ..core.engine import profile_step_phases
from ..data.synthetic import token_batch
from ..train.train_loop import LoopConfig, init_state, run


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
    batch_fn: Callable[[int], Any]
    loop: LoopConfig


def lane_from_args(args: argparse.Namespace) -> LaneConfig:
    return LaneConfig(lane=args.lane, bp_tail_layers=args.bp_tail_layers,
                      zo_num_probes=args.probes, learning_rate=args.lr,
                      zo_eps=args.eps)


def setup(args: argparse.Namespace, lane: Optional[LaneConfig] = None,
          cfg: Optional[ModelConfig] = None) -> Trainer:
    """Everything ``main`` runs, from parsed flags; the weights are drawn
    from seed 0 on ``--device``. ``lane`` replaces the flags' lane (as
    ``repro.launch.dryrun`` builds ``LaneConfig(fused_probes=True)``; the
    CLI has no fused-probe flag), and ``cfg`` the config that ``--arch``
    and ``--smoke`` name (a stack cut in depth, say)."""
    device = api.resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = reduced(cfg)
    lane = lane or lane_from_args(args)
    engine, loss_fn = api.train_engine(cfg, lane)
    params = api.init(cfg, lane, seed=0, device=device)

    def batch_fn(step):
        x, y, m = token_batch(args.batch, args.seq, cfg.vocab_size, seed=1,
                              step=step)
        return {k: torch.from_numpy(v).to(device)
                for k, v in (("tokens", x), ("labels", y), ("mask", m))}

    loop = LoopConfig.for_lane(lane, total_steps=args.steps,
                               log_every=max(args.steps // 10, 1),
                               probe_drop_rate=args.probe_drop,
                               ckpt_dir=args.ckpt_dir)
    return Trainer(lane, device, engine, loss_fn, engine.make_step(loss_fn),
                   init_state(params, seed=0), batch_fn, loop)


def profile_phases(t: Trainer):
    """``--profile-phases``: {phase: mean us} of the trainer's engine on
    step 0's batch, each logged; ``t.state`` is left as it was."""
    phases = profile_step_phases(t.engine, t.loss_fn, t.state, t.batch_fn(0))
    for name, us in phases.items():
        obs.log("train", f"phase {name:10s} {us:10.1f} us")
    return phases


def main(argv=None):
    args = parse_args(argv)
    obs.configure_from_args(args)
    t = setup(args)
    if args.profile_phases:
        profile_phases(t)
    t0 = time.perf_counter()
    state, history = run(t.step_fn, t.state, t.batch_fn, t.loop)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(t.device) \
        if t.device.type == "cuda" else "cpu"
    obs.log("train", f"done at step {state.step}; logged {len(history)} "
            f"loss points in {dt:.2f}s on {where}")
    obs.write_outputs(args)
    return history


if __name__ == "__main__":
    main()
