"""Training driver: probe masks, logging and the step loop.

The port of ``repro/train/train_loop.py``. Batches are pure functions of
the step index (``data/synthetic.py``), so the whole restart state is
(params, step). The loss is read on the host only at log points; between
them the loop never waits on the device. Checkpointing, the flight
recorder and explicit per-step masks (``mask_fn``, the fleet reference's)
are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..core import keys
from ..core.elastic import TrainState


@dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    seed: int = 0
    # straggler simulation/mitigation: probability a probe is dropped and
    # masked out instead of waited for
    probe_drop_rate: float = 0.0
    n_probes: int = 1

    @classmethod
    def for_lane(cls, lane, **kwargs) -> "LoopConfig":
        """Derive the probe count from the lane (the step checks its
        probe_mask shape against the lane)."""
        if "n_probes" in kwargs:
            raise ValueError("n_probes is derived from lane.zo_num_probes")
        return cls(n_probes=lane.zo_num_probes, **kwargs)


def init_state(params, seed: int) -> TrainState:
    """Step 0 with the key data of ``jax.random.key(seed)``."""
    return TrainState(params, 0, keys.key_data(seed))


@dataclass
class RunResult:
    """Terminal state of a run and its logged (step, loss) curve; unpacks
    as ``state, history = run(...)``."""
    state: TrainState
    history: list

    def __iter__(self):
        return iter((self.state, self.history))


def run(step_fn: Callable, state: TrainState,
        batch_fn: Callable[[int], Dict[str, Any]], cfg: LoopConfig,
        log: Optional[Callable[[str], None]] = print) -> RunResult:
    """Steps ``state.step`` .. ``cfg.total_steps - 1``. batch_fn(step) ->
    a batch on the params' device. ``state`` is consumed (the step
    updates the ZO leaves in place)."""
    start = state.step
    rng = np.random.default_rng(cfg.seed + 17)
    t0 = time.perf_counter()
    history = []
    for step in range(start, cfg.total_steps):
        batch = batch_fn(step)
        mask = (rng.uniform(size=cfg.n_probes) >=
                cfg.probe_drop_rate).astype(np.float32)
        if mask.sum() == 0:
            mask[0] = 1.0          # never drop every probe
        state, metrics = step_fn(state, batch, mask)
        if cfg.log_every and (step % cfg.log_every == 0
                              or step == cfg.total_steps - 1):
            loss = float(metrics["loss"])
            history.append((step, loss))
            if log is not None:
                dt = time.perf_counter() - t0
                log(f"[train] step {step:6d} loss {loss:.4f} "
                    f"({dt / max(step - start + 1, 1):.3f}s/step)")
    return RunResult(state, history)
