"""Training driver: probe masks, logging and the step loop.

The port of ``repro/train/train_loop.py``. Batches are pure functions of
the step index (``data/synthetic.py``), so the whole restart state is
(params, step). The loss is read on the host only at log points; between
them the loop never waits on the device. With a flight recorder armed
(``repro_torch.obs``) each step is a ``train/step`` span that ends in
``torch.cuda.synchronize`` (where the JAX package blocks on the
metrics), feeding ``train.step_ms``, ``train.tokens``,
``train.tokens_per_s`` and ``train.loss``, and the params and batch are
tagged in the memory ledger; the default null recorder adds no sync.

With ``ckpt_dir`` set the loop restores the newest committed checkpoint
there on start (``train/checkpoint.py``) and saves one every
``ckpt_every`` steps on a background thread, keeping ``keep``, and one at
the end. A checkpoint labelled N holds the params after N steps. The
probe-drop mask of step s is the s-th draw of the loop's stream, so a run
that starts from a state at step k (restored here, or by
``elastic_runtime.resume_on_mesh``) draws the masks an uninterrupted one
would have drawn from there on, and continues bitwise where the saved
one stopped. (The JAX loop labels its periodic checkpoints one step early:
the one it calls N holds the params after N + 1 steps.)
``mask_fn(step)`` gives explicit per-step probe masks, as the fleet's
single-process reference takes the realised masks of a fleet run.

On a mesh (``param_shardings``, the ``sharding/collectives.py::MeshRun``
of the params) every rank runs the loop on its shards and rows: the
checkpoints gather to rank 0, which writes them, restores keep each
rank's slice, and only rank 0 logs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import obs
from ..core import keys
from ..core.elastic import TrainState
from . import checkpoint as ckpt


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    seed: int = 0
    # straggler simulation/mitigation: probability a probe is dropped and
    # masked out instead of waited for
    probe_drop_rate: float = 0.0
    n_probes: int = 1
    # explicit per-step probe masks (fp32[n_probes]), e.g. the realised
    # commit masks of a fleet run replayed through the single-process
    # reference; overrides the drop stream
    mask_fn: Optional[Callable[[int], Any]] = None

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


def _log_train(msg: str, **fields):
    obs.log("train", msg, **fields)


def run(step_fn: Callable, state: TrainState,
        batch_fn: Callable[[int], Dict[str, Any]], cfg: LoopConfig,
        log: Optional[Callable[..., None]] = _log_train,
        param_shardings=None) -> RunResult:
    """Steps ``state.step`` .. ``cfg.total_steps - 1``. batch_fn(step) ->
    a batch on the params' device (the rank's rows on a mesh).
    ``state`` is consumed (the step updates the ZO leaves in place).
    ``log(msg, step=, loss=)`` takes the progress lines (``obs.log`` on
    the ``train`` channel; None drops them, as every rank but 0 does on
    a mesh). ``param_shardings``: the params' ``MeshRun`` on a mesh."""
    mesh = param_shardings
    if mesh is not None and mesh.rank != 0:
        log = None
    saver = ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep, run=mesh) \
        if cfg.ckpt_dir else None
    start = state.step
    if cfg.ckpt_dir:
        last = ckpt.latest_step(cfg.ckpt_dir)
        if last is not None and last > start:
            params, last = ckpt.restore(
                cfg.ckpt_dir, state.params,
                shardings=None if mesh is None else mesh.descs)
            state = TrainState(params, last, state.seed)
            start = last
            if log is not None:
                log(f"resumed from step {last}", step=last)
    rec = obs.get()
    mem = rec.memory
    if rec.enabled:
        # params are rebound (the step replaces them, sizes constant);
        # the batch is tracked per step below
        mem.rebind("train.params", obs.memory.tree_nbytes(state.params),
                   key=("train.params", id(cfg)))
    rng = np.random.default_rng(cfg.seed + 17)
    if cfg.mask_fn is None:
        for _ in range(start):          # the draws of the earlier steps
            rng.uniform(size=cfg.n_probes)
    t0 = obs.monotonic()
    history = []
    for step in range(start, cfg.total_steps):
        batch = batch_fn(step)
        if rec.enabled:
            batch_nbytes = mem.alloc("train.batch",
                                     obs.memory.tree_nbytes(batch))
        if cfg.mask_fn is not None:
            mask = np.asarray(cfg.mask_fn(step), np.float32)
        else:
            mask = (rng.uniform(size=cfg.n_probes) >=
                    cfg.probe_drop_rate).astype(np.float32)
            if mask.sum() == 0:
                mask[0] = 1.0      # never drop every probe
        with rec.span("train/step", track="train", step=step) as sp:
            state, metrics = step_fn(state, batch, mask)
            loss_t = metrics["loss"]
            if rec.enabled and getattr(loss_t, "is_cuda", False):
                torch.cuda.synchronize(loss_t.device)
        if rec.enabled:
            mem.free("train.batch", batch_nbytes)
            rec.histogram("train.step_ms").observe(sp.dur_ns / 1e6)
            toks = batch.get("tokens")      # absent for vision batches
            ntok = toks.numel() if isinstance(toks, torch.Tensor) else 0
            if ntok and sp.dur_ns:
                rec.counter("train.tokens").inc(ntok)
                rec.gauge("train.tokens_per_s").set(ntok / (sp.dur_ns / 1e9))
            rec.gauge("train.loss").set(float(metrics["loss"]))
        if cfg.log_every and (step % cfg.log_every == 0
                              or step == cfg.total_steps - 1):
            if rec.enabled:
                obs.memory.sample()   # reconcile tagged vs the allocator
            loss = float(metrics["loss"])
            history.append((step, loss))
            if log is not None:
                dt = obs.monotonic() - t0
                log(f"step {step:6d} loss {loss:.4f} "
                    f"({dt / max(step - start + 1, 1):.3f}s/step)",
                    step=step, loss=loss)
        done = step + 1
        if saver and done % cfg.ckpt_every == 0 and done < cfg.total_steps:
            saver.save(done, state.params,
                       extra={"loss": float(metrics["loss"])})
    if saver:
        saver.save(cfg.total_steps, state.params)
        saver.wait()
    return RunResult(state, history)
