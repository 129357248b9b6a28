"""The paper's ElasticZO-INT8 lanes of LeNet-5 (Table 1's INT8 and INT8*
columns) on the glyph data.

The port's twin of the int8 half of ``benchmarks/paper_tables.py``
(``INT8_LANES``, ``_int8_lane_cfg``, ``lenet_int8_lanes``): the same lanes,
init key 7, state key 13, ``glyphs(2048, seed=0)`` for training and
``glyphs(512, seed=1, start=10000)`` for the test, batches quantised one
at a time and the test set at once, as the JAX harness does. The steps run
through ``train_loop.run``, inside ``core/api.py::f32_products`` and
``deterministic`` like every paper-table entry point. ``repro_torch.benchmarks.paper_tables``
re-exports these names beside the fp32 lanes.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..configs.base import LaneConfig
from ..core.api import deterministic, f32_products, resolve_device
from ..core.elastic import TrainState
from ..core.elastic_int8 import int8_eval, make_int8_elastic_step
from ..core.engine import clone_tree
from ..core.int8 import quant_from_float
from ..data.synthetic import glyphs
from ..models import lenet
from ..obs.memory import tree_nbytes, tree_tensors
from .train_loop import LoopConfig, init_state, run

# INT8/INT8* lanes (Alg. 2): (name, partition point C, tail FCs)
INT8_LANES = [
    ("full_zo", 5, []),
    ("zo_feat_cls2", 3, [("fc2", "fc2_in"), ("fc3", "fc3_in")]),
    ("zo_feat_cls1", 4, [("fc3", "fc3_in")]),
]


def int8_lane_cfg() -> LaneConfig:
    return LaneConfig(int8_r_max=3, int8_p_zero=0.33, int8_b_zo=1,
                      int8_b_bp=5)


class LaneResult(NamedTuple):
    """One lane's run (fp32 and int8 alike); memory is read on a card
    only (``measured_run``)."""
    acc: float                   # test accuracy
    history: list                # (step, loss) at the loop's log points
    train_s: float               # wall time of the step loop
    peak_bytes: Optional[int]    # the allocator's peak in the loop
    memory_bytes: Optional[int]  # params + the loop's peak growth
    state: TrainState


def measured_run(step, state: TrainState, batch_fn, loop: LoopConfig,
                 device: torch.device):
    """``train_loop.run`` timed on the host's clock, ending in a
    synchronise on a card, where memory is read around it: the
    allocator's peak, and the training memory, the parameters' bytes
    plus the loop's peak above what was allocated when it started (so
    memory that other code holds, library workspaces or other models, is
    not counted). On a card one warm step runs first, on a copy of the
    state and the loop's first batch, outside the timed and measured
    window: it builds the kernels and allocates the one-time workspaces
    (the autograd thread's cuBLAS workspace, 32 MiB, at the process's
    first backward). The caller's reference to ``state`` keeps the
    leaves that the steps replace (the BP leaves; the ZO leaves are
    updated in place) alive from the second step on; they are not the
    steps' memory and are left out. So the training memory is one step's
    own, as ``core/engine.py::step_memory_analysis`` measures it.
    Returns (state, history, train_s, peak_bytes, memory_bytes); the
    bytes are None on the CPU."""
    on_card = device.type == "cuda"
    peak = mem = None
    if on_card:
        warm = TrainState(clone_tree(state.params), state.step, state.seed)
        step(warm, batch_fn(state.step),
             np.ones((loop.n_probes,), np.float32))
        del warm
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        mem = tree_nbytes(state.params) - torch.cuda.memory_allocated(device)
        start = {t.data_ptr(): t.numel() * t.element_size()
                 for t in tree_tensors(state.params)}
    steps = loop.total_steps - state.step
    t0 = time.perf_counter()
    state, history = run(step, state, batch_fn, loop, log=None)
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        kept = {t.data_ptr() for t in tree_tensors(state.params)}
        held = sum(n for p, n in start.items() if p not in kept) \
            if steps > 1 else 0
        mem += peak - held
    return state, history, time.perf_counter() - t0, peak, mem


@functools.lru_cache(maxsize=2)
def _glyph_sets(train_n: int, test_n: int, seed: int):
    """(train, test) glyph sets: pure functions of their arguments, made
    once per process."""
    return glyphs(train_n, seed=seed), \
        glyphs(test_n, seed=seed + 1, start=10_000)


def lenet_int8_lanes(steps: int = 600, batch: int = 64, train_n: int = 2048,
                     test_n: int = 512, seed: int = 0, loss_mode: str = "int",
                     *, device=None, lanes: Optional[Sequence[str]] = None,
                     log_every: int = 0) -> Dict[str, LaneResult]:
    """Train each int8 lane (all, or those named in ``lanes``) for
    ``steps`` steps (``measured_run``) and evaluate it. Runs on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    (xs_tr, ys_tr), (xs_te, ys_te) = _glyph_sets(train_n, test_n, seed)
    qx_te = quant_from_float(torch.from_numpy(xs_te).to(device))
    y_te = torch.from_numpy(ys_te).to(device)

    def batch_fn(s):
        i0 = (s * batch) % train_n
        x = torch.from_numpy(xs_tr[i0:i0 + batch]).to(device)
        return {"x": quant_from_float(x),
                "y": torch.from_numpy(ys_tr[i0:i0 + batch]).to(device)}

    results = {}
    with f32_products(), deterministic():
        for name, c, tail in INT8_LANES:
            if lanes is not None and name not in lanes:
                continue
            lane = int8_lane_cfg()
            step = make_int8_elastic_step(
                lenet.lenet5_forward_int8,
                partition_fn=lambda p, c=c: lenet.partition_at(p, c),
                tail_fcs=tail, lane=lane, loss_mode=loss_mode)
            state = init_state(lenet.init_lenet5_int8(7, device=device), 13)
            cfg = LoopConfig.for_lane(lane, total_steps=steps,
                                      log_every=log_every)
            state, history, train_s, peak, mem = measured_run(
                step, state, batch_fn, cfg, device)
            acc = float(int8_eval(lenet.lenet5_forward_int8, state.params,
                                  qx_te, y_te))
            results[name] = LaneResult(acc, history, train_s, peak, mem,
                                       state)
    return results
