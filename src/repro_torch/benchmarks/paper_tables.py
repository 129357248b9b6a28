"""Paper-faithful experiment harnesses (Tables 1-2, Figs. 4-7 analogs).

The port of ``benchmarks/paper_tables.py``. Datasets are the
deterministic synthetic stand-ins (``data/synthetic.py``); the claims
reproduced are the *orderings and gaps between lanes* (Full BP >
ZO-Feat-Cls1 > ZO-Feat-Cls2 > Full ZO), the memory accounting (Eqs. 2-4,
13-15 evaluated exactly), the step-time breakdown and the integer sign
agreement. The lanes, seeds, data and schedules are the reference's:
LeNet-5 from init key 7 and state key 11 on ``glyphs``, PointNet from
init key 5 and state key 17 on ``point_clouds`` (train seed 3, test seed
4 from index 50,000), and the int8 lanes of ``train/paper_lanes.py``.

Every entry point runs on the card unless given ``device="cpu"``, and
runs inside ``core/api.py::f32_products`` (TF32 off), since the reference
computes in f32, and inside ``core/api.py::deterministic``, so that a run
repeats bitwise (cuDNN may otherwise pick a nondeterministic convolution
algorithm, and Table 2's lanes start from a full-BP pretraining). The
process must set ``CUBLAS_WORKSPACE_CONFIG`` before its first cuBLAS
product, as ``benchmarks/run.py`` does. The steps go through
``train/train_loop.py::run``.

Measured memory has no XLA buffer assignment to read: on the card one
warm step of each lane is run and measured with the caching allocator's
peak (``lenet_measured_memory``); on the CPU the measured rows are None.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import LaneConfig
from ..configs.paper_models import LeNet5Config, PointNetConfig
from ..core import keys, prng, zo
from ..core.api import deterministic, f32_products, resolve_device
from ..core.elastic import TrainState, make_elastic_step
from ..core.elastic_int8 import make_int8_elastic_step
from ..core.int8 import QTensor, perturb_int8, quant_from_float
from ..core.int_loss import float_loss, int_loss_sign
from ..data.synthetic import glyphs, point_clouds
from ..models import lenet, pointnet
from ..obs.memory import tree_nbytes
from ..train.paper_lanes import (INT8_LANES, LaneResult,  # noqa: F401
                                 int8_lane_cfg, lenet_int8_lanes,
                                 measured_run)
from ..train.train_loop import LoopConfig, init_state, run


# ------------------------------------------------------------------ #
# Table 1 analog: accuracy by lane
# ------------------------------------------------------------------ #
def lenet_lane_configs(steps=600, lr=0.05, zo_lr=5e-3, eps=1e-2, probes=4
                       ) -> List[Tuple[str, LaneConfig, int]]:
    """The four paper lanes as (name, LaneConfig, partition point C),
    shared by the accuracy harness and the measured-memory harness."""
    dk = dict(lr_decay_factor=0.8, lr_decay_every=max(steps // 10, 1))
    return [
        ("full_zo", LaneConfig(lane="full_zo", learning_rate=zo_lr,
                               zo_eps=eps, zo_num_probes=probes, **dk), 5),
        ("zo_feat_cls2", LaneConfig(lane="elastic_zo", learning_rate=zo_lr,
                                    tail_learning_rate=lr, zo_eps=eps,
                                    zo_num_probes=probes, **dk), 3),
        ("zo_feat_cls1", LaneConfig(lane="elastic_zo", learning_rate=zo_lr,
                                    tail_learning_rate=lr, zo_eps=eps,
                                    zo_num_probes=probes, **dk), 4),
        ("full_bp", LaneConfig(lane="full_bp", learning_rate=lr, **dk), 0),
    ]


def pointnet_lane_configs(steps=400) -> List[Tuple[str, LaneConfig, int]]:
    """PointNet's four lanes (partition points over its 8 layers)."""
    dk = dict(lr_decay_factor=0.8, lr_decay_every=max(steps // 10, 1))
    zo_kw = dict(learning_rate=5e-3, zo_eps=1e-2, zo_num_probes=4, **dk)
    return [
        ("full_zo", LaneConfig(lane="full_zo", **zo_kw), 8),
        ("zo_feat_cls2", LaneConfig(lane="elastic_zo",
                                    tail_learning_rate=0.05, **zo_kw), 6),
        ("zo_feat_cls1", LaneConfig(lane="elastic_zo",
                                    tail_learning_rate=0.05, **zo_kw), 7),
        ("full_bp", LaneConfig(lane="full_bp", learning_rate=0.05, **dk), 0),
    ]


@functools.lru_cache(maxsize=8)
def _glyphs(n: int, seed: int, start: int, rotate: float):
    return glyphs(n, seed=seed, start=start, rotate_deg=rotate)


@functools.lru_cache(maxsize=4)
def _clouds(n: int, num_points: int, seed: int, classes: int, start: int):
    return point_clouds(n, num_points, seed=seed, num_classes=classes,
                        start=start)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def accuracy(forward: Callable, params, x: torch.Tensor,
             y: torch.Tensor) -> float:
    """Test accuracy of an fp32 forward; a tie goes to the first maximum,
    as ``jnp.argmax`` takes it."""
    with torch.no_grad():
        logits, _ = forward(params, x)
    return float((logits.argmax(-1) == y).float().mean())


def _train_lanes(cfgs, loss_fn, forward, partition_at, init_fn, state_key,
                 train, test, *, steps, batch, device, lanes, log_every,
                 warmup=0) -> Dict[str, LaneResult]:
    """Each lane of ``cfgs`` (all, or those named in ``lanes``) from
    ``init_fn()`` for ``warmup`` untimed and then ``steps`` timed steps
    (``measured_run``) on batch i of the train arrays at rows (i * batch)
    mod n, then evaluated on the test arrays."""
    xs_tr, ys_tr = train
    n = len(xs_tr)
    x_te = torch.from_numpy(test[0]).to(device)
    y_te = torch.from_numpy(test[1]).to(device)

    def batch_fn(s):
        i0 = (s * batch) % n
        return {"x": torch.from_numpy(xs_tr[i0:i0 + batch]).to(device),
                "y": torch.from_numpy(ys_tr[i0:i0 + batch]).to(device)}

    results = {}
    for name, lane, c in cfgs:
        if lanes is not None and name not in lanes:
            continue
        part = (lambda p, c=c: partition_at(p, c)) \
            if lane.lane == "elastic_zo" else None
        step = make_elastic_step(loss_fn, lane, partition_fn=part)
        state = init_state(init_fn(), state_key)
        if warmup:
            state, _ = run(step, state, batch_fn,
                           LoopConfig.for_lane(lane, total_steps=warmup,
                                               log_every=0), log=None)
        loop = LoopConfig.for_lane(lane, total_steps=warmup + steps,
                                   log_every=log_every)
        state, history, train_s, peak, mem = measured_run(
            step, state, batch_fn, loop, device)
        results[name] = LaneResult(accuracy(forward, state.params, x_te,
                                            y_te),
                                   history, train_s, peak, mem, state)
    return results


def lenet_lanes(steps=600, batch=32, train_n=2048, test_n=512, seed=0,
                lr=0.05, zo_lr=5e-3, eps=1e-2, rotate=0.0, init_params=None,
                probes=4, *, device=None, lanes: Optional[Sequence[str]] = None
                ) -> Dict[str, LaneResult]:
    """{lane: LaneResult} for the four paper lanes of LeNet-5 (``acc`` is
    the reference's first element). ``init_params`` (Table 2's pretrained
    model) is copied for each lane, since a step updates ZO leaves in
    place. The loss is read every ``steps // 20`` steps, as the
    reference's curve does."""
    device = resolve_device(device)
    train = _glyphs(train_n, seed, 0, float(rotate))
    test = _glyphs(test_n, seed + 1, 10_000, float(rotate))
    cfgs = lenet_lane_configs(steps=steps, lr=lr, zo_lr=zo_lr, eps=eps,
                              probes=probes)
    init = (lambda: _clone(init_params)) if init_params is not None \
        else (lambda: lenet.init_lenet5(7, device=device))
    with f32_products(), deterministic():
        return _train_lanes(cfgs, lenet.lenet5_loss, lenet.lenet5_forward,
                            lenet.partition_at, init, 11, train, test,
                            steps=steps, batch=batch, device=device,
                            lanes=lanes, log_every=max(steps // 20, 1))


def lenet_pretrained(steps: int, batch: int = 32, *, device=None):
    """Table 2's starting point: LeNet-5 (init key 7) after ``steps``
    full-BP steps (lr 0.05, state key 1) on upright ``glyphs(2048,
    seed=0)``."""
    device = resolve_device(device)
    xs, ys = _glyphs(2048, 0, 0, 0.0)
    lane = LaneConfig(lane="full_bp", learning_rate=0.05)

    def batch_fn(s):
        i0 = (s * batch) % 2048
        return {"x": torch.from_numpy(xs[i0:i0 + batch]).to(device),
                "y": torch.from_numpy(ys[i0:i0 + batch]).to(device)}

    with f32_products(), deterministic():
        state, _ = run(make_elastic_step(lenet.lenet5_loss, lane),
                       init_state(lenet.init_lenet5(7, device=device), 1),
                       batch_fn,
                       LoopConfig.for_lane(lane, total_steps=steps,
                                           log_every=0), log=None)
    return state.params


def lenet_rotated_accuracy(params, rotate: float, *, device=None) -> float:
    """Accuracy on Table 2's rotated test set, ``glyphs(512, seed=5,
    start=20000)`` rotated by ``rotate`` degrees."""
    device = resolve_device(device)
    xs, ys = _glyphs(512, 5, 20_000, float(rotate))
    with f32_products(), deterministic():
        return accuracy(lenet.lenet5_forward, params,
                        torch.from_numpy(xs).to(device),
                        torch.from_numpy(ys).to(device))


def pointnet_lanes(steps=400, batch=32, train_n=1024, test_n=256,
                   num_points=256, classes=8, *, device=None,
                   lanes: Optional[Sequence[str]] = None, warmup: int = 0
                   ) -> Dict[str, LaneResult]:
    """{lane: LaneResult} for PointNet's four lanes: init key 5, state key
    17, ``point_clouds(train_n, seed=3)`` for training and
    ``point_clouds(test_n, seed=4, start=50000)`` for the test. The loss
    is read at the first and the last step. ``warmup`` untimed steps run
    before the ``steps`` timed ones (the timing runs; they shift the
    schedule, so accuracies are taken with ``warmup=0``)."""
    device = resolve_device(device)
    cfg = PointNetConfig(num_classes=classes, num_points=num_points)
    train = _clouds(train_n, num_points, 3, classes, 0)
    test = _clouds(test_n, num_points, 4, classes, 50_000)
    with f32_products(), deterministic():
        return _train_lanes(
            pointnet_lane_configs(steps), pointnet.pointnet_loss,
            pointnet.pointnet_forward, pointnet.partition_at,
            lambda: pointnet.init_pointnet(5, cfg, device=device), 17,
            train, test, steps=steps, batch=batch, device=device,
            lanes=lanes, log_every=max(steps, 1), warmup=warmup)


# ------------------------------------------------------------------ #
# Figs. 4-6 analog: memory accounting, Eqs. 2-4 / 13-15 evaluated exactly
# ------------------------------------------------------------------ #
def lenet_memory_table(batch: int) -> Dict[str, Dict[str, float]]:
    """Exact evaluation of the paper's memory model for LeNet-5."""
    cfg = LeNet5Config()
    c1, c2 = cfg.conv_channels
    # activation sizes per layer (fp32 elements, batch included)
    acts = {
        "conv1": batch * 28 * 28 * c1, "pool1": batch * 14 * 14 * c1,
        "conv2": batch * 14 * 14 * c2, "pool2": batch * 7 * 7 * c2,
        "fc1": batch * 120, "fc2": batch * 84, "fc3": batch * 10,
    }
    thetas = {
        "conv1": 5 * 5 * 1 * c1 + c1, "conv2": 5 * 5 * c1 * c2 + c2,
        "fc1": 784 * 120 + 120, "fc2": 120 * 84 + 84, "fc3": 84 * 10 + 10,
    }
    trainable = list(thetas)
    A = sum(acts.values())
    TH = sum(thetas.values())

    def mem_fp32(c):                       # Eq. 2-4, bytes (fp32 = 4B)
        tail = trainable[c:]
        g = sum(thetas[l] for l in tail)   # gradients of tail params
        e = sum(acts[l] for l in tail)     # errors of tail layers
        return 4 * (TH + A + g + e)

    def mem_int8(c, reuse_scratch: bool):
        """Eq. 13-15. ``reuse_scratch=False`` is the paper's no-lifetime
        accounting (every int32 accumulator held simultaneously);
        ``True`` models one int32 scratch buffer rounded to int8 at once
        and reused across layers (the paper's measured 1.46-1.60x)."""
        tail = trainable[c:]
        g8 = sum(thetas[l] for l in tail)
        e8 = sum(acts[l] for l in tail)
        if reuse_scratch:
            a32 = max(acts[l] for l in trainable)
            g32 = max((thetas[l] for l in tail), default=0)
            e32 = max((acts[l] for l in tail), default=0)
        else:
            a32 = sum(acts[l] for l in trainable)
            g32 = sum(thetas[l] for l in tail)
            e32 = sum(acts[l] for l in tail)
        return (TH + A + g8 + e8) + 4 * (a32 + g32 + e32)

    rows = {}
    for name, c in [("full_bp", 0), ("zo_feat_cls1", 4), ("zo_feat_cls2", 3),
                    ("full_zo", 5)]:
        rows[name] = {"fp32_bytes": mem_fp32(c),
                      "int8_bytes": mem_int8(c, False),
                      "int8_reused_bytes": mem_int8(c, True)}
    return rows


def pointnet_memory_table(batch: int, num_points=1024):
    """Exact evaluation of Eqs. 2-4 for PointNet (40 classes)."""
    cfg = PointNetConfig()
    dims = (3,) + cfg.feat_dims
    acts = {f"feat{i}": batch * num_points * dims[i + 1] for i in range(5)}
    acts["pool"] = batch * 1024
    hd = (1024,) + cfg.head_dims + (cfg.num_classes,)
    for i, n in enumerate(("head0", "head1", "cls")):
        acts[n] = batch * hd[i + 1]
    thetas = {f"feat{i}": dims[i] * dims[i + 1] + dims[i + 1] for i in range(5)}
    for i, n in enumerate(("head0", "head1", "cls")):
        thetas[n] = hd[i] * hd[i + 1] + hd[i + 1]
    trainable = list(thetas)
    A, TH = sum(acts.values()), sum(thetas.values())

    def mem(c):
        tail = trainable[c:]
        g = sum(thetas[l] for l in tail)
        e = sum(acts[l] for l in tail)
        return 4 * (TH + A + g + e)

    return {"full_bp": {"fp32_bytes": mem(0)},
            "zo_feat_cls1": {"fp32_bytes": mem(7)},
            "zo_feat_cls2": {"fp32_bytes": mem(6)},
            "full_zo": {"fp32_bytes": mem(8)},
            "theta_bytes": 4 * TH, "act_bytes": 4 * A}


# ------------------------------------------------------------------ #
# measured memory: one warm step of each lane on the card
# ------------------------------------------------------------------ #
def step_memory(step, state: TrainState, batch, mask, device
                ) -> Dict[str, int]:
    """One warm step (kernels built, workspaces allocated), then one
    measured step after ``reset_peak_memory_stats``: ``temp_bytes`` is
    the allocator's peak above what was allocated before the step,
    ``argument_bytes`` the state's parameters, ``peak_bytes`` their sum.
    The reference's output and alias bytes (XLA donation) have no
    counterpart: the step writes the ZO leaves in place."""
    state, _ = step(state, batch, mask)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    state, _ = step(state, batch, mask)
    torch.cuda.synchronize(device)
    temp = torch.cuda.max_memory_allocated(device) - before
    arg = tree_nbytes(state.params)
    return {"argument_bytes": arg, "temp_bytes": temp,
            "peak_bytes": arg + temp}


def lenet_measured_memory(batch: int = 32, *, device=None
                          ) -> Optional[Dict[str, Dict[str, int]]]:
    """MEASURED per-lane step footprint of the four fp32 paper lanes
    (``step_memory`` of each), next to ``lenet_memory_table``'s Eq. 2-4
    values in benchmarks/run.py. None on the CPU, which has no allocator
    to read: the measured rows stay empty there rather than take a
    number from elsewhere."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    xs, ys = _glyphs(batch, 0, 0, 0.0)
    batch_d = {"x": torch.from_numpy(xs).to(device),
               "y": torch.from_numpy(ys).to(device)}
    rows = {}
    with f32_products(), deterministic():
        for name, lane, c in lenet_lane_configs():
            part = (lambda p, c=c: lenet.partition_at(p, c)) \
                if lane.lane == "elastic_zo" else None
            step = make_elastic_step(lenet.lenet5_loss, lane,
                                     partition_fn=part)
            state = init_state(lenet.init_lenet5(7, device=device), 11)
            rows[name] = step_memory(
                step, state, batch_d,
                np.ones((lane.zo_num_probes,), np.float32), device)
    return rows


def lenet_int8_measured_memory(batch: int = 32, *, device=None
                               ) -> Optional[Dict[str, Dict[str, int]]]:
    """MEASURED per-lane step footprint of the INT8* lanes (Alg. 2), as
    ``lenet_measured_memory``; None on the CPU. The port keeps int8
    tensors but rescales through int64 temporaries, so the measured peak
    sits above Eq. 13-15's."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    xs, ys = _glyphs(batch, 0, 0, 0.0)
    batch_d = {"x": quant_from_float(torch.from_numpy(xs).to(device)),
               "y": torch.from_numpy(ys).to(device)}
    rows = {}
    with f32_products(), deterministic():
        for name, c, tail in INT8_LANES:
            step = make_int8_elastic_step(
                lenet.lenet5_forward_int8,
                partition_fn=lambda p, c=c: lenet.partition_at(p, c),
                tail_fcs=tail, lane=int8_lane_cfg(), loss_mode="int")
            state = init_state(lenet.init_lenet5_int8(7, device=device), 13)
            rows[name] = step_memory(step, state, batch_d,
                                     np.ones((1,), np.float32), device)
    return rows


# ------------------------------------------------------------------ #
# Fig. 7 analog: step-time breakdown
# ------------------------------------------------------------------ #
def _timer(device, iters: int) -> Callable[..., float]:
    """t(f, *a): microseconds a call of f(*a), after one warm-up call,
    over ``iters`` back-to-back calls: CUDA events on a card, the host's
    clock on the CPU."""
    def t(f, *a):
        f(*a)
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                f(*a)
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / iters * 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            f(*a)
        return (time.perf_counter() - t0) / iters * 1e6
    return t


def steptime_breakdown(batch=64, iters=20, *, device=None) -> Dict[str, float]:
    """The reference's phases of a LeNet-5 step, in microseconds: fp32
    forward (x2 for the two probe passes), ``zo.perturb`` (x2),
    ``zo.zo_update``, the BP tail's gradient (fc3); int8 forward (x2) and
    ``perturb_int8`` (x2)."""
    device = resolve_device(device)
    xs, ys = _glyphs(batch, 0, 0, 0.0)
    bx = torch.from_numpy(xs).to(device)
    by = torch.from_numpy(ys).to(device)
    t = _timer(device, iters)
    out = {}
    seed = zo.device_seeds([prng.seed_from_key(keys.key_data(1))], device)
    step_size = torch.tensor(1e-4, dtype=torch.float32, device=device)
    with f32_products(), deterministic(), torch.no_grad():
        params = lenet.init_lenet5(0, device=device)
        out["fp32_forward_us"] = t(
            lambda: lenet.lenet5_forward(params, bx)[0]) * 2
        out["fp32_perturb_us"] = t(
            lambda: zo.perturb(params, seed, 1e-3)) * 2
        out["fp32_update_us"] = t(
            lambda: zo.zo_update(params, seed, step_size))
    with f32_products(), deterministic():
        bp_part = {"fc3": {k: v.clone().requires_grad_(True)
                           for k, v in params["fc3"].items()}}

        def tail_grad():
            loss = lenet.lenet5_loss({**params, **bp_part},
                                     {"x": bx, "y": by})
            return torch.autograd.grad(loss, list(bp_part["fc3"].values()))
        out["fp32_bp_tail_us"] = t(tail_grad)
    qparams = lenet.init_lenet5_int8(0, device=device)
    qx = quant_from_float(bx)
    with torch.no_grad():
        out["int8_forward_us"] = t(
            lambda: lenet.lenet5_forward_int8(qparams, qx)[0].data) * 2
        out["int8_perturb_us"] = t(
            lambda: perturb_int8(qparams, seed, 1, 3, 0.33)) * 2
    return out


# ------------------------------------------------------------------ #
# §4.3 claim: integer sign agreement rate
# ------------------------------------------------------------------ #
def sign_agreement(trials=500, classes=10, seed=0, *, device=None):
    """(rate, trials counted) of ``int_loss_sign`` agreeing with the sign
    of the f32 loss difference, over the reference's numpy stream of
    logit pairs (pairs whose f32 losses are equal are not counted)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    agree, total = 0, 0
    for _ in range(trials):
        B = int(rng.choice([1, 4, 16, 32]))
        ea = int(rng.integers(-6, -2))
        eb = ea + int(rng.integers(-1, 2))
        ad = rng.integers(-110, 110, (B, classes))
        bd = np.clip(ad.astype(np.int8) + rng.integers(-25, 25, (B, classes)),
                     -127, 127)
        a = QTensor(torch.from_numpy(ad.astype(np.int8)).to(device),
                    torch.tensor(ea, dtype=torch.int32, device=device))
        b = QTensor(torch.from_numpy(bd.astype(np.int8)).to(device),
                    torch.tensor(eb, dtype=torch.int32, device=device))
        y = torch.from_numpy(rng.integers(0, classes, (B,)).astype(np.int32)
                             ).to(device)
        s_int = int(int_loss_sign(a, b, y))
        d = float(float_loss(a, y) - float_loss(b, y))
        if d == 0.0:
            continue
        total += 1
        agree += (s_int == np.sign(d))
    return agree / total, total
