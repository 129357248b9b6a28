"""The lane-polymorphic update engine.

The port of ``repro/core/engine.py``. One train step is

    partition -> probe(seeds, +/-eps) -> loss-diff -> coeff
              -> ZO update -> BP-tail update

with a numerics plugin per lane:

  * ``Fp32Engine`` (full_zo, elastic_zo, full_bp; Alg. 1): g =
    clip(delta / 2eps), coeff = eta(t) * g * mask / valid; the ZO update
    accumulates the probe contributions in probe order in f32, subtracts
    once and casts once per step; the BP tail averages the
    perturbed-point gradients and applies one f32-accumulate/cast SGD
    step.
  * ``Int8Engine`` (elastic_zo_int8; Alg. 2): g = sgn(L+ - L-) in {-1, 0,
    +1} (from integer logits, ``core/int_loss.py``, or the sign of the
    f32 loss difference); the ZO update sums psr(g * z, shift) in int32
    in probe order and clamps once per step; the BP tail is the NITI FC
    backward, combined as a saturating int8 sum.

How the JAX step maps onto eager PyTorch:

  * probe seeds are host integers: ``fold_in(fold_in(seed, step), i)``
    through the numpy threefry twin (``core/keys.py``), uploaded once per
    step to a device int32 buffer without blocking;
  * the coefficients stay on the device as an f32 [1, P] tensor, so no
    step synchronises to read them;
  * the ``stop_gradient`` cut: ZO leaves never require grad, so autograd
    records nothing for the ZO head; passes without a tail run under
    ``torch.no_grad()``, and only the tail's leaves are differentiated;
  * the +eps copy is freed before the -eps perturbation (JAX orders the
    two with ``optimization_barrier`` for the same reason);
  * with a fused probe pair (``paired_loss_fn``, lanes with a tail) no
    perturbed copy of the head exists: both streams advance together one
    period's perturbed slice at a time, and one backward of the mean of
    the two losses gives the averaged tail gradient;
  * the ZO update writes the ZO leaves in place (one ``zo_fused_replay``
    launch per leaf with S = 1): the state passed to a step is consumed,
    as JAX's train loop donates it.

On a mesh (``run``, a ``sharding/collectives.py::MeshRun``) each rank
holds its shards: the probes perturb them and the update replays at each
shard's global flat indices, with no communication; the loss (and so
every coefficient) is the global one on every rank, which the step
asserts bitwise; the tail's gradients reach each rank's shards through
the sharded forward's collectives (reduce-scatter over `data` for FSDP
shards).

The int8 engine follows the same design: probe seeds from the numpy
threefry twin, the +1/-1 perturbations one ``int8_perturb`` launch each
for all ZO leaves, the ternary g kept on the device as an int32 [1, P]
tensor and the update one in-place ``zo_fused_replay_int8`` launch for all
ZO leaves, so live == replay bitwise and no step reads g on the host.

``apply_tail_records`` is the fleet's ledger tail: the accepted workers'
tail payloads, decoded from the wire, summed in worker-id order and
applied once (``fleet/replay.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import LaneConfig
from ..kernels import ops
from ..kernels.zo_fused_replay import MAX_RECORDS
from . import keys, prng, zo
from .int8 import (QTensor, fc_backward_int8, output_error_int8,
                   perturb_int8, replay_int8, zo_shift)
from .int_loss import float_loss, int_loss_sign


# ------------------------------------------------------------------ #
# shared scalar schedule
# ------------------------------------------------------------------ #
def decay_traced(lane: LaneConfig, step: torch.Tensor) -> torch.Tensor:
    """The lr decay factor of a device step counter (f32 scalar)."""
    if lane.lr_decay_every <= 0 or lane.lr_decay_factor == 1.0:
        return torch.ones((), dtype=torch.float32, device=step.device)
    k = torch.floor(step.to(torch.float32) / lane.lr_decay_every)
    return torch.pow(torch.tensor(lane.lr_decay_factor, dtype=torch.float32,
                                  device=step.device), k)


def decay_host(lane: LaneConfig, step: int) -> np.float32:
    """Strict-fp32 host twin of ``decay_traced`` (the step index is on the
    host, so the port's step uses this one)."""
    if lane.lr_decay_every <= 0 or lane.lr_decay_factor == 1.0:
        return np.float32(1.0)
    k = np.float32(np.floor(np.float32(step) / np.float32(lane.lr_decay_every)))
    return np.power(np.float32(lane.lr_decay_factor), k)


def tail_learning_rate(lane: LaneConfig) -> float:
    # `is None` test: an explicit tail LR of 0.0 means "freeze the tail"
    return lane.learning_rate if lane.tail_learning_rate is None \
        else lane.tail_learning_rate


def _releaf(bp_part):
    """The tail's leaves re-leafed with ``requires_grad`` (storage
    shared). An empty leaf (the zero-period ``periods_bp`` of a
    one-period stack) takes no part in the graph and stays as it is."""
    return [t.detach().requires_grad_(t.numel() > 0)
            for t in zo.leaves(bp_part)]


def _grads(loss, leaves):
    """d loss / d leaf for every leaf; an empty leaf's is empty."""
    live = [t for t in leaves if t.requires_grad]
    it = iter(torch.autograd.grad(loss, live))
    return [next(it) if t.requires_grad else torch.zeros_like(t)
            for t in leaves]


def _value_and_grad(loss_fn: Callable, bp_part, *args):
    """(loss, grads of the tail leaves): the tail is re-leafed with
    ``requires_grad``, nothing else is."""
    leaves = _releaf(bp_part)
    loss = loss_fn(zo.rebuild(bp_part, leaves), *args)
    return loss.detach(), _grads(loss, leaves)


def _paired_value_and_grad(paired_loss_fn: Callable, bp_part, *args):
    """(l+, l-, grads of 0.5 (l+ + l-) over the tail leaves), one
    backward."""
    leaves = _releaf(bp_part)
    lp, lm = paired_loss_fn(zo.rebuild(bp_part, leaves), *args)
    return lp.detach(), lm.detach(), _grads(0.5 * (lp + lm), leaves)


def _apply_records(zo_part, seeds: np.ndarray, values: np.ndarray, launch):
    """S committed steps x n probe records on every ZO leaf, out of place,
    at most MAX_RECORDS records a launch. ``launch(tree, seeds, values)``
    gets the records as tensors on the leaves' device and returns the
    updated tree."""
    seeds = np.asarray(seeds, np.uint64).astype(np.uint32)
    leaves = [leaf for _, leaf in zo.leaves_with_path(zo_part)]
    if not leaves:
        return zo_part
    dev = (leaves[0].data if isinstance(leaves[0], QTensor)
           else leaves[0]).device
    chunk = max(MAX_RECORDS // max(seeds.shape[1], 1), 1)   # steps a launch
    out = zo_part
    for s0 in range(0, seeds.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        sd = zo.device_seeds(seeds[sl].reshape(-1), dev).reshape(
            seeds[sl].shape)
        out = launch(out, sd, torch.from_numpy(values[sl].copy()).to(dev))
    return out


def _partition_for(lane: LaneConfig, partition_fn: Optional[Callable]):
    if partition_fn is None:
        from . import elastic
        partition_fn = lambda p: elastic.partition(p, lane)  # noqa: E731
    return partition_fn


class Fp32Engine:
    numerics = "fp32"

    def __init__(self, lane: LaneConfig,
                 partition_fn: Optional[Callable] = None,
                 paired_loss_fn: Optional[Callable] = None, run=None):
        self.lane = lane
        self.paired_loss_fn = paired_loss_fn
        self.partition = _partition_for(lane, partition_fn)
        self.run = run
        self.maps = None if run is None else run.index_maps()

    # ---- coeff transform (ledger domain, strict fp32) ----------------- #
    def host_coeffs(self, step: int, deltas: np.ndarray, mask: np.ndarray):
        """(coeffs fp32[n], valid): coeff_i = eta(t)*clip(d_i/2eps)*m_i/valid."""
        lane = self.lane
        deltas = np.asarray(deltas, np.float32)
        mask = np.asarray(mask, np.float32)
        g = deltas / np.float32(2.0 * lane.zo_eps)
        if lane.zo_clip is not None and lane.zo_clip > 0:
            g = np.clip(g, np.float32(-lane.zo_clip), np.float32(lane.zo_clip))
        g = g * mask
        valid = np.float32(max(float(mask.sum()), 1.0))
        eta = np.float32(lane.learning_rate) * decay_host(lane, step)
        return (eta * g) / valid, valid

    # ---- ZO update (live) --------------------------------------------- #
    @staticmethod
    def zo_apply(zo_part, seeds: torch.Tensor, coeffs: torch.Tensor,
                 maps=None):
        """theta <- cast(theta_f32 - sum_p coeff_p * z_p), in probe order,
        IN PLACE: one ``zo_fused_replay`` launch per leaf with S = 1.
        seeds int32 [1, P] and coeffs f32 [1, P] on the leaves' device.
        In place is safe: every element is read and then written by the
        same thread. ``maps``: each shard's index map on a mesh. Returns
        ``zo_part``."""
        for path, leaf in zo.leaves_with_path(zo_part):
            ops.zo_fused_replay(leaf, seeds, coeffs, zo.path_salt(path),
                                out=leaf, index=zo._at(maps, path))
        return zo_part

    # ---- ZO update (ledger domain) ------------------------------------ #
    @staticmethod
    def apply_zo_records(zo_part, seeds: np.ndarray, coeffs: np.ndarray):
        """Apply S committed steps x n probes to every ZO leaf in one fused
        pass (seeds u32 [S, n], coeffs fp32 [S, n]); out of place."""
        return _apply_records(
            zo_part, seeds, np.asarray(coeffs, np.float32),
            lambda tree, sd, cf: zo.map_with_path(
                lambda path, leaf: ops.zo_fused_replay(
                    leaf, sd, cf, zo.path_salt(path)), tree))

    # ---- BP-tail update ------------------------------------------------ #
    @staticmethod
    def tail_apply(bp_part, grads: Sequence[torch.Tensor], eta):
        """p <- cast(p_f32 - eta * g_f32), out of place; grads in the
        leaf order of ``bp_part``; eta a host f32."""
        eta = float(np.float32(eta))
        new = [(p.to(torch.float32) - eta * g.to(torch.float32)).to(p.dtype)
               for p, g in zip(zo.leaves(bp_part), grads)]
        return zo.rebuild(bp_part, new)

    def apply_tail_records(self, bp_part, step: int, worker_grads,
                           valid: np.float32):
        """Ledger-domain tail: sum the accepted workers' dequantised grad
        trees (an iterable, worker-id order), divide by ``valid``, apply
        with eta_tail * decay as a host f32. Out of place."""
        if not zo.leaves(bp_part):
            return bp_part
        acc = None
        for part in worker_grads:
            g = zo.leaves(part)
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        if acc is None:
            return bp_part
        valid = float(np.float32(valid))
        eta = np.float32(tail_learning_rate(self.lane)) \
            * decay_host(self.lane, step)
        return self.tail_apply(bp_part, [a / valid for a in acc], eta)

    # ---- the train step ------------------------------------------------ #
    def make_step(self, loss_fn: Callable[[Any, Any], torch.Tensor]):
        """(state, batch, probe_mask fp32[n] host array) -> (state, metrics).

        metrics are f32 scalar tensors on the device ("loss", "zo_g"); the
        caller reads them when it needs them."""
        from .elastic import TrainState, merge
        lane = self.lane
        n = lane.zo_num_probes
        base_eta_tail = tail_learning_rate(lane)
        eps = lane.zo_eps
        paired_loss_fn = self.paired_loss_fn
        run, all_maps = self.run, self.maps

        def step(state: TrainState, batch, probe_mask):
            probe_mask = np.asarray(probe_mask, np.float32)
            if probe_mask.shape != (n,):
                raise ValueError(
                    f"probe_mask has shape {probe_mask.shape} but lane "
                    f"{lane.lane!r} runs {n} probes — derive LoopConfig."
                    "n_probes from the lane (LoopConfig.for_lane)")
            decay = decay_host(lane, state.step)
            eta_zo = float(np.float32(lane.learning_rate) * decay)
            eta_tail = np.float32(base_eta_tail) * decay
            zo_part, bp_part = self.partition(state.params)
            maps = None if all_maps is None else self.partition(all_maps)[0]
            key = keys.fold_in(state.seed, state.step)

            if lane.lane == "full_bp":
                loss, grads = _value_and_grad(loss_fn, bp_part, batch)
                new_params = self.tail_apply(bp_part, grads, eta_tail)
                metrics = {"loss": loss, "zo_g": torch.zeros_like(loss)}
                return (TrainState(new_params, state.step + 1, state.seed),
                        metrics)

            def tail_loss(bp, zo_pert):
                return loss_fn(merge(zo_pert, bp), batch)

            has_tail = bool(bp_part) and lane.lane == "elastic_zo"
            device = zo.leaves(zo_part)[0].device
            seeds = zo.device_seeds(
                [prng.seed_from_key(keys.fold_in(key, i)) for i in range(n)],
                device)
            valid = float(max(float(probe_mask.sum()), 1.0))
            tail_grad = None
            coeffs, loss_acc, g_acc = [], 0.0, 0.0
            for i in range(n):
                seed, m = seeds[i:i + 1], float(probe_mask[i])
                if paired_loss_fn is not None and has_tail:
                    # fused antithetic pair: the grad of the mean IS the
                    # averaged tail grad
                    lp, lm, g_tail = _paired_value_and_grad(
                        paired_loss_fn, bp_part, zo_part, batch, seed)
                elif has_tail:
                    zp = zo.perturb(zo_part, seed, eps, maps)
                    lp, gp = _value_and_grad(tail_loss, bp_part, zp)
                    del zp                  # free +eps before -eps
                    zm = zo.perturb(zo_part, seed, -eps, maps)
                    lm, gm = _value_and_grad(tail_loss, bp_part, zm)
                    del zm
                    if lane.bp_grad_mode == "clean":
                        _, g_tail = _value_and_grad(tail_loss, bp_part,
                                                    zo_part)
                    else:
                        g_tail = [(a + b) * 0.5 for a, b in zip(gp, gm)]
                    del gp, gm
                else:
                    with torch.no_grad():
                        zp = zo.perturb(zo_part, seed, eps, maps)
                        lp = loss_fn(merge(zp, bp_part), batch)
                        del zp
                        zm = zo.perturb(zo_part, seed, -eps, maps)
                        lm = loss_fn(merge(zm, bp_part), batch)
                        del zm
                if has_tail:
                    g_tail = [m * g.to(torch.float32) for g in g_tail]
                    tail_grad = g_tail if tail_grad is None else \
                        [a + b for a, b in zip(tail_grad, g_tail)]
                g = zo.projected_gradient(lp, lm, eps, lane.zo_clip) * m
                coeffs.append(eta_zo * g / valid)
                loss_acc = loss_acc + 0.5 * (lp + lm) * m
                g_acc = g_acc + torch.abs(g)

            coeffs = torch.stack(coeffs).reshape(1, n)
            if run is not None:
                run.same_on_all_ranks(coeffs, "the ZO coefficients")
            new_zo = self.zo_apply(zo_part, seeds.reshape(1, n), coeffs,
                                   maps)
            if has_tail:
                tail_grad = [g / valid for g in tail_grad]
                new_bp = self.tail_apply(bp_part, tail_grad, eta_tail)
            else:
                new_bp = bp_part
            metrics = {"loss": loss_acc / valid, "zo_g": g_acc / n}
            return (TrainState(merge(new_zo, new_bp), state.step + 1,
                               state.seed), metrics)

        return step


# ------------------------------------------------------------------ #
# int8 lane (Alg. 2)
# ------------------------------------------------------------------ #
class Int8Engine:
    numerics = "int8"

    def __init__(self, lane: LaneConfig,
                 partition_fn: Optional[Callable] = None,
                 tail_fcs: Optional[List[Tuple[str, str]]] = None,
                 loss_mode: Optional[str] = None,
                 p_zero: Optional[float] = None):
        self.lane = lane
        self.partition = _partition_for(lane, partition_fn)
        self.tail_fcs = tail_fcs or []
        self.loss_mode = lane.int8_loss_mode if loss_mode is None \
            else loss_mode
        if self.loss_mode not in ("int", "float"):
            raise ValueError(f"loss_mode {self.loss_mode!r} is not 'int' or "
                             "'float'")
        self.r_max = lane.int8_r_max
        self.p_zero = lane.int8_p_zero if p_zero is None else p_zero
        self.zo_shift = zo_shift(self.r_max, lane.int8_b_zo)

    # ---- coeff transform (ledger domain) ------------------------------ #
    @staticmethod
    def host_coeffs(step: int, gs: np.ndarray, mask: np.ndarray):
        """(coeffs int32[n], valid): the int8 coeff IS the masked ternary
        sign, never renormalised (a masked probe has g = 0, an exact no-op
        of the integer update)."""
        gs = np.asarray(gs, np.int32)
        mask = np.asarray(mask, np.float32)
        valid = np.float32(max(float(mask.sum()), 1.0))
        return gs * mask.astype(np.int32), valid

    # ---- ZO update (live) --------------------------------------------- #
    def zo_apply(self, zo_part, seeds: torch.Tensor, gs: torch.Tensor):
        """theta <- clamp(theta - sum_p psr(g_p * z_p, shift), -127, 127) in
        probe order, IN PLACE: one ``zo_fused_replay_int8`` launch for all
        QTensor leaves with S = 1. seeds int32 [1, P] and gs int32 [1, P]
        on the leaves' device. Returns ``zo_part``."""
        return replay_int8(zo_part, seeds, gs, self.r_max, self.p_zero,
                           self.zo_shift, in_place=True)

    # ---- ZO update (ledger domain) ------------------------------------ #
    def apply_zo_records(self, zo_part, seeds: np.ndarray, gs: np.ndarray):
        """S committed steps x n probes on every int8 QTensor leaf (seeds
        u32 [S, n], gs int32 [S, n]; masked probes g = 0); out of place,
        one launch for all leaves a chunk of MAX_RECORDS records."""
        return _apply_records(
            zo_part, seeds, np.asarray(gs, np.int32),
            lambda tree, sd, g: replay_int8(tree, sd, g, self.r_max,
                                            self.p_zero, self.zo_shift))

    # ---- probe phase --------------------------------------------------- #
    def probe_pair(self, forward: Callable, zo_part, bp_part, batch,
                   seed: torch.Tensor):
        """One probe's Alg. 2 evaluation: the +1 and -1 perturbed copies
        (one ``int8_perturb`` launch for all ZO leaves each, the +1 copy
        freed before the -1 one), two integer forwards, the ternary loss
        difference. seed: int32 [1] on the device. Returns (g int32 0-d,
        logits_p, acts_p)."""
        zo_p = perturb_int8(zo_part, seed, +1, self.r_max, self.p_zero)
        logits_p, acts_p = forward({**zo_p, **bp_part}, batch["x"])
        del zo_p
        zo_m = perturb_int8(zo_part, seed, -1, self.r_max, self.p_zero)
        logits_m, _ = forward({**zo_m, **bp_part}, batch["x"])
        del zo_m
        if self.loss_mode == "int":
            g = int_loss_sign(logits_p, logits_m, batch["y"])
        else:
            g = torch.sign(float_loss(logits_p, batch["y"])
                           - float_loss(logits_m, batch["y"])).to(torch.int32)
        return g, logits_p, acts_p

    # ---- BP tail ------------------------------------------------------- #
    def tail_updates(self, bp_part, acts, logits, labels):
        """One probe's NITI backward: {layer: upd int32} (not applied). The
        error chain uses the pre-update weights, so computing every update
        first and applying once is the sequential Alg. 2 application."""
        upds: Dict[str, torch.Tensor] = {}
        if not self.tail_fcs:
            return upds
        e = output_error_int8(logits, labels)
        for name, act_key in reversed(self.tail_fcs):
            w = bp_part[name]["w"]
            a_in = acts[act_key]
            new_w, e = fc_backward_int8(w, a_in, e, self.lane.int8_b_bp)
            upds[name] = w.data.to(torch.int32) - new_w.data.to(torch.int32)
            # relu mask of the propagated error (the previous layer's
            # pre-activation is > 0 exactly where its output is)
            e = e * (a_in.data > 0)
        return upds

    @staticmethod
    def combine_tail(upds_list: Sequence[Dict[str, torch.Tensor]]):
        """Saturating-int8 combine of the per-probe updates."""
        acc: Dict[str, torch.Tensor] = {}
        for upds in upds_list:
            for name, u in upds.items():
                acc[name] = u if name not in acc else acc[name] + u
        return {n: torch.clamp(u, -127, 127).to(torch.int8)
                for n, u in acc.items()}

    @staticmethod
    def tail_apply(bp_part, combined: Dict[str, torch.Tensor]):
        """w <- clamp(w - sum(upd), -127, 127), out of place; exponents
        unchanged."""
        new_bp = dict(bp_part)
        for name, u in combined.items():
            w = bp_part[name]["w"]
            d = torch.clamp(w.data.to(torch.int32) - u.to(torch.int32),
                            -127, 127)
            new_bp[name] = {"w": QTensor(d.to(torch.int8), w.exp)}
        return new_bp

    def apply_tail_records(self, bp_part, step: int, worker_upds,
                           valid=None):
        """Ledger-domain tail: the int32 sum of the accepted workers' int8
        payload trees (``{layer: {"w": upd}}``; exact, order-free), then
        one saturating apply. Out of place."""
        if not zo.leaves(bp_part):
            return bp_part
        acc = None
        for part in worker_upds:
            part = {n: sub["w"].to(torch.int32) for n, sub in part.items()}
            acc = part if acc is None else {n: acc[n] + u
                                            for n, u in part.items()}
        if acc is None:
            return bp_part
        return self.tail_apply(bp_part, acc)

    # ---- the train step ------------------------------------------------ #
    def make_step(self, forward: Callable):
        """forward(params, x QTensor) -> (logits QTensor, acts). Returned
        step: (state, batch {"x": QTensor, "y": int}, probe_mask fp32[n]
        host array) -> (state, metrics). metrics are f32 0-d tensors on the
        device ("loss", "g", "acc"); the caller reads them when it needs
        them."""
        from .elastic import TrainState
        lane = self.lane
        n = lane.zo_num_probes

        def step(state: TrainState, batch, probe_mask):
            probe_mask = np.asarray(probe_mask, np.float32)
            if probe_mask.shape != (n,):
                raise ValueError(
                    f"probe_mask has shape {probe_mask.shape} but lane "
                    f"{lane.lane!r} runs {n} probes")
            zo_part, bp_part = self.partition(state.params)
            key = keys.fold_in(state.seed, state.step)
            device = batch["y"].device
            seeds = zo.device_seeds(
                [prng.seed_from_key(keys.fold_in(key, i)) for i in range(n)],
                device)
            valid = float(np.float32(max(float(probe_mask.sum()), 1.0)))
            gs, tail_upds = [], []
            loss_acc = g_acc = acc_acc = 0.0
            for i in range(n):
                m = float(probe_mask[i])
                g, logits_p, acts_p = self.probe_pair(
                    forward, zo_part, bp_part, batch, seeds[i:i + 1])
                g = g * int(m)
                gs.append(g)
                upds = self.tail_updates(bp_part, acts_p, logits_p,
                                         batch["y"])
                tail_upds.append({k: int(m) * u for k, u in upds.items()})
                loss_acc = loss_acc + float_loss(logits_p, batch["y"]) * m
                g_acc = g_acc + g.to(torch.float32)
                acc_acc = acc_acc + m * (logits_p.data.argmax(-1)
                                         == batch["y"]).to(torch.float32) \
                    .mean()
            new_zo = self.zo_apply(zo_part, seeds.reshape(1, n),
                                   torch.stack(gs).reshape(1, n))
            new_bp = self.tail_apply(bp_part, self.combine_tail(tail_upds)) \
                if self.tail_fcs else dict(bp_part)
            metrics = {"loss": loss_acc / valid, "g": g_acc / valid,
                       "acc": acc_acc / valid}
            return (TrainState({**new_zo, **new_bp}, state.step + 1,
                               state.seed), metrics)

        return step


def engine_for(lane: LaneConfig, partition_fn: Optional[Callable] = None,
               **kwargs):
    """The one lane -> numerics-plugin mapping."""
    if lane.lane == "elastic_zo_int8":
        return Int8Engine(lane, partition_fn, **kwargs)
    return Fp32Engine(lane, partition_fn, **kwargs)


# ------------------------------------------------------------------ #
# phase profiler (diagnostic path, opt-in)
# ------------------------------------------------------------------ #
def clone_tree(tree):
    """A copy of a param tree, every tensor cloned (a ``QTensor``'s two)."""
    return zo.map_with_path(
        lambda _p, t: QTensor(t.data.clone(), t.exp.clone())
        if isinstance(t, QTensor) else t.clone(), tree)


def profile_step_phases(engine: Fp32Engine, loss_fn: Callable, state, batch,
                        iters: int = 3) -> Dict[str, float]:
    """Time the canonical phases of an fp32 lane's step one by one;
    returns {phase: mean_us} (``repro/core/engine.py::
    profile_step_phases``, whose int8 branch no launcher reaches: the
    train launcher's lanes are fp32).

    A diagnostic decomposition, separate from the production step, which
    it leaves as it is: each phase is its own call, run once to warm up
    and then ``iters`` times, each time between two device syncs (on the
    card the host would otherwise only time the launches). The phases run
    the kernels the step runs. The parameter state is never written: the
    in-place ZO update runs on a fresh copy of the ZO part each time, the
    copy made outside the timed window. Spans land on the "engine" track
    of the active recorder, plus ``engine.phase.<name>_ms`` histograms.

    The phases: partition, probe (the ±eps forwards of every probe, the
    fused pair's when the engine has one), loss_diff, coeff, zo_update,
    and, for a lane with a BP tail, bp_tail (the tail's gradient at
    theta) and tail_update (its SGD step); the reference times those two
    as one ``bp_tail`` phase.
    """
    from .. import obs
    from .elastic import merge
    rec = obs.get()
    lane = engine.lane
    n = lane.zo_num_probes
    eps = lane.zo_eps
    params = state.params
    key = keys.fold_in(state.seed, state.step)
    device = zo.leaves(params)[0].device
    seeds = zo.device_seeds(
        [prng.seed_from_key(keys.fold_in(key, i)) for i in range(n)], device)
    mask = np.ones((n,), np.float32)
    out: Dict[str, float] = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(name, f, prep=lambda: ()):
        f(*prep())                                  # warm
        sync()
        tot = 0.0
        for _ in range(iters):
            args = prep()
            sync()
            with rec.span(f"engine/{name}", track="engine") as sp:
                t0 = obs.monotonic()
                f(*args)
                sync()
                tot += obs.monotonic() - t0
            rec.histogram(f"engine.phase.{name}_ms").observe(sp.dur_ns / 1e6)
        out[name] = tot / iters * 1e6

    timed("partition", lambda: engine.partition(params))
    zo_part, bp_part = engine.partition(params)
    has_tail = bool(zo.leaves(bp_part)) and lane.lane == "elastic_zo"
    paired = engine.paired_loss_fn if has_tail else None

    def probe():
        ls = []
        with torch.no_grad():
            for i in range(n):
                seed = seeds[i:i + 1]
                if paired is not None:
                    ls.extend(paired(bp_part, zo_part, batch, seed))
                    continue
                for scale in (eps, -eps):
                    ls.append(loss_fn(merge(zo.perturb(zo_part, seed, scale),
                                            bp_part), batch))
        return torch.stack(ls)
    losses = probe().cpu().numpy()
    timed("probe", probe)
    lp, lm = losses[0::2], losses[1::2]
    timed("loss_diff", lambda: np.float32(lp) - np.float32(lm))
    deltas = np.float32(lp) - np.float32(lm)
    timed("coeff", lambda: engine.host_coeffs(int(state.step), deltas, mask))
    coeffs, _ = engine.host_coeffs(int(state.step), deltas, mask)
    c_dev = torch.from_numpy(np.asarray(coeffs, np.float32)).to(device)
    timed("zo_update", lambda zp: engine.zo_apply(
        zp, seeds.reshape(1, n), c_dev.reshape(1, n)),
        lambda: (clone_tree(zo_part),))
    if has_tail:
        def tail_grad():
            return _value_and_grad(lambda b: loss_fn(merge(zo_part, b),
                                                     batch), bp_part)[1]
        grads = tail_grad()
        eta = np.float32(tail_learning_rate(lane))
        timed("bp_tail", tail_grad)
        timed("tail_update", lambda: engine.tail_apply(bp_part, grads, eta))
    return out


# ------------------------------------------------------------------ #
# step memory analysis (diagnostic path, opt-in)
# ------------------------------------------------------------------ #
def step_memory_analysis(step_fn: Callable, state, batch,
                         probe_mask) -> Optional[Dict[str, int]]:
    """The measured device footprint of ONE train step: argument, output,
    temp, alias and peak bytes (``obs/memory.py::step_footprint``), the
    measured twin of the paper's memory model (Eqs. 2-4 / 13-15); None
    on the CPU.

    The reference compiles the step and reads XLA's buffer assignment
    without running it. Here the step runs, twice (a warm step, then the
    measured one), on a copy of ``state``'s params, so the caller's state
    is left as it was; the copy is made before the measurement and is
    not counted."""
    from ..obs.memory import step_footprint
    from .elastic import TrainState
    params = clone_tree(state.params)
    first = zo.leaves(params)[0]
    device = (first.data if isinstance(first, QTensor) else first).device
    return step_footprint(step_fn, TrainState(params, state.step, state.seed),
                          batch, np.asarray(probe_mask, np.float32), device)
