"""The update engine of the fp32 lanes (full_zo, elastic_zo, full_bp).

The port of the fp32 half of ``repro/core/engine.py``. One train step is

    partition -> probe(seeds, +/-eps) -> loss-diff -> coeff
              -> ZO update -> BP-tail update

with g = clip(delta / 2eps), coeff = eta(t) * g * mask / valid; the ZO
update accumulates the probe contributions in probe order in f32,
subtracts once and casts once per step; the BP tail averages the
perturbed-point gradients and applies one f32-accumulate/cast SGD step.

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
  * the ZO update writes the ZO leaves in place (one ``zo_fused_replay``
    launch per leaf with S = 1): the state passed to a step is consumed,
    as JAX's train loop donates it.

The fused-probe path (``paired_loss_fn``), ``apply_tail_records`` and the
int8 engine are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import LaneConfig
from ..kernels import ops
from ..kernels.zo_fused_replay import MAX_RECORDS
from . import keys, prng, zo


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


def _leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in zo.leaves_with_path(tree)]


def _rebuild(tree, leaves: Sequence[torch.Tensor]):
    it = iter(leaves)
    return zo.map_with_path(lambda _p, _l: next(it), tree)


def _value_and_grad(loss_fn: Callable, bp_part, *args):
    """(loss, grads of the tail leaves): the tail is re-leafed with
    ``requires_grad`` (its storage shared), nothing else is."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(bp_part)]
    loss = loss_fn(_rebuild(bp_part, leaves), *args)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


class Fp32Engine:
    numerics = "fp32"

    def __init__(self, lane: LaneConfig,
                 partition_fn: Optional[Callable] = None,
                 paired_loss_fn: Optional[Callable] = None):
        if paired_loss_fn is not None:
            raise NotImplementedError("fused probes (paired_loss_fn) are not "
                                      "ported yet")
        self.lane = lane
        if partition_fn is None:
            from . import elastic
            partition_fn = lambda p: elastic.partition(p, lane)  # noqa: E731
        self.partition = partition_fn

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
    def zo_apply(zo_part, seeds: torch.Tensor, coeffs: torch.Tensor):
        """theta <- cast(theta_f32 - sum_p coeff_p * z_p), in probe order,
        IN PLACE: one ``zo_fused_replay`` launch per leaf with S = 1.
        seeds int32 [1, P] and coeffs f32 [1, P] on the leaves' device.
        In place is safe: every element is read and then written by the
        same thread. Returns ``zo_part``."""
        for path, leaf in zo.leaves_with_path(zo_part):
            ops.zo_fused_replay(leaf, seeds, coeffs, zo.path_salt(path),
                                out=leaf)
        return zo_part

    # ---- ZO update (ledger domain) ------------------------------------ #
    @staticmethod
    def apply_zo_records(zo_part, seeds: np.ndarray, coeffs: np.ndarray):
        """Apply S committed steps x n probes to every ZO leaf in one fused
        pass (seeds u32 [S, n], coeffs fp32 [S, n]); out of place."""
        seeds = np.asarray(seeds, np.uint64).astype(np.uint32)
        coeffs = np.asarray(coeffs, np.float32)
        n = max(seeds.shape[1], 1)
        chunk = max(MAX_RECORDS // n, 1)     # steps per launch
        out = zo_part
        for s0 in range(0, seeds.shape[0], chunk):
            sl = slice(s0, s0 + chunk)

            def f(path, leaf, sl=sl):
                dev = leaf.device
                sd = zo.device_seeds(seeds[sl].reshape(-1), dev).reshape(
                    seeds[sl].shape)
                cf = torch.from_numpy(coeffs[sl].copy()).to(dev)
                return ops.zo_fused_replay(leaf, sd, cf, zo.path_salt(path))
            out = zo.map_with_path(f, out)
        return out

    # ---- BP-tail update ------------------------------------------------ #
    @staticmethod
    def tail_apply(bp_part, grads: Sequence[torch.Tensor], eta):
        """p <- cast(p_f32 - eta * g_f32), out of place; grads in the
        leaf order of ``bp_part``; eta a host f32."""
        eta = float(np.float32(eta))
        new = [(p.to(torch.float32) - eta * g.to(torch.float32)).to(p.dtype)
               for p, g in zip(_leaves(bp_part), grads)]
        return _rebuild(bp_part, new)

    def apply_tail_records(self, *args, **kwargs):
        raise NotImplementedError("apply_tail_records (the fleet's ledger "
                                  "tail) is not ported yet")

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
            device = _leaves(zo_part)[0].device
            seeds = zo.device_seeds(
                [prng.seed_from_key(keys.fold_in(key, i)) for i in range(n)],
                device)
            valid = float(max(float(probe_mask.sum()), 1.0))
            tail_grad = None
            coeffs, loss_acc, g_acc = [], 0.0, 0.0
            for i in range(n):
                seed, m = seeds[i:i + 1], float(probe_mask[i])
                if has_tail:
                    zp = zo.perturb(zo_part, seed, eps)
                    lp, gp = _value_and_grad(tail_loss, bp_part, zp)
                    del zp                  # free +eps before -eps
                    zm = zo.perturb(zo_part, seed, -eps)
                    lm, gm = _value_and_grad(tail_loss, bp_part, zm)
                    del zm
                    if lane.bp_grad_mode == "clean":
                        _, g_tail = _value_and_grad(tail_loss, bp_part,
                                                    zo_part)
                    else:
                        g_tail = [(a + b) * 0.5 for a, b in zip(gp, gm)]
                    del gp, gm
                    g_tail = [m * g.to(torch.float32) for g in g_tail]
                    tail_grad = g_tail if tail_grad is None else \
                        [a + b for a, b in zip(tail_grad, g_tail)]
                else:
                    with torch.no_grad():
                        zp = zo.perturb(zo_part, seed, eps)
                        lp = loss_fn(merge(zp, bp_part), batch)
                        del zp
                        zm = zo.perturb(zo_part, seed, -eps)
                        lm = loss_fn(merge(zm, bp_part), batch)
                        del zm
                g = zo.projected_gradient(lp, lm, eps, lane.zo_clip) * m
                coeffs.append(eta_zo * g / valid)
                loss_acc = loss_acc + 0.5 * (lp + lm) * m
                g_acc = g_acc + torch.abs(g)

            new_zo = self.zo_apply(zo_part, seeds.reshape(1, n),
                                   torch.stack(coeffs).reshape(1, n))
            if has_tail:
                tail_grad = [g / valid for g in tail_grad]
                new_bp = self.tail_apply(bp_part, tail_grad, eta_tail)
            else:
                new_bp = bp_part
            metrics = {"loss": loss_acc / valid, "zo_g": g_acc / n}
            return (TrainState(merge(new_zo, new_bp), state.step + 1,
                               state.seed), metrics)

        return step
