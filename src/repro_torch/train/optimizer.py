"""Optimizers and schedules over the port's param trees.

The port of ``repro/train/optimizer.py``. The paper uses vanilla SGD (no
momentum or weight decay) with a 0.8x / 10-epoch decay for fp32 training
and Adam for the fine-tuning's pre-training; all are provided for the
BP-tail and full-BP lanes (the ZO update lives in ``core/zo.py``).

Trees are nested dicts (or lists and tuples) of tensors. The arithmetic
is the reference's, in f32: updates are f32 even for bf16 params,
``apply_updates`` casts ``p.f32 - u`` back to the param's dtype, and the
schedules and Adam's bias correction compute on f32 0-d tensors (a
Python float is f64, and a schedule computed in Python drifts from JAX
in the last bits). ``update(grads, state, step) -> (updates, state)``
takes ``step`` as an ``int`` or a 0-d tensor; a learning rate is a float
or a schedule ``step -> f32 0-d tensor``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from ..models.transformer import tree_map

F32 = torch.float32
Schedule = Callable[[Any], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # update(grads, opt_state, step) -> (updates, opt_state); the
    # learning rate is folded in: updates are the deltas to subtract
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _f32_step(step) -> torch.Tensor:
    """``step.astype(f32)`` of an int or a 0-d tensor."""
    return torch.as_tensor(step).to(F32)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``jnp.float32(x)`` on ``like``'s device."""
    return torch.tensor(x, dtype=F32, device=like.device)


def _lr_fn(lr: Union[Schedule, float]) -> Schedule:
    if callable(lr):
        return lr
    return lambda _: torch.tensor(lr, dtype=F32)


def _f32(g: torch.Tensor) -> torch.Tensor:
    return g.to(F32)


def sgd(lr: Union[Schedule, float], momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device), params)

    def update(grads, state, step):
        eta = lr_fn(step)
        if momentum == 0.0:
            return tree_map(lambda g: eta * _f32(g), grads), ()
        new_m = tree_map(lambda m, g: momentum * m + _f32(g), state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: eta * (momentum * m + _f32(g)),
                           new_m, grads)
        else:
            upd = tree_map(lambda m: eta * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


def adam(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, step):
        t = _f32_step(step) + 1.0
        c1 = 1 - torch.pow(_scalar(b1, t), t)
        c2 = 1 - torch.pow(_scalar(b2, t), t)
        eta = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * _f32(g),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(_f32(g)),
                     state["v"], grads)

        def u(m_, v_):
            # the corrections on the leaf's device: a CUDA tensor divided
            # by a host scalar is multiplied by its reciprocal instead
            k1, k2 = c1.to(m_.device), c2.to(m_.device)
            return eta * (m_ / k1) / (torch.sqrt(v_ / k2) + eps)
        upd = tree_map(u, m, v)
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``(p.f32 - u).astype(p.dtype)`` leaf by leaf: new tensors."""
    return tree_map(lambda p, u: (p.to(F32) - u).to(p.dtype), params, updates)


# ------------------------------ schedules ---------------------------- #
def step_decay(base: float, factor: float = 0.8,
               every: int = 10_000) -> Schedule:
    """The paper's schedule: decay by ``factor`` every ``every`` steps (10
    epochs)."""
    def f(step):
        k = torch.floor(_f32_step(step) / every)
        return _scalar(base, k) * torch.pow(_scalar(factor, k), k)
    return f


def cosine(base: float, total: int, warmup: int = 0,
           floor: float = 0.0) -> Schedule:
    def f(step):
        s = _f32_step(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return _scalar(base, s) * (warm if warmup > 0
                                   else _scalar(1.0, s)) * cos
    return f
