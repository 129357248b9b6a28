"""Parameters and train states of the JAX package, as numpy arrays, onto
the port.

The port's LM init draws from a ``torch.Generator`` and cannot reproduce
``jax.random``, so every parity test initialises in JAX and converts. The
two packages share the parameter layout (nested dicts with the same keys
and shapes, LM and LeNet-5 alike), so conversion is a leaf-by-leaf copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.elastic import TrainState
from .models.transformer import tree_map


def params_from_jax(tree, device, dtype: torch.dtype):
    """Nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``)
    -> the same nested dicts of ``dtype`` tensors on ``device``.

    bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects; every leaf goes through float32, which
    holds bf16 and f32 values exactly.
    """
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype),
        tree)


def state_from_jax(params, step, seed, device, dtype: torch.dtype):
    """A JAX ``TrainState``'s fields (params as numpy trees, the step and
    the uint32[2] key data, each through ``np.asarray``) -> the port's
    ``TrainState`` (host step, numpy key data)."""
    return TrainState(params_from_jax(params, device, dtype), int(step),
                      np.asarray(seed, np.uint32).copy())
