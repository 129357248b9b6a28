"""Parameters and train states of the JAX package, as numpy arrays, onto
the port.

The port's LM init draws from a ``torch.Generator`` and cannot reproduce
``jax.random``, so every parity test initialises in JAX and converts. The
two packages share the parameter layout (nested dicts with the same keys
and shapes, LM and LeNet-5 alike), so conversion is a leaf-by-leaf copy.
An int8 ``QTensor`` of the JAX package reaches numpy as a (data, exp)
pair and becomes the port's ``QTensor`` exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.elastic import TrainState
from .core.int8 import QTensor


def params_from_jax(tree, device,
                    dtype: Optional[torch.dtype] = torch.float32):
    """Nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``)
    -> the same nested dicts on ``device``: float leaves as ``dtype``
    tensors, or, when ``dtype`` is None, bf16 leaves as bf16 and every
    other leaf as f32 (a bf16 model's f32 MoE router stays f32), (data,
    exp) pairs as ``QTensor``s (int8 data, int32 0-d exponent, exactly).

    bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects; every float leaf goes through float32,
    which holds bf16 and f32 values exactly.
    """
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 \
            and np.asarray(tree[0]).dtype == np.int8:
        data, exp = (np.asarray(a) for a in tree)
        return QTensor(torch.from_numpy(data.copy()).to(device),
                       torch.from_numpy(exp.astype(np.int32).reshape(()))
                       .to(device))
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    own = torch.bfloat16 if str(np.asarray(tree).dtype) == "bfloat16" \
        else torch.float32
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
        device=device, dtype=dtype or own)


def state_from_jax(params, step, seed, device, dtype: torch.dtype):
    """A JAX ``TrainState``'s fields (params as numpy trees, the step and
    the uint32[2] key data, each through ``np.asarray``) -> the port's
    ``TrainState`` (host step, numpy key data)."""
    return TrainState(params_from_jax(params, device, dtype), int(step),
                      np.asarray(seed, np.uint32).copy())
