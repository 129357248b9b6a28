"""PointNet classifier as the paper uses it (Fig. 1 bottom), fp32 and int8.

The port of ``repro/models/pointnet.py``: five pointwise FC layers
(64, 64, 64, 128, 1024), a global max-pool over the points, and a 3-layer
head (512, 256, num_classes). No T-Nets (the paper's 816k-parameter
variant). The int8 (NITI) variant has no biases; every product goes
through the ``int8_matmul`` kernel (``core/int8.py::qdense``), the first
one with K = 3 over B x N rows.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..configs.paper_models import PointNetConfig
from ..core import keys
from ..core.int8 import (QTensor, qdense, qglobal_maxpool, qrelu,
                         quant_from_float)

FEAT = ("feat0", "feat1", "feat2", "feat3", "feat4")
HEAD = ("head0", "head1", "cls")
LAYER_NAMES = FEAT + HEAD


def init_pointnet(seed: int, cfg: PointNetConfig = PointNetConfig(), *,
                  device, dtype=torch.float32):
    """The JAX package's ``init_pointnet(jax.random.key(seed), cfg)``: the
    same threefry streams (``core/keys.py``), weights within a few ulp."""
    key = keys.key_data(seed)

    def layer(name, n_in, n_out):
        w = keys.normal(keys.subkey(key, name), (n_in, n_out)) \
            * np.float32(1.0 / math.sqrt(max(n_in, 1)))
        return {"w": torch.from_numpy(w).to(device=device, dtype=dtype),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    dims = (3,) + tuple(cfg.feat_dims)
    p = {f"feat{i}": layer(f"f{i}", dims[i], dims[i + 1]) for i in range(5)}
    hdims = (cfg.feat_dims[-1],) + tuple(cfg.head_dims) + (cfg.num_classes,)
    for i, n in enumerate(HEAD):
        p[n] = layer(n, hdims[i], hdims[i + 1])
    return p


def pointnet_forward(params, pts):
    """pts: [B,N,3] -> (logits [B,nc], acts).

    The global pool is ``amax``, whose gradient is split evenly among tied
    maxima as XLA's ``reduce_max`` splits it (``max(dim)`` would send it
    all to one index); after the ReLUs many channels tie at 0."""
    acts = {}
    h = pts
    for n in FEAT:
        h = torch.relu(h @ params[n]["w"] + params[n]["b"])
    h = h.amax(dim=1)                            # global feature [B,1024]
    for n in HEAD[:-1]:
        acts[f"{n}_in"] = h
        h = torch.relu(h @ params[n]["w"] + params[n]["b"])
    acts["cls_in"] = h
    logits = h @ params["cls"]["w"] + params["cls"]["b"]
    return logits, acts


def pointnet_loss(params, batch):
    """Mean cross-entropy of batch {"x": [B,N,3], "y": [B] int}."""
    logits, _ = pointnet_forward(params, batch["x"])
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["y"].to(torch.int64)[:, None])[:, 0]
    return torch.mean(logz - ll)


def partition_at(params: Dict, c: int):
    """Paper partition point: first c layers ZO, rest BP."""
    zo = {n: params[n] for n in LAYER_NAMES[:c]}
    bp = {n: params[n] for n in LAYER_NAMES[c:]}
    return zo, bp


# ------------------------------------------------------------------ #
# INT8 (NITI) variant -- no biases, QTensor weights
# ------------------------------------------------------------------ #
def init_pointnet_int8(seed: int, cfg: PointNetConfig = PointNetConfig(), *,
                       device):
    """The JAX package's ``init_pointnet_int8(jax.random.key(seed), cfg)``:
    the fp32 init quantised with ``quant_from_float(bits=6)``."""
    fp = init_pointnet(seed, cfg, device=device)
    return {n: {"w": quant_from_float(fp[n]["w"], bits=6)}
            for n in LAYER_NAMES}


def pointnet_forward_int8(params, pts: QTensor):
    """pts: QTensor [B,N,3] -> (logits QTensor [B,nc], acts)."""
    acts = {}
    h = pts
    for n in FEAT:
        h = qrelu(qdense(h, params[n]["w"]))
    h = qglobal_maxpool(h, axis=1)
    for n in HEAD[:-1]:
        acts[f"{n}_in"] = h
        h = qrelu(qdense(h, params[n]["w"]))
    acts["cls_in"] = h
    logits = qdense(h, params["cls"]["w"])
    return logits, acts
