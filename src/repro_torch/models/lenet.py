"""LeNet-5 as the paper uses it (Fig. 1 top), fp32 and int8.

The port of ``repro/models/lenet.py``: same-padding 5x5 convs, 2x2
max-pools, a 784->120->84->10 FC head, 107,786 fp32 parameters. The public
functions keep the JAX package's layouts, NHWC activations and HWIO conv
weights; the fp32 forward permutes to NCHW/OIHW for ``F.conv2d`` inside.
The int8 (NITI) variant has no biases and 107,550 int8 weights in five
``QTensor``s; its convolutions are im2col products through the
``int8_matmul`` kernel (``core/int8.py``).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.paper_models import LeNet5Config
from ..core import keys
from ..core.int8 import (QTensor, qconv2d, qdense, qmaxpool2, qrelu,
                         quant_from_float)

LAYER_NAMES = ("conv1", "conv2", "fc1", "fc2", "fc3")


def init_lenet5(seed: int, cfg: LeNet5Config = LeNet5Config(), *, device,
                dtype=torch.float32):
    """The JAX package's ``init_lenet5(jax.random.key(seed))``: the same
    threefry streams (``core/keys.py``), weights within a few ulp."""
    key = keys.key_data(seed)
    c1, c2 = cfg.conv_channels
    k = cfg.kernel
    flat = (cfg.in_shape[0] // 4) * (cfg.in_shape[1] // 4) * c2   # 7*7*16
    f1, f2, nc = cfg.fc_dims

    def dense(name, shape, fan_in):
        w = keys.normal(keys.subkey(key, name), shape) \
            * np.float32(1.0 / math.sqrt(max(fan_in, 1)))
        return torch.from_numpy(w).to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    return {
        "conv1": {"w": dense("c1", (k, k, cfg.in_shape[2], c1),
                             k * k * cfg.in_shape[2]), "b": zeros(c1)},
        "conv2": {"w": dense("c2", (k, k, c1, c2), k * k * c1),
                  "b": zeros(c2)},
        "fc1": {"w": dense("f1", (flat, f1), flat), "b": zeros(f1)},
        "fc2": {"w": dense("f2", (f1, f2), f1), "b": zeros(f2)},
        "fc3": {"w": dense("f3", (f2, nc), f2), "b": zeros(nc)},
    }


def _conv_same(x, w, b):
    """x NCHW, w HWIO, b [C_out]."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return y + b[:, None, None]


def lenet5_forward(params, x):
    """x: [B,28,28,1] fp32 -> (logits [B,10], acts)."""
    acts = {}
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(_conv_same(h, params["conv1"]["w"],
                                       params["conv1"]["b"])), 2)
    h = F.max_pool2d(F.relu(_conv_same(h, params["conv2"]["w"],
                                       params["conv2"]["b"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)     # NHWC flatten
    acts["fc1_in"] = h
    h = F.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    acts["fc2_in"] = h
    h = F.relu(h @ params["fc2"]["w"] + params["fc2"]["b"])
    acts["fc3_in"] = h
    logits = h @ params["fc3"]["w"] + params["fc3"]["b"]
    return logits, acts


def lenet5_loss(params, batch):
    """Mean cross-entropy of batch {"x": [B,28,28,1], "y": [B] int}."""
    logits, _ = lenet5_forward(params, batch["x"])
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
def init_lenet5_int8(seed: int, cfg: LeNet5Config = LeNet5Config(), *,
                     device):
    """The JAX package's ``init_lenet5_int8(jax.random.key(seed))``: the
    fp32 init quantised with ``quant_from_float(bits=6)``."""
    fp = init_lenet5(seed, cfg, device=device)
    return {n: {"w": quant_from_float(fp[n]["w"], bits=6)}
            for n in LAYER_NAMES}


def qconv2d_same(x: QTensor, w: QTensor) -> QTensor:
    pad = w.data.shape[0] // 2
    xd = F.pad(x.data, (0, 0, pad, pad, pad, pad))
    return qconv2d(QTensor(xd, x.exp), w)


def lenet5_forward_int8(params, x: QTensor):
    """x: QTensor [B,28,28,1] -> (logits QTensor [B,10], acts)."""
    acts = {}
    h = qmaxpool2(qrelu(qconv2d_same(x, params["conv1"]["w"])))
    h = qmaxpool2(qrelu(qconv2d_same(h, params["conv2"]["w"])))
    h = QTensor(h.data.reshape(h.data.shape[0], -1), h.exp)
    acts["fc1_in"] = h
    h = qrelu(qdense(h, params["fc1"]["w"]))
    acts["fc2_in"] = h
    h = qrelu(qdense(h, params["fc2"]["w"]))
    acts["fc3_in"] = h
    logits = qdense(h, params["fc3"]["w"])
    return logits, acts
