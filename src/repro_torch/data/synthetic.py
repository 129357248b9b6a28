"""Deterministic synthetic datasets, pure numpy.

A copy of ``glyphs``, ``point_clouds`` and ``token_batch`` from
``repro/data/synthetic.py`` (the port imports nothing of the JAX package),
so both packages train on the same samples, bit for bit:

* glyphs      -- 28x28 grayscale 10-class "digit-like" images: each class
                 is a distinct parametric stroke pattern + noise + small
                 affine jitter (LeNet-5, the paper's Table 1).
* point_clouds-- N x 3 point clouds of 8 parametric shape classes (sphere,
                 cube, cone, torus, ...) + jitter (PointNet, Table 1 and
                 Fig. 6).
* token_batch -- integer LM batches with next-token labels (a Zipf-ish
                 bigram process so losses are compressible).

Everything is a pure function of (seed, index).
"""
from __future__ import annotations

import numpy as np


def _glyph_canvas(cls: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    xx, yy = np.meshgrid(np.arange(28), np.arange(28))
    cx, cy = 13.5 + rng.uniform(-2, 2), 13.5 + rng.uniform(-2, 2)
    r = 8 + rng.uniform(-1.5, 1.5)
    t = (cls % 10)
    if t == 0:      # ring
        img += np.exp(-((np.hypot(xx - cx, yy - cy) - r) ** 2) / 3)
    elif t == 1:    # vertical bar
        img += np.exp(-((xx - cx) ** 2) / 4) * (np.abs(yy - cy) < r)
    elif t == 2:    # diagonal
        img += np.exp(-((xx - yy + cx - cy) ** 2) / 6)
    elif t == 3:    # cross
        img += np.exp(-((xx - cx) ** 2) / 4) + np.exp(-((yy - cy) ** 2) / 4)
    elif t == 4:    # two dots
        for dx in (-5, 5):
            img += np.exp(-(((xx - cx - dx) ** 2) + (yy - cy) ** 2) / 6)
    elif t == 5:    # horizontal bar
        img += np.exp(-((yy - cy) ** 2) / 4) * (np.abs(xx - cx) < r)
    elif t == 6:    # half ring
        d = np.hypot(xx - cx, yy - cy)
        img += np.exp(-((d - r) ** 2) / 3) * (yy < cy)
    elif t == 7:    # corner
        img += (np.exp(-((xx - cx + r) ** 2) / 4) * (yy > cy - r)
                + np.exp(-((yy - cy + r) ** 2) / 4) * (xx > cx - r))
    elif t == 8:    # double ring
        d = np.hypot(xx - cx, yy - cy)
        img += np.exp(-((d - r) ** 2) / 3) + np.exp(-((d - r / 2) ** 2) / 3)
    else:           # blob + tail
        img += np.exp(-(((xx - cx) ** 2) + (yy - cy) ** 2) / 12)
        img += np.exp(-((xx - yy + cx - cy) ** 2) / 8) * (xx > cx)
    img += rng.normal(0, 0.12, img.shape).astype(np.float32)
    return np.clip(img, 0, 1.5)


def glyphs(n: int, *, seed: int = 0, rotate_deg: float = 0.0,
           start: int = 0):
    """Returns (x [n,28,28,1] fp32, y [n] int32); sample i is a pure
    function of (seed, start + i)."""
    xs = np.zeros((n, 28, 28, 1), np.float32)
    ys = np.zeros((n,), np.int32)
    for i in range(n):
        idx = start + i
        rng = np.random.default_rng(np.uint64(seed * 1_000_003 + idx))
        cls = idx % 10
        img = _glyph_canvas(cls, rng)
        if rotate_deg:
            img = _rotate(img, np.deg2rad(rotate_deg))
        xs[i, :, :, 0] = img
        ys[i] = cls
    return xs, ys


def _rotate(img: np.ndarray, theta: float) -> np.ndarray:
    h, w = img.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2, (w - 1) / 2
    ys = cy + (yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta)
    xs = cx + (yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    y0 = np.clip(ys.round().astype(int), 0, h - 1)
    x0 = np.clip(xs.round().astype(int), 0, w - 1)
    return img[y0, x0]


def point_clouds(n: int, num_points: int = 256, *, seed: int = 0,
                 num_classes: int = 8, start: int = 0):
    """Returns (x [n,num_points,3] fp32, y [n] int32), each cloud centred
    and scaled into the unit ball; sample i is a pure function of (seed,
    start + i), drawn in ``_shape_points``'s order."""
    xs = np.zeros((n, num_points, 3), np.float32)
    ys = np.zeros((n,), np.int32)
    for i in range(n):
        idx = start + i
        rng = np.random.default_rng(np.uint64(seed * 999_983 + idx))
        cls = idx % num_classes
        pts = _shape_points(cls, num_points, rng)
        pts -= pts.mean(0, keepdims=True)
        pts /= max(np.linalg.norm(pts, axis=1).max(), 1e-6)
        xs[i] = pts
        ys[i] = cls
    return xs, ys


def _shape_points(cls, n, rng):
    u = rng.uniform(0, 1, n)
    v = rng.uniform(0, 1, n)
    th, ph = 2 * np.pi * u, np.arccos(2 * v - 1)
    if cls == 0:      # sphere
        p = np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th),
                      np.cos(ph)], 1)
    elif cls == 1:    # cube surface
        p = rng.uniform(-1, 1, (n, 3))
        ax = rng.integers(0, 3, n)
        sgn = rng.choice([-1.0, 1.0], n)
        p[np.arange(n), ax] = sgn
    elif cls == 2:    # cone
        h = rng.uniform(0, 1, n)
        p = np.stack([(1 - h) * np.cos(th), (1 - h) * np.sin(th), h * 2 - 1], 1)
    elif cls == 3:    # torus
        R, r = 1.0, 0.35
        p = np.stack([(R + r * np.cos(2 * np.pi * v)) * np.cos(th),
                      (R + r * np.cos(2 * np.pi * v)) * np.sin(th),
                      r * np.sin(2 * np.pi * v)], 1)
    elif cls == 4:    # cylinder
        p = np.stack([np.cos(th), np.sin(th), 2 * v - 1], 1)
    elif cls == 5:    # plane with ridge
        p = np.stack([2 * u - 1, 2 * v - 1,
                      0.3 * np.sin(4 * np.pi * u)], 1)
    elif cls == 6:    # two spheres
        p = np.stack([np.sin(ph) * np.cos(th) * 0.5,
                      np.sin(ph) * np.sin(th) * 0.5, np.cos(ph) * 0.5], 1)
        p[:, 0] += np.where(rng.uniform(size=n) > 0.5, 0.8, -0.8)
    else:             # helix
        t = 4 * np.pi * u
        p = np.stack([np.cos(t), np.sin(t), (t / (2 * np.pi)) - 1], 1)
        p += rng.normal(0, 0.05, (n, 3))
    return (p + rng.normal(0, 0.02, (n, 3))).astype(np.float32)


def token_batch(batch: int, seq: int, vocab: int, *, seed: int = 0,
                step: int = 0):
    """Zipf-bigram token stream; labels are next tokens. Returns (x, y
    int32 [batch, seq], mask f32 [batch, seq])."""
    rng = np.random.default_rng(np.uint64(seed * 7_368_787 + step))
    # a cheap deterministic bigram: next ~ (a*cur + noise) mod vocab_eff
    vocab_eff = min(vocab, 32768)
    a = 6364136223846793005 % vocab_eff
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab_eff, batch)
    noise = rng.integers(0, 64, (batch, seq))
    for t in range(seq):
        toks[:, t + 1] = (toks[:, t] * a + noise[:, t]) % vocab_eff
    x = toks[:, :-1].astype(np.int32)
    y = toks[:, 1:].astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    return x, y, mask
