"""Port parity: PointNet, the paper's second model, against the JAX package.

The JAX package has no test of PointNet, so these are its first oracle.
Both packages start from the same parameters (the JAX init, converted
through numpy) and the same key data, take the same point clouds, and
step. Tolerances as in tests/test_torch_train.py: the fp32 lanes within
LENET_TOL (XLA's jitted CPU step and eager torch sum in other orders);
the data, the int8 init and the int8 forward bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs.paper_models import PointNetConfig as JCfg  # noqa: E402
from repro.core.elastic import TrainState as JState  # noqa: E402
from repro.core.elastic import make_elastic_step as jmake_step  # noqa: E402
from repro.core.int8 import quant_from_float as jquant  # noqa: E402
from repro.data.synthetic import point_clouds as jpoint_clouds  # noqa: E402
from repro.models import pointnet as jpointnet  # noqa: E402
from repro_torch.benchmarks.paper_tables import (  # noqa: E402
    pointnet_lane_configs)
from repro_torch.configs.paper_models import (POINTNET,  # noqa: E402
                                              POINTNET_SYN, PointNetConfig)
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core import elastic, zo  # noqa: E402
from repro_torch.core.int8 import quant_from_float  # noqa: E402
from repro_torch.data.synthetic import point_clouds  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import pointnet  # noqa: E402

LENET_TOL = dict(rtol=1e-4, atol=2e-5)
SMALL = dict(feat_dims=(16, 16, 16, 32, 64), head_dims=(32, 16),
             num_classes=8, num_points=32)
N_STEPS = 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, tol):
    flat = jax.tree_util.tree_flatten_with_path(_np_tree(want))[0]
    got_leaves = dict((zo.keystr(p), t) for p, t in zo.leaves_with_path(got))
    assert len(got_leaves) == len(flat)
    for path, w in flat:
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got_leaves[name].float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)


def _ulps(a, b):
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("n,num_points,seed,start", [
    (16, 64, 3, 0), (9, 256, 4, 50_000), (3, 1024, 0, 7)])
def test_point_clouds_are_the_jax_packages(n, num_points, seed, start):
    """Bitwise, over every shape class (16 samples cover the 8)."""
    for a, b in zip(point_clouds(n, num_points, seed=seed, start=start),
                    jpoint_clouds(n, num_points, seed=seed, start=start)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_configs_are_the_jax_packages():
    assert dataclasses.asdict(POINTNET) == dataclasses.asdict(JCfg())
    assert dataclasses.asdict(POINTNET_SYN) == dataclasses.asdict(
        JCfg(num_classes=8, num_points=256))


@pytest.mark.parametrize("cfg", [POINTNET, PointNetConfig(**SMALL)],
                         ids=["full", "reduced"])
def test_init_within_ulp_and_int8_init_bitwise(cfg):
    """fp32 weights within a few ulp of JAX's (the erf_inv tail, as for
    LeNet-5), biases zero; the bits=6 int8 init bitwise at both widths
    (no rounding tie flips here)."""
    jcfg = JCfg(**dataclasses.asdict(cfg))
    jp = jpointnet.init_pointnet(jax.random.key(5), jcfg)
    tp = pointnet.init_pointnet(5, cfg, device="cpu")
    assert list(tp) == list(pointnet.LAYER_NAMES)
    for n in pointnet.LAYER_NAMES:
        assert tp[n]["w"].shape == jp[n]["w"].shape
        assert _ulps(tp[n]["w"].numpy(), jp[n]["w"]) <= 4, n
        assert not tp[n]["b"].any()
    jq = jax.jit(lambda k: jpointnet.init_pointnet_int8(k, jcfg))(
        jax.random.key(5))
    tq = pointnet.init_pointnet_int8(5, cfg, device="cpu")
    for n in pointnet.LAYER_NAMES:
        np.testing.assert_array_equal(tq[n]["w"].data.numpy(),
                                      np.asarray(jq[n]["w"].data), err_msg=n)
        assert int(tq[n]["w"].exp) == int(jq[n]["w"].exp), n


@pytest.mark.parametrize("lane_idx", range(4))
def test_pointnet_lane_matches_jax(lane_idx):
    """Each of the four fp32 lanes, from JAX's init, against JAX's jitted
    ``make_elastic_step(pointnet_loss, ...)`` after 1 and 3 steps (the
    second probe dropped at step 1)."""
    name, lane, c = pointnet_lane_configs(steps=100)[lane_idx]
    jl = JLane(**dataclasses.asdict(lane))
    jcfg = JCfg(**SMALL)
    part = (lambda p: jpointnet.partition_at(p, c)) \
        if jl.lane == "elastic_zo" else None
    jstep = jax.jit(jmake_step(jpointnet.pointnet_loss, jl,
                               partition_fn=part))
    params = jpointnet.init_pointnet(jax.random.key(5), jcfg)
    jstate = JState(params, jnp.int32(0),
                    jax.random.key_data(jax.random.key(17)))
    state = state_from_jax(_np_tree(params), 0, jstate.seed, "cpu",
                           torch.float32)
    tpart = (lambda p: pointnet.partition_at(p, c)) \
        if lane.lane == "elastic_zo" else None
    step = elastic.make_elastic_step(pointnet.pointnet_loss, lane,
                                     partition_fn=tpart)
    xs, ys = jpoint_clouds(8 * N_STEPS, 32, seed=3)
    for s in range(N_STEPS):
        mask = np.ones((jl.zo_num_probes,), np.float32)
        mask[1:] = s != 1
        bx, by = xs[8 * s:8 * s + 8], ys[8 * s:8 * s + 8]
        jstate, jm = jstep(jstate, {"x": jnp.asarray(bx),
                                    "y": jnp.asarray(by)}, jnp.asarray(mask))
        state, m = step(state, {"x": torch.from_numpy(bx),
                                "y": torch.from_numpy(by)}, mask)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   err_msg=f"{name} step {s}", **LENET_TOL)
        if s in (0, N_STEPS - 1):
            _assert_trees_close(state.params, jstate.params, LENET_TOL)
    assert state.step == N_STEPS


def test_pointnet_launches_per_step():
    """zo_perturb and zo_fused_replay calls per step of each lane: 2 per
    probe and 1 per step for every ZO leaf (w and b of 8 / 6 / 7 / 0 ZO
    layers; the counts chip_smoke.py asserts on the card)."""
    calls = {"perturb": 0, "replay": 0}
    perturb, replay = ops.zo_perturb, ops.zo_fused_replay

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    want = {"full_zo": (128, 16), "zo_feat_cls2": (96, 12),
            "zo_feat_cls1": (112, 14), "full_bp": (0, 0)}
    cfg = PointNetConfig(**SMALL)
    xs, ys = point_clouds(4, 32, seed=3)
    batch = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "zo_perturb", count("perturb", perturb))
    mp.setattr(ops, "zo_fused_replay", count("replay", replay))
    try:
        for name, lane, c in pointnet_lane_configs(steps=100):
            part = (lambda p, c=c: pointnet.partition_at(p, c)) \
                if lane.lane == "elastic_zo" else None
            step = elastic.make_elastic_step(pointnet.pointnet_loss, lane,
                                             partition_fn=part)
            calls.update(perturb=0, replay=0)
            params = pointnet.init_pointnet(5, cfg, device="cpu")
            step(elastic.TrainState(params, 0, np.array([0, 17], np.uint32)),
                 batch, np.ones((lane.zo_num_probes,), np.float32))
            assert (calls["perturb"], calls["replay"]) == want[name], name
    finally:
        mp.undo()


def test_global_pool_gradient_splits_ties_like_jax():
    """The max-pool's gradient over tied maxima is split evenly, as XLA's
    reduce_max gradient is (only full_bp differentiates through it)."""
    h = np.array([[[1.0, 0.0], [1.0, 2.0], [0.5, 2.0], [1.0, 2.0]]],
                 np.float32)
    w = np.array([[1.5], [-0.5]], np.float32)
    jg = jax.grad(lambda x: jnp.sum(jnp.max(x, axis=1) @ w))(jnp.asarray(h))
    t = torch.from_numpy(h).requires_grad_(True)
    (t.amax(dim=1) @ torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("cfg,B,N", [(PointNetConfig(**SMALL), 8, 32),
                                     (POINTNET, 2, 64)],
                         ids=["reduced", "full"])
def test_pointnet_forward_int8_matches_jax(cfg, B, N):
    """The int8 forward (K = 3 first product, global int8 max-pool, NITI
    rescale after every product) bitwise JAX's, logits and activations,
    from the same int8 params and quantised input."""
    jcfg = JCfg(**dataclasses.asdict(cfg))
    jq = jax.jit(lambda k: jpointnet.init_pointnet_int8(k, jcfg))(
        jax.random.key(5))
    xs, _ = jpoint_clouds(B, N, seed=4, start=50_000)
    jlogits, jacts = jax.jit(jpointnet.pointnet_forward_int8)(
        jq, jquant(jnp.asarray(xs)))
    tq = params_from_jax(_np_tree(jq), "cpu")
    logits, acts = pointnet.pointnet_forward_int8(
        tq, quant_from_float(torch.from_numpy(xs)))
    assert logits.data.dtype == torch.int8
    np.testing.assert_array_equal(logits.data.numpy(),
                                  np.asarray(jlogits.data))
    assert int(logits.exp) == int(jlogits.exp)
    assert set(acts) == set(jacts) == {"head0_in", "head1_in", "cls_in"}
    for k in acts:
        np.testing.assert_array_equal(acts[k].data.numpy(),
                                      np.asarray(jacts[k].data), err_msg=k)
        assert int(acts[k].exp) == int(jacts[k].exp), k


def test_pointnet_forward_fp32_matches_jax():
    """The fp32 forward and loss at full width on 2 clouds of 64 points,
    from JAX's init: float rounding only."""
    jp = jpointnet.init_pointnet(jax.random.key(5), JCfg())
    xs, ys = jpoint_clouds(2, 64, seed=4)
    jlogits, _ = jpointnet.pointnet_forward(jp, jnp.asarray(xs))
    jloss = jpointnet.pointnet_loss(jp, {"x": jnp.asarray(xs),
                                         "y": jnp.asarray(ys)})
    tp = params_from_jax(_np_tree(jp), "cpu")
    logits, _ = pointnet.pointnet_forward(tp, torch.from_numpy(xs))
    loss = pointnet.pointnet_loss(tp, {"x": torch.from_numpy(xs),
                                       "y": torch.from_numpy(ys)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LENET_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **LENET_TOL)
