"""Port parity: the fp32 ElasticZO train step against the JAX package.

Both packages start from the same parameters (the JAX init, converted
through numpy) and the same key data, take the same batches, and step.
Tolerances: XLA's jitted CPU step and eager torch on the CPU sum in other
orders (convolutions, matmuls, the CE reduction), and may contract the
update's mul-add into an FMA, so losses and parameters agree to float
rounding amplified by the loss difference over 2 eps: LeNet-5 within
2e-5 absolute (eps 1e-2), the reduced LM within 1e-4 (eps 1e-3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.paper_tables import lenet_lane_configs  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core.elastic import TrainState as JState  # noqa: E402
from repro.core.elastic import make_elastic_step as jmake_step  # noqa: E402
from repro.data.synthetic import glyphs as jglyphs  # noqa: E402
from repro.data.synthetic import token_batch as jtoken_batch  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.core import api, elastic, zo  # noqa: E402
from repro_torch.data.synthetic import glyphs, token_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.train.train_loop import init_state, run  # noqa: E402

LENET_TOL = dict(rtol=1e-4, atol=2e-5)
LM_TOL = dict(rtol=1e-3, atol=1e-4)
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


def _port_lane(jl):
    return LaneConfig(**dataclasses.asdict(jl))


# ------------------------------------------------------------------ #
# LeNet-5, the paper's four fp32 lanes
# ------------------------------------------------------------------ #
def test_glyphs_and_tokens_are_the_jax_packages():
    for a, b in zip(glyphs(6, seed=3, start=10), jglyphs(6, seed=3, start=10)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(token_batch(2, 9, 500, seed=1, step=4),
                    jtoken_batch(2, 9, 500, seed=1, step=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lane_idx", range(4))
def test_lenet_lane_matches_jax(lane_idx):
    name, jl, c = lenet_lane_configs(steps=150, probes=2)[lane_idx]
    part = (lambda p: jlenet.partition_at(p, c)) \
        if jl.lane == "elastic_zo" else None
    jstep = jax.jit(jmake_step(jlenet.lenet5_loss, jl, partition_fn=part))
    params = jlenet.init_lenet5(jax.random.key(7))
    jstate = JState(params, jnp.int32(0),
                    jax.random.key_data(jax.random.key(11)))
    state = state_from_jax(_np_tree(params), 0, jstate.seed, "cpu",
                           torch.float32)
    tpart = (lambda p: lenet.partition_at(p, c)) \
        if jl.lane == "elastic_zo" else None
    step = elastic.make_elastic_step(lenet.lenet5_loss, _port_lane(jl),
                                     partition_fn=tpart)
    xs, ys = jglyphs(8 * N_STEPS, seed=0)
    for s in range(N_STEPS):
        mask = np.ones((jl.zo_num_probes,), np.float32)
        mask[1:] = s != 1               # the second probe dropped at step 1
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


def test_lenet_launches_per_step():
    """zo_perturb and zo_fused_replay calls per step of each lane: 2 per
    probe and 1 per step for every ZO leaf (the counts chip_smoke.py
    asserts on the card)."""
    calls = {"perturb": 0, "replay": 0}
    perturb, replay = ops.zo_perturb, ops.zo_fused_replay

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    want = {"full_zo": 80, "zo_feat_cls2": 48, "zo_feat_cls1": 64,
            "full_bp": 0}
    xs, ys = glyphs(4, seed=0)
    batch = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "zo_perturb", count("perturb", perturb))
    mp.setattr(ops, "zo_fused_replay", count("replay", replay))
    try:
        for name, jl, c in lenet_lane_configs(steps=150):
            part = (lambda p, c=c: lenet.partition_at(p, c)) \
                if jl.lane == "elastic_zo" else None
            step = elastic.make_elastic_step(lenet.lenet5_loss,
                                             _port_lane(jl),
                                             partition_fn=part)
            calls.update(perturb=0, replay=0)
            params = lenet.init_lenet5(7, device="cpu")
            step(elastic.TrainState(params, 0, np.array([0, 11], np.uint32)),
                 batch, np.ones((jl.zo_num_probes,), np.float32))
            assert calls["perturb"] == want[name], name
            assert calls["replay"] == want[name] // 8, name
    finally:
        mp.undo()


# ------------------------------------------------------------------ #
# the LM: reduced qwen3-4b in f32
# ------------------------------------------------------------------ #
def _lm_case(lane_name, probes, **lane_kw):
    jcfg = jreduced(JARCHS["qwen3-4b"], dtype="float32")
    jl = JLane(lane=lane_name, bp_tail_layers=1, zo_num_probes=probes,
               **lane_kw)
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    m = japi.build(jcfg, shape, jl, ShardingRules(None, jcfg, shape))
    params = m.init(jax.random.key(0))
    jstate = JState(params, jnp.int32(0),
                    jax.random.key_data(jax.random.key(0)))
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32")
    state = state_from_jax(_np_tree(params), 0, jstate.seed, "cpu",
                           torch.float32)
    return (jax.jit(m.train_step), jstate, jl,
            api.make_train_step(cfg, _port_lane(jl)), state, cfg)


def _lm_batch(cfg, s):
    x, y, m = token_batch(2, 16, cfg.vocab_size, seed=1, step=s)
    return ({"tokens": jnp.asarray(x), "labels": jnp.asarray(y),
             "mask": jnp.asarray(m)},
            {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y),
             "mask": torch.from_numpy(m)})


@pytest.mark.parametrize("lane_name,steps,probes", [
    ("elastic_zo", 2, 1), ("full_zo", 1, 1), ("full_bp", 1, 1)])
def test_reduced_lm_step_matches_jax(lane_name, steps, probes):
    mask = np.ones((probes,), np.float32)
    jstep, jstate, jl, step, state, cfg = _lm_case(lane_name, probes)
    for s in range(steps):
        jb, tb = _lm_batch(cfg, s)
        jstate, jm = jstep(jstate, jb, jnp.asarray(mask))
        state, tm = step(state, tb, mask)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"{lane_name} step {s}", **LM_TOL)
        np.testing.assert_allclose(float(tm["zo_g"]), float(jm["zo_g"]),
                                   rtol=1e-2, atol=1e-2)
    _assert_trees_close(state.params, jstate.params, LM_TOL)


# ------------------------------------------------------------------ #
# the fused antithetic probe pair (lane.fused_probes)
# ------------------------------------------------------------------ #
def _fused_masks(probes, steps):
    """Every probe live, but the second dropped at step 1."""
    masks = np.ones((steps, probes), np.float32)
    masks[1, 1:] = 0.0
    return masks


@pytest.fixture(scope="module")
def fused_runs():
    """3 steps of the fused lane (2 probes) in JAX and in the port from
    the same init, keeping every step's metrics and the states after steps
    1 and 3."""
    jstep, jstate, _, step, state, cfg = _lm_case("elastic_zo", 2,
                                                  fused_probes=True)
    out = {"jax": [], "port": []}
    for s, mask in enumerate(_fused_masks(2, 3)):
        jb, tb = _lm_batch(cfg, s)
        jstate, jm = jstep(jstate, jb, jnp.asarray(mask))
        state, tm = step(state, tb, mask)
        out["jax"].append((jm, _np_tree(jstate.params)))
        out["port"].append((tm, zo.map_with_path(lambda p, t: t.clone(),
                                                 state.params)))
    return out


@pytest.mark.parametrize("steps", [1, 3])
def test_reduced_lm_fused_lane_matches_jax(fused_runs, steps):
    for s in range(steps):
        (jm, _), (tm, _) = fused_runs["jax"][s], fused_runs["port"][s]
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"step {s}", **LM_TOL)
        np.testing.assert_allclose(float(tm["zo_g"]), float(jm["zo_g"]),
                                   rtol=1e-2, atol=1e-2)
    _assert_trees_close(fused_runs["port"][steps - 1][1],
                        fused_runs["jax"][steps - 1][1], LM_TOL)


def test_fused_lane_equals_unfused_in_the_port(fused_runs):
    """The perturbed slices are bitwise the stacked perturbation, so the
    losses and zo_g are the unfused lane's bitwise at the first step (and
    within 1e-6 after, where the tail differs by rounding), the ZO head
    bitwise, and the tail within 1e-6: one backward of the mean sums the
    two streams' gradients in another order than the unfused lane's mean
    of two backwards."""
    *_, step, state, cfg = _lm_case("elastic_zo", 2)
    for s, mask in enumerate(_fused_masks(2, 3)):
        state, m = step(state, _lm_batch(cfg, s)[1], mask)
        fm, fparams = fused_runs["port"][s]
        for key in ("loss", "zo_g"):
            if s == 0:
                assert float(m[key]) == float(fm[key]), key
            np.testing.assert_allclose(float(m[key]), float(fm[key]),
                                       rtol=1e-6, err_msg=f"{key} step {s}")
    fused = dict((zo.keystr(p), t) for p, t in zo.leaves_with_path(fparams))
    for path, t in zo.leaves_with_path(state.params):
        name = zo.keystr(path)
        if path[0] in elastic.ZO_GROUPS:
            assert torch.equal(t, fused[name]), name
        else:
            torch.testing.assert_close(t, fused[name], rtol=0, atol=1e-6,
                                       msg=name)


def test_fused_step_launches(monkeypatch):
    """zo_perturb calls per fused step and probe: embed twice, then every
    periods_zo leaf's slice twice per period (11 leaves on qwen3-4b); the
    update one zo_fused_replay per ZO leaf (12)."""
    calls = {"perturb": 0, "replay": 0}
    perturb, replay = ops.zo_perturb, ops.zo_fused_replay

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ops, "zo_perturb", count("perturb", perturb))
    monkeypatch.setattr(ops, "zo_fused_replay", count("replay", replay))
    cfg = configs.reduced(configs.ARCHS["qwen3-4b"], dtype="float32",
                          num_layers=4)
    lane = LaneConfig(bp_tail_layers=1, zo_num_probes=2, fused_probes=True)
    step = api.make_train_step(cfg, lane)
    state = init_state(api.init(cfg, lane, seed=1, device="cpu"), seed=2)
    step(state, _lm_batch(cfg, 0)[1], np.ones((2,), np.float32))
    assert calls == {"perturb": 2 * (2 + 11 * 3 * 2), "replay": 12}


def test_fused_lane_through_the_launcher():
    """launch.train.setup with a LaneConfig override builds the fused lane
    (the launcher has no fused flag, as in the JAX package), and it
    trains as the unfused lane does from the same flags."""
    args = launch_train.parse_args(["--arch", "qwen3-4b", "--smoke",
                                    "--device", "cpu", "--steps", "2",
                                    "--seq", "16", "--batch", "2"])
    hist = {}
    for fused in (False, True):
        lane = dataclasses.replace(launch_train.lane_from_args(args),
                                   fused_probes=fused)
        t = launch_train.setup(args, lane)
        assert t.lane.fused_probes is fused
        hist[fused] = run(t.step_fn, t.state, t.batch_fn, t.loop,
                          log=None).history
    assert hist[True][0] == hist[False][0]
    assert all(np.isfinite(loss) for _, loss in hist[True])


# ------------------------------------------------------------------ #
# the loop and the launcher
# ------------------------------------------------------------------ #
def test_probe_mask_stream_matches_jax_loop():
    """train_loop.run draws the JAX loop's probe masks (default_rng(seed +
    17), never every probe dropped) and logs at the same steps."""
    from repro.train import train_loop as jloop
    from repro_torch.train import train_loop

    def recorder(masks):
        def step_fn(state, batch, mask):
            masks.append(np.asarray(mask).copy())
            return state._replace(step=state.step + 1), \
                {"loss": np.float32(len(masks))}
        return step_fn

    got, want = [], []
    kw = dict(total_steps=23, log_every=5, probe_drop_rate=0.6, seed=4)
    lane = JLane(zo_num_probes=3)
    _, jhist = jloop.run(recorder(want), JState({}, 0, None), lambda s: {},
                         jloop.LoopConfig.for_lane(lane, jit=False, **kw))
    _, hist = train_loop.run(recorder(got), elastic.TrainState({}, 0, None),
                             lambda s: {}, train_loop.LoopConfig.for_lane(
                                 _port_lane(lane), **kw), log=None)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert hist == jhist and min(m.sum() for m in got) >= 1



def test_train_cli_runs_on_cpu(capsys):
    history = launch_train.main(["--arch", "qwen3-4b", "--smoke",
                                 "--device", "cpu", "--steps", "2"])
    assert [s for s, _ in history] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in history)
    assert "done at step 2" in capsys.readouterr().out


def test_train_cli_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1"])
