"""Port parity: the ElasticZO-INT8 lane (Alg. 2) against the JAX package.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode through ``repro.kernels.ops(..., force_pallas=True)``, its
refs, and its jitted int8 train step) and through the port on the CPU,
where every kernel call takes its plain version. The lane is integer
arithmetic, so the contract is bitwise: rounding, noise, products, the
integer loss, the NITI backward and whole train steps. Only the f32 loss
metric is compared within 1e-6 (torch's and XLA's logsumexp on the CPU).
The JAX side is held live in this process, not against
``tests/golden/engine_steps.json``, whose int8 digests do not reproduce
under the current jax.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.paper_tables import INT8_LANES as JINT8_LANES  # noqa: E402
from benchmarks.paper_tables import _int8_lane_cfg  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import int8 as jq  # noqa: E402
from repro.core import int_loss as jil  # noqa: E402
from repro.core.elastic import TrainState as JState  # noqa: E402
from repro.core.elastic_int8 import (  # noqa: E402
    make_int8_elastic_step as jmake)
from repro.data.synthetic import glyphs as jglyphs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import elastic_int8, engine, keys, zo  # noqa: E402
from repro_torch.core import int8 as q  # noqa: E402
from repro_torch.core import int_loss as il  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.train import paper_lanes  # noqa: E402
from repro_torch.train.train_loop import init_state  # noqa: E402

R_MAX, P_ZERO = 3, 0.33
N_STEPS, BATCH = 3, 8


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _seed(s):
    """A uint32 seed as the port passes it: int32 [1] holding its bits."""
    return _t(np.array([s], np.uint32).view(np.int32))


def _assert_q_trees_equal(got, want_jax):
    """The port's QTensor tree equals a JAX one bitwise (data and exp)."""
    want = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                want_jax, is_leaf=lambda x: isinstance(x, jq.QTensor))[0]}
    got = dict((zo.keystr(p), leaf) for p, leaf in zo.leaves_with_path(got))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        np.testing.assert_array_equal(leaf.data.numpy(),
                                      np.asarray(want[name].data),
                                      err_msg=name)
        assert int(leaf.exp) == int(want[name].exp), name


@pytest.fixture(scope="module")
def jparams():
    """JAX's ``init_lenet5_int8(key(7))`` as numpy (data, exp) pairs."""
    return jax.tree.map(np.asarray,
                        jax.jit(jlenet.init_lenet5_int8)(jax.random.key(7)))


# ------------------------------------------------------------------ #
# keys
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("s", [0, 2**31 + 9, 2**32 - 1, 2**32 + 5,
                               2**40 + 3, -1, -5])
def test_key_data_matches_jax(s):
    np.testing.assert_array_equal(
        keys.key_data(s), np.asarray(jax.random.key_data(jax.random.key(s))))


# ------------------------------------------------------------------ #
# rounding and rescale
# ------------------------------------------------------------------ #
def _ints(n, hi, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-hi, hi, n, dtype=np.int64)
    x[:6] = [0, 1, -1, hi - 1, -(hi - 1), 2**31 - 1]
    return x.astype(np.int32)


@pytest.mark.parametrize("s", [0, 1, 3, 7, 19, 31, 32, 33, 40])
def test_psr_shift_matches_jax(s):
    """Every shift count, including s = 0 (the threshold shift is 32) and
    s >= 32, as a Python int and as a 0-d device tensor."""
    x = _ints(4096, 2**31 - 1, seed=s)
    want = np.asarray(jax.jit(jq.psr_shift)(jnp.asarray(x), jnp.int32(s)))
    np.testing.assert_array_equal(q.psr_shift(_t(x), s).numpy(), want)
    got = q.psr_shift(_t(x), torch.tensor(s, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitwidth_matches_jax():
    edges = [0, -7, 2, 3, 4, 127, 128, 255, 256, 2**30, 2**30 - 1]
    x = np.concatenate([_ints(2000, 2**31 - 1, seed=3), edges]).astype(
        np.int32)
    want = np.asarray(jax.jit(jax.vmap(jq.bitwidth))(jnp.asarray(x)))
    np.testing.assert_array_equal(q.bitwidth(_t(x)).numpy(), want)


@pytest.mark.parametrize("hi", [100, 2**14, 2**24 + 3])
def test_rescale_int32_matches_jax(hi):
    acc = _ints(3000, hi, seed=hi)[6:].reshape(-1, 6)
    want = jax.jit(jq.rescale_int32)(jnp.asarray(acc), jnp.int32(-9))
    for maxabs in (None, torch.tensor(int(np.abs(acc).max()),
                                      dtype=torch.int32)):
        got = q.rescale_int32(_t(acc), torch.tensor(-9, dtype=torch.int32),
                              maxabs)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        assert int(got.exp) == int(want.exp)


@pytest.mark.parametrize("bits,scale", [(7, 3.0), (6, 0.02), (7, 1.5)])
def test_quant_from_float_matches_jax(bits, scale):
    x = (np.random.default_rng(bits).normal(size=(33, 17)) * scale
         ).astype(np.float32)
    want = jax.jit(jq.quant_from_float, static_argnums=1)(jnp.asarray(x),
                                                           bits)
    got = q.quant_from_float(_t(x), bits)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert int(got.exp) == int(want.exp)


def test_qtensor_helpers_match_jax():
    d = np.random.default_rng(5).integers(-127, 128, (4, 6, 3),
                                          dtype=np.int8)
    jx = jq.qtensor(d, -5)
    tx = q.qtensor(d, -5)
    assert tx.data.dtype == torch.int8 and tx.exp.dtype == torch.int32
    assert tx.exp.shape == ()
    np.testing.assert_array_equal(q.dequant(tx).numpy(),
                                  np.asarray(jq.dequant(jx)))
    for axis in (1, 2):
        np.testing.assert_array_equal(
            q.qglobal_maxpool(tx, axis).data.numpy(),
            np.asarray(jq.qglobal_maxpool(jx, axis).data))


# ------------------------------------------------------------------ #
# noise, perturbation and update on the LeNet-5 int8 tree
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,salt", [(123, 5), (2**32 - 1, 2**30 - 1),
                                       (0, 0)])
def test_int8_noise_matches_jax(seed, salt):
    want = jax.jit(jq.int8_noise, static_argnums=(1, 2, 3))(
        jnp.uint32(seed), salt, (9001,), R_MAX, jnp.float32(P_ZERO))
    got = q.int8_noise(seed, salt, (9001,), R_MAX, P_ZERO)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nz = (got != 0).float().mean().item()
    assert abs(nz - (1 - P_ZERO) * 6 / 7) < 0.02


def test_perturb_and_update_match_jax_on_lenet(jparams):
    jp, params = jparams, params_from_jax(jparams, "cpu")
    seed = 2**31 + 77
    perturb = jax.jit(lambda p, k: jq.perturb_int8(
        p, jnp.uint32(seed), k, R_MAX, jnp.float32(P_ZERO)))
    update = jax.jit(lambda p, g: jq.zo_update_int8(
        p, jnp.uint32(seed), g, R_MAX, jnp.float32(P_ZERO), 1))
    for k in (1, -1):
        want = perturb(jp, jnp.int32(k))
        _assert_q_trees_equal(q.perturb_int8(params, _seed(seed), k, R_MAX,
                                             P_ZERO), want)
    for g in (1, 0, -1):
        want = update(jp, jnp.int32(g))
        _assert_q_trees_equal(q.zo_update_int8(
            params, _seed(seed), torch.tensor(g, dtype=torch.int32), R_MAX,
            P_ZERO, 1), want)


# ------------------------------------------------------------------ #
# the three plain versions against the Pallas kernels (interpret mode)
# ------------------------------------------------------------------ #
def test_int8_perturb_plain_matches_pallas():
    theta = np.random.default_rng(1).integers(-127, 128, (37, 29),
                                              dtype=np.int8)
    for k in (1, -1):
        want = jops.int8_perturb(jnp.asarray(theta), jnp.uint32(4242), 77, k,
                                 R_MAX, jnp.float32(P_ZERO),
                                 force_pallas=True, interpret=True)
        got = ref.int8_perturb_ref(_t(theta), _seed(4242), 77, k, R_MAX,
                                   P_ZERO)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_replay_plain_matches_pallas_and_live_equals_replay():
    """S = 3, P = 2 with one g = 0; then S single in-place steps of the
    port equal its one S-step call."""
    theta = np.random.default_rng(2).integers(-127, 128, (1000, 3),
                                              dtype=np.int8)
    seeds = np.array([[11, 2**32 - 3], [7, 99], [2**31, 5]], np.uint32)
    gs = np.array([[1, -1], [0, 1], [-1, -1]], np.int32)
    want = jops.zo_fused_replay_int8(jnp.asarray(theta), jnp.asarray(seeds),
                                     jnp.asarray(gs), 555, R_MAX,
                                     jnp.float32(P_ZERO), 1,
                                     force_pallas=True, interpret=True)
    sd, g = _t(seeds.view(np.int32)), _t(gs)
    got = ref.zo_fused_replay_int8_ref(_t(theta), sd, g, 555, R_MAX, P_ZERO,
                                       1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = _t(theta)
    for s in range(3):
        ops.zo_fused_replay_int8_leaves([live], sd[s:s + 1], g[s:s + 1],
                                        [555], R_MAX, P_ZERO, 1, outs=[live])
    np.testing.assert_array_equal(live.numpy(), got.numpy())


def test_engine_ledger_domain_matches_jax(jparams):
    """Int8Engine's host_coeffs and apply_zo_records (S = 3 steps of 2
    probes, one g = 0) against the JAX package's, bitwise; S live
    in-place zo_apply steps equal the one S-step replay."""
    lane = _int8_lane_cfg()
    jeng = jengine.Int8Engine(lane, lambda p: jlenet.partition_at(p, 3))
    eng = engine.Int8Engine(LaneConfig(**dataclasses.asdict(lane)),
                            lambda p: lenet.partition_at(p, 3))
    gs = np.array([[1, -1], [0, 1], [-1, -1]], np.int32)
    mask = np.array([1.0, 0.0], np.float32)
    (a, va), (b, vb) = (jeng.host_coeffs(4, gs[0], mask),
                        eng.host_coeffs(4, gs[0], mask))
    np.testing.assert_array_equal(a, b)
    assert va == vb
    seeds = np.array([[11, 2**32 - 3], [7, 99], [2**31, 5]], np.uint32)
    jzo, _ = jlenet.partition_at(jparams, 3)
    want = jeng.apply_zo_records(jzo, seeds, gs)
    zo_part, _ = eng.partition(params_from_jax(jparams, "cpu"))
    _assert_q_trees_equal(eng.apply_zo_records(zo_part, seeds, gs), want)
    sd = _t(seeds.view(np.int32))
    for s in range(3):
        eng.zo_apply(zo_part, sd[s:s + 1], _t(gs[s:s + 1]))
    _assert_q_trees_equal(zo_part, want)


@pytest.mark.parametrize("M,K,N", [(37, 25, 6), (130, 150, 16),
                                   (5, 784, 120), (1, 1, 1)])
def test_int8_matmul_plain_matches_pallas(M, K, N):
    rng = np.random.default_rng(M * K + N)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    out, mx = jops.int8_matmul(jnp.asarray(a), jnp.asarray(w),
                               force_pallas=True, interpret=True)
    got, got_mx = ref.int8_matmul_ref(_t(a), _t(w))
    assert got.dtype == torch.int32 and got_mx.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    assert int(got_mx) == int(mx)


# ------------------------------------------------------------------ #
# integer loss and NITI backward
# ------------------------------------------------------------------ #
def _logits(B, exp, seed):
    d = np.random.default_rng(seed + 100).integers(-127, 128, (B, 10),
                                             dtype=np.int8)
    d[0, :3] = d[0, 3]                   # ties
    return d, np.int32(exp)


# exponents that exercise every branch: shifts of 15 - s >= 32 (s <= -17),
# left shifts (s > 15) and the common case
EXPS = [(-6, -6), (-20, -17), (-3, -40), (18, 16), (0, 25)]


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("ea,eb", EXPS)
def test_int_loss_matches_jax(B, ea, eb):
    (da, xa), (db, xb) = _logits(B, ea, B + ea), _logits(B, eb, B - eb)
    y = np.arange(B, dtype=np.int32) % 10
    ja, jb = jq.QTensor(jnp.asarray(da), xa), jq.QTensor(jnp.asarray(db), xb)
    ta = q.QTensor(_t(da), torch.tensor(xa))
    tb = q.QTensor(_t(db), torch.tensor(xb))
    for jx, tx in ((ja, ta), (jb, tb)):
        np.testing.assert_array_equal(il.pow2_scores(tx).numpy(),
                                      np.asarray(jax.jit(jil.pow2_scores)(jx)))
        np.testing.assert_array_equal(
            q.output_error_int8(tx, _t(y)).numpy(),
            np.asarray(jax.jit(jq.output_error_int8)(jx, jnp.asarray(y))))
    want = jax.jit(jil.int_loss_sign)(ja, jb, jnp.asarray(y))
    got = il.int_loss_sign(ta, tb, _t(y))
    assert got.dtype == torch.int32 and int(got) == int(want)
    want = jax.jit(jil.float_loss)(ja, jnp.asarray(y))
    np.testing.assert_allclose(float(il.float_loss(ta, _t(y))), float(want),
                               rtol=1e-6)


@pytest.mark.parametrize("K,N,b_bp", [(84, 10, 5), (120, 84, 5), (84, 10, 31)])
def test_fc_backward_matches_jax(K, N, b_bp):
    rng = np.random.default_rng(K + b_bp)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    a = rng.integers(0, 128, (16, K), dtype=np.int8)
    e = rng.integers(-127, 128, (16, N)).astype(np.int32)
    jw, ja = jq.QTensor(jnp.asarray(w), np.int32(-8)), \
        jq.QTensor(jnp.asarray(a), np.int32(-5))
    want_w, want_e = jax.jit(jq.fc_backward_int8, static_argnums=3)(
        jw, ja, jnp.asarray(e), b_bp)
    got_w, got_e = q.fc_backward_int8(
        q.QTensor(_t(w), torch.tensor(-8, dtype=torch.int32)),
        q.QTensor(_t(a), torch.tensor(-5, dtype=torch.int32)), _t(e), b_bp)
    np.testing.assert_array_equal(got_w.data.numpy(), np.asarray(want_w.data))
    assert int(got_w.exp) == -8
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))


# ------------------------------------------------------------------ #
# LeNet-5 int8: init, forward, eval
# ------------------------------------------------------------------ #
def test_lenet_int8_init_and_forward_match_jax(jparams):
    params = lenet.init_lenet5_int8(7, device="cpu")
    assert sum(leaf.data.numel() for _, leaf in
               zo.leaves_with_path(params)) == 107_550
    for n, v in jparams.items():
        np.testing.assert_array_equal(params[n]["w"].data.numpy(), v["w"][0])
        assert int(params[n]["w"].exp) == int(v["w"][1])
    xs, _ = jglyphs(6, seed=2)
    jx = jq.quant_from_float(jnp.asarray(xs))
    tx = q.quant_from_float(_t(xs))
    np.testing.assert_array_equal(tx.data.numpy(), np.asarray(jx.data))
    jl, jacts = jax.jit(jlenet.lenet5_forward_int8)(jparams, jx)
    tl, tacts = lenet.lenet5_forward_int8(params, tx)
    np.testing.assert_array_equal(tl.data.numpy(), np.asarray(jl.data))
    assert int(tl.exp) == int(jl.exp)
    assert sorted(tacts) == sorted(jacts)
    for k in tacts:
        np.testing.assert_array_equal(tacts[k].data.numpy(),
                                      np.asarray(jacts[k].data), err_msg=k)
        assert int(tacts[k].exp) == int(jacts[k].exp), k


def test_int8_eval_takes_the_first_maximum():
    logits = np.array([[5, 5, 1], [-3, 2, 2], [0, 0, 0], [1, 9, 9]], np.int8)
    y = np.array([0, 1, 0, 2], np.int32)
    want = float(jnp.mean(jnp.argmax(jnp.asarray(logits), -1)
                          == jnp.asarray(y)))
    fwd = lambda p, x: (q.QTensor(x, torch.tensor(0)), {})  # noqa: E731
    got = elastic_int8.int8_eval(fwd, None, _t(logits), _t(y))
    assert float(got) == want == 0.75


# ------------------------------------------------------------------ #
# whole train steps against JAX's jitted int8 step
# ------------------------------------------------------------------ #
LANE_CASES = [(i, mode) for mode in ("int", "float") for i in range(3)]


def _jlane():
    return dataclasses.replace(_int8_lane_cfg(), zo_num_probes=2)


def _batches():
    xs, ys = jglyphs(BATCH * N_STEPS, seed=0)
    return [(xs[BATCH * s:BATCH * (s + 1)], ys[BATCH * s:BATCH * (s + 1)])
            for s in range(N_STEPS)]


def _jbatch(bx, by):
    return {"x": jq.quant_from_float(jnp.asarray(bx)), "y": jnp.asarray(by)}


@pytest.fixture(scope="module")
def jax_steps(jparams):
    """JAX's jitted int8 step of every (lane, loss mode), compiled ahead:
    each is traced in turn (Python) while XLA compiles the ones traced
    before it in other threads, which keeps this file's time down."""
    state = JState(jparams, jnp.int32(0),
                   jax.random.key_data(jax.random.key(13)))
    batch = _jbatch(*_batches()[0])
    mask = jnp.ones((2,), jnp.float32)
    with ThreadPoolExecutor(len(LANE_CASES)) as pool:
        compiling = {}
        for i, mode in LANE_CASES:
            _, c, tail = JINT8_LANES[i]
            compiling[i, mode] = pool.submit(jax.jit(jmake(
                jlenet.lenet5_forward_int8,
                partition_fn=lambda p, c=c: jlenet.partition_at(p, c),
                tail_fcs=tail, lane=_jlane(), loss_mode=mode)).lower(
                    state, batch, mask).compile)
        return {case: f.result() for case, f in compiling.items()}


@pytest.mark.parametrize("lane_idx,loss_mode", LANE_CASES)
def test_int8_lane_matches_jax(jparams, jax_steps, lane_idx, loss_mode):
    """3 steps at batch 8 with 2 probes, the second masked at step 1:
    parameters bitwise, g and acc equal, loss within 1e-6."""
    name, c, tail = JINT8_LANES[lane_idx]
    assert (name, c, tail) == paper_lanes.INT8_LANES[lane_idx]
    jstep = jax_steps[lane_idx, loss_mode]
    jstate = JState(jparams, jnp.int32(0),
                    jax.random.key_data(jax.random.key(13)))
    step = elastic_int8.make_int8_elastic_step(
        lenet.lenet5_forward_int8,
        partition_fn=lambda p: lenet.partition_at(p, c), tail_fcs=tail,
        lane=LaneConfig(**dataclasses.asdict(_jlane())), loss_mode=loss_mode)
    state = init_state(params_from_jax(jparams, "cpu"), 13)
    for s, (bx, by) in enumerate(_batches()):
        mask = np.ones((2,), np.float32)
        mask[1:] = s != 1
        jstate, jm = jstep(jstate, _jbatch(bx, by), jnp.asarray(mask))
        state, m = step(state, {"x": q.quant_from_float(_t(bx)),
                                "y": _t(by)}, mask)
        where = f"{name} {loss_mode} step {s}"
        assert float(m["g"]) == float(jm["g"]), where
        assert float(m["acc"]) == float(jm["acc"]), where
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=0, atol=1e-6, err_msg=where)
        _assert_q_trees_equal(state.params, jstate.params)
    assert state.step == N_STEPS


def test_lenet_int8_launches_per_step():
    """Kernel calls per step at 1 probe (the counts chip_smoke.py asserts
    on the card): int8_perturb 2 (one for all ZO leaves a perturbation),
    zo_fused_replay_int8 1 (all ZO leaves), int8_matmul 5 per forward and
    2 per tail FC."""
    calls = dict.fromkeys(("int8_perturb_leaves",
                           "zo_fused_replay_int8_leaves", "int8_matmul"), 0)
    mp = pytest.MonkeyPatch()
    for name in calls:
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        mp.setattr(ops, name, counted)
    want = {"full_zo": (2, 1, 10), "zo_feat_cls2": (2, 1, 14),
            "zo_feat_cls1": (2, 1, 12)}
    try:
        xs, ys = jglyphs(4, seed=0)
        batch = {"x": q.quant_from_float(_t(xs)), "y": _t(ys)}
        for name, c, tail in paper_lanes.INT8_LANES:
            step = elastic_int8.make_int8_elastic_step(
                lenet.lenet5_forward_int8,
                partition_fn=lambda p, c=c: lenet.partition_at(p, c),
                tail_fcs=tail, lane=paper_lanes.int8_lane_cfg())
            calls.update(dict.fromkeys(calls, 0))
            params = lenet.init_lenet5_int8(7, device="cpu")
            step(init_state(params, 13), batch, np.ones((1,), np.float32))
            assert tuple(calls.values()) == want[name], name
    finally:
        mp.undo()


def test_apply_tail_records_is_not_ported():
    """The fleet's ledger-domain int8 tail (the name is older than its
    port): an empty tail or no records is a no-op; the workers' int8
    payloads sum in int32 and apply once, clamped to +-127, the exponent
    unchanged. ``tests/test_torch_fleet.py`` holds it against JAX's."""
    eng = engine.engine_for(LaneConfig(lane="elastic_zo_int8"))
    assert isinstance(eng, engine.Int8Engine)
    assert eng.apply_tail_records({}, 0, []) == {}
    w = q.QTensor(torch.tensor([[100, -100], [5, 0]], dtype=torch.int8),
                  torch.tensor(-3, dtype=torch.int32))
    bp = {"fc3": {"w": w}}
    assert eng.apply_tail_records(bp, 0, []) is bp
    upds = [{"fc3": {"w": torch.tensor(u, dtype=torch.int8)}}
            for u in ([[-20, 20], [1, -127]], [[-20, 20], [2, -127]])]
    got = eng.apply_tail_records(bp, 0, upds)["fc3"]["w"]
    assert got.data.tolist() == [[127, -127], [2, 127]]
    assert got.data.dtype == torch.int8 and got.exp is w.exp
