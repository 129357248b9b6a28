"""Port parity: ZO noise, probe keys, salts and the two ZO kernels' plain
versions.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode, and its refs) and through the port. Contracts: hash bits,
probe seeds, salts and the engine's host coefficients bitwise; Box-Muller
z within 4 ulp (torch's CPU log/cos against XLA's); a perturbed or
replayed leaf within 2 f32 ulp (1 bf16 ulp), since a 4-ulp z moves the
f32 sum by less than one rounding step; S single-step replays equal one
S-step replay bitwise in the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import elastic as jelastic  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import prng as jprng  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.zo_fused_replay import zo_fused_replay as jreplay  # noqa: E402
from repro.kernels.zo_perturb import zo_perturb as jperturb  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.core import engine, keys, prng, zo  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

Z_ULP = 4
SEEDS = np.array([[112, 913], [77, 41], [5, 2**31 + 9]], np.uint32)
COEFFS = np.array([[3e-3, -1e-3], [0.0, 2e-3], [-5e-4, 1e-4]], np.float32)
# tolerance on a perturbed / replayed leaf, relative to the leaf dtype
LEAF_TOL = {"float32": dict(rtol=2 * 2.0**-23, atol=1e-7),
            "bfloat16": dict(rtol=2.0**-7, atol=1e-6)}


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _seed_tensor(seeds):
    return torch.from_numpy(np.asarray(seeds, np.uint32).view(np.int32).copy())


# ------------------------------------------------------------------ #
# noise
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,salt,n,offset", [
    (123, 5, 20000, 0),
    (2**32 - 1, 2**30 - 1, 5000, 2**32 - 100),      # index wraps 2**32
    (0, 0, 777, 3),
])
def test_normal_streams_bitwise_and_z_within_ulp(seed, salt, n, offset):
    for s in (2 * salt + 1, 2 * salt + 2):
        want = np.asarray(jprng.uniform_bits(jnp.uint32(seed), np.uint32(s),
                                             (n,), offset))
        got = prng.uniform_bits(seed, s, (n,), offset).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    zj = np.asarray(jprng.normal(jnp.uint32(seed), salt, (n,), offset))
    zt = prng.normal(seed, salt, (n,), offset).numpy()
    assert zt.dtype == np.float32 and np.isfinite(zt).all()
    assert _ulp(zt, zj).max() <= Z_ULP


@pytest.mark.parametrize("s", [0, 7, 11, 12345, 2**31 - 1])
def test_probe_seeds_bitwise(s):
    base = jax.random.key(s)
    np.testing.assert_array_equal(keys.key_data(s),
                                  np.asarray(jax.random.key_data(base)))
    for step in (0, 1, 2**31 - 1):
        k_step = jax.random.fold_in(base, step)
        for i in (0, 1, 3):
            want = int(jprng.seed_from_key(jax.random.fold_in(k_step, i)))
            got = prng.seed_from_key(
                keys.fold_in(keys.fold_in(keys.key_data(s), step), i))
            assert got == want, (s, step, i)


def test_lenet_init_stream_within_ulp():
    """keys.normal is jax.random.normal: the LeNet-5 init of both packages
    from the same seed agrees within 4 ulp, leaf by leaf."""
    from repro_torch.models import lenet
    want = jlenet.init_lenet5(jax.random.key(7))
    got = lenet.init_lenet5(7, device="cpu")
    for name in lenet.LAYER_NAMES:
        for leaf in ("w", "b"):
            assert _ulp(got[name][leaf].numpy(),
                        np.asarray(want[name][leaf])).max() <= Z_ULP


# ------------------------------------------------------------------ #
# salts
# ------------------------------------------------------------------ #
def _jax_salts(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): jzo.path_salt(p) for p, _ in flat}


def _port_salts(tree):
    return {zo.keystr(p): zo.path_salt(p) for p, _ in zo.leaves_with_path(tree)}


def test_path_salt_lenet_tree():
    from repro_torch.models import lenet
    jp = jlenet.init_lenet5(jax.random.key(0))
    tp = lenet.init_lenet5(0, device="cpu")
    want = _jax_salts(jp)
    assert _port_salts(tp) == want and "['conv1']['w']" in want
    for c in (3, 4):            # the ZO head of the elastic lanes
        assert _port_salts(lenet.partition_at(tp, c)[0]) == \
            _jax_salts(jlenet.partition_at(jp, c)[0])


def test_path_salt_reduced_lm_tree():
    from repro_torch import configs
    from repro_torch.core import api, elastic
    cfg = jreduced(JARCHS["qwen3-4b"])
    lane = JLane(lane="elastic_zo")
    shape = ShapeConfig("t", seq_len=8, global_batch=1, kind="train")
    m = japi.build(cfg, shape, lane, ShardingRules(None, cfg, shape))
    jzo_part, _ = jelastic.partition(m.init(jax.random.key(0)), lane)
    tcfg = configs.reduced(configs.ARCHS["qwen3-4b"])
    tlane = LaneConfig(lane="elastic_zo")
    tzo_part, _ = elastic.partition(api.init(tcfg, tlane, device="cpu"), tlane)
    want = _jax_salts(jzo_part)
    assert "['periods_zo']['blk0']['mlp']['w_gate']" in want
    assert _port_salts(tzo_part) == want


# ------------------------------------------------------------------ #
# the plain versions of the two kernels
# ------------------------------------------------------------------ #
def _theta(dtype, n=3000, seed=0):
    a = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **LEAF_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, -1e-2])
def test_zo_perturb_ref_matches_jax(dtype, scale):
    j, t = _theta(dtype)
    seed, salt = 2**31 + 77, 0x1234567
    got = ops.zo_perturb(t, _seed_tensor([seed]), salt, scale)
    assert got.dtype == t.dtype and got.shape == t.shape
    want_ref = jref.zo_perturb_ref(j, jnp.uint32(seed), salt,
                                   jnp.float32(scale))
    want_pal = jperturb(j, jnp.uint32(seed), salt, jnp.float32(scale),
                        interpret=True)
    for want in (want_ref, want_pal):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zo_fused_replay_ref_matches_jax(dtype):
    j, t = _theta(dtype, seed=1)
    salt = 4242
    got = ops.zo_fused_replay(t, _seed_tensor(SEEDS), torch.from_numpy(COEFFS),
                              salt)
    want_ref = jref.zo_fused_replay_ref(j, jnp.asarray(SEEDS),
                                        jnp.asarray(COEFFS), salt)
    want_pal = jreplay(j, jnp.asarray(SEEDS), jnp.asarray(COEFFS), salt,
                       interpret=True)
    for want in (want_ref, want_pal):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_equals_single_steps_bitwise(dtype):
    t = torch.from_numpy(np.random.default_rng(2).normal(size=(4097,))
                         .astype(np.float32)).to(dtype)
    seeds, coeffs = _seed_tensor(SEEDS), torch.from_numpy(COEFFS)
    fused = ops.zo_fused_replay(t, seeds, coeffs, 13)
    live = t.clone()
    for s in range(seeds.shape[0]):
        ops.zo_fused_replay(live, seeds[s:s + 1], coeffs[s:s + 1], 13,
                            out=live)
    assert torch.equal(fused, live)
    # zero coefficients are an exact no-op
    assert torch.equal(ops.zo_fused_replay(t, seeds, 0 * coeffs, 13), t)


def test_offset_chunks_equal_whole_leaf():
    """The plain versions over flat-index chunks (``offset``) tile the
    whole-leaf result exactly, as chip_smoke.py checks a large leaf."""
    t = torch.from_numpy(np.random.default_rng(3).normal(size=(1000,))
                         .astype(np.float32))
    seeds, coeffs = _seed_tensor(SEEDS), torch.from_numpy(COEFFS)
    whole_p = ref.zo_perturb_ref(t, 99, 5, 1e-3)
    whole_r = ref.zo_fused_replay_ref(t, seeds, coeffs, 5)
    for lo, hi in ((0, 384), (384, 1000)):
        assert torch.equal(ref.zo_perturb_ref(t[lo:hi], 99, 5, 1e-3, lo),
                           whole_p[lo:hi])
        assert torch.equal(ref.zo_fused_replay_ref(t[lo:hi], seeds, coeffs,
                                                   5, lo), whole_r[lo:hi])


def test_tree_perturb_update_and_noise_match_jax():
    """core/zo.py over a LeNet-5 tree: perturb, zo_update, leaf_noise and
    projected_gradient against the JAX package's."""
    from repro_torch.convert import params_from_jax
    jp = jlenet.init_lenet5(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    key = jax.random.fold_in(jax.random.key(3), 5)
    seed = _seed_tensor([prng.seed_from_key(keys.fold_in(keys.key_data(3),
                                                         5))])
    for got, want in ((zo.perturb(tp, seed, -1e-3), jzo.perturb(jp, key, -1e-3)),
                      (zo.zo_update(tp, seed, torch.tensor(2e-3)),
                       jzo.zo_update(jp, key, jnp.float32(2e-3)))):
        for name in got:
            for leaf in ("w", "b"):
                _close(got[name][leaf], want[name][leaf], "float32")
    (path, leaf), = [(p, x) for p, x in
                     jax.tree_util.tree_flatten_with_path(jp)[0]
                     if jax.tree_util.keystr(p) == "['fc1']['w']"]
    z = zo.leaf_noise(seed, ("fc1", "w"), tp["fc1"]["w"])
    assert _ulp(z.numpy(), np.asarray(jzo.leaf_noise(key, path, leaf))).max() \
        <= Z_ULP
    lp, lm = np.float32(2.3125), np.float32(2.3),
    for clip in (None, 1.0):
        assert float(zo.projected_gradient(torch.tensor(lp), torch.tensor(lm),
                                           1e-2, clip)) == \
            float(jzo.projected_gradient(jnp.float32(lp), jnp.float32(lm),
                                         1e-2, clip))


# ------------------------------------------------------------------ #
# engine scalars and ledger replay
# ------------------------------------------------------------------ #
def test_decay_and_host_coeffs_match_jax():
    kw = dict(lane="elastic_zo", learning_rate=5e-3, zo_eps=1e-2,
              zo_num_probes=4, zo_clip=100.0, lr_decay_factor=0.8,
              lr_decay_every=15)
    jl, tl = JLane(**kw), LaneConfig(**kw)
    for step in (0, 14, 15, 151):
        assert engine.decay_host(tl, step) == jengine.decay_host(jl, step)
        assert float(engine.decay_traced(tl, torch.tensor(step))) == \
            float(jengine.decay_traced(jl, jnp.int32(step)))
    deltas = np.array([0.3, -2.5, 1e-5, 4.0], np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    got = engine.Fp32Engine(tl).host_coeffs(151, deltas, mask)
    want = jengine.Fp32Engine(jl).host_coeffs(151, deltas, mask)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_apply_zo_records_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": {"w": rng.normal(size=(7, 33)).astype(np.float32)},
            "b": rng.normal(size=(65,)).astype(np.float32)}
    want = jengine.Fp32Engine.apply_zo_records(
        jax.tree.map(jnp.asarray, tree), SEEDS.astype(np.uint64), COEFFS)
    got = engine.Fp32Engine.apply_zo_records(
        {"a": {"w": torch.from_numpy(tree["a"]["w"])},
         "b": torch.from_numpy(tree["b"])}, SEEDS.astype(np.uint64), COEFFS)
    _close(got["a"]["w"], want["a"]["w"], "float32")
    _close(got["b"], want["b"], "float32")


# ------------------------------------------------------------------ #
# the fused probe pair's slice noise, and the SPSA estimate
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perturb_slice_draws_the_stacked_leaf_noise(dtype):
    """The port's twin of tests/test_fused.py::
    test_offset_noise_matches_stacked_slice. Slice l of a stacked leaf,
    perturbed by ``perturb_slice`` at offset l * size, equals slice l of
    the whole perturbed leaf bitwise; its z is JAX's ``prng.normal(...,
    offset=l * size)`` within Z_ULP (the hash bits under it are JAX's
    bitwise, test_normal_streams_bitwise_and_z_within_ulp), and the
    perturbed slice is JAX's ``perturb_slice`` within the leaf tolerance."""
    rng = np.random.default_rng(8)
    stacked = rng.normal(size=(6, 4, 8)).astype(np.float32)
    jstack = jnp.asarray(stacked, getattr(jnp, dtype))
    tstack = torch.from_numpy(stacked).to(getattr(torch, dtype))
    seed = 2**31 + 99
    key = _seed_tensor([seed])
    salt = zo.path_salt(("blk0", "w"), "['periods_zo']")
    assert salt == jzo.path_salt((jax.tree_util.DictKey("periods_zo"),
                                  jax.tree_util.DictKey("blk0"),
                                  jax.tree_util.DictKey("w")))
    salts, sizes = {"blk0": {"w": salt}}, {"blk0": {"w": 32}}
    whole = zo.perturb({"periods_zo": {"blk0": {"w": tstack}}}, key,
                       1e-3)["periods_zo"]["blk0"]["w"]
    for l in range(6):
        got = zo.perturb_slice({"blk0": {"w": tstack[l]}}, salts, sizes, l,
                               key, 1e-3)["blk0"]["w"]
        assert torch.equal(got, whole[l])
        want = jzo.perturb_slice({"blk0": {"w": jstack[l]}}, salts, sizes,
                                 jnp.int32(l), jnp.uint32(seed), 1e-3)
        _close(got, want["blk0"]["w"], dtype)
        z = zo.perturb_slice({"blk0": {"w": torch.zeros(4, 8)}}, salts, sizes,
                             l, key, 1.0)["blk0"]["w"]
        zj = jprng.normal(jnp.uint32(seed), salt, (4, 8), offset=l * 32)
        assert _ulp(z.numpy(), zj).max() <= Z_ULP


@pytest.mark.parametrize("clip", [None, 0.5])
def test_spsa_gradient_estimate_matches_jax(clip):
    from repro.models import lenet as jl
    from repro_torch.convert import params_from_jax
    from repro_torch.models import lenet as tl
    jp = jl.init_lenet5(jax.random.key(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    x = np.random.default_rng(0).normal(size=(8, 28, 28, 1)).astype(np.float32)
    y = np.arange(8, dtype=np.int32)
    key = jax.random.fold_in(jax.random.key(4), 2)
    seed = _seed_tensor([prng.seed_from_key(keys.fold_in(keys.key_data(4),
                                                         2))])
    jg, jlp, jlm = jzo.spsa_gradient_estimate(
        lambda p: jl.lenet5_loss(p, {"x": jnp.asarray(x), "y": jnp.asarray(y)}),
        jp, key, 1e-2, clip)
    g, lp, lm = zo.spsa_gradient_estimate(
        lambda p: tl.lenet5_loss(p, {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y)}),
        tp, seed, 1e-2, clip)
    for got, want in ((lp, jlp), (lm, jlm)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # g = (l+ - l-) / 2eps: the losses' rounding over 2eps = 0.02
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-3, atol=2e-4)
    assert clip is None or abs(float(g)) <= clip
