"""Port parity: the int8 lane's noise kernels as one launch per model.

On the card ``int8_perturb`` and ``zo_fused_replay_int8`` take a table of
leaves and two integer constants computed on the host in place of the
float keep test and the runtime remainder. Here, on the CPU:

  * the multi-leaf entry points of ``kernels/ops.py`` (their plain path)
    equal the per-leaf plain versions and JAX's ``repro.kernels.ref``
    bitwise, at LeNet-5's int8 leaves and on ragged views that start off
    16-byte alignment;
  * ``keep_bound`` gives the float32 keep test exactly as an integer one;
  * Lemire's fastmod, computed in the 32-bit pieces the kernel uses,
    equals ``%``;
  * ``psr_shift`` keeps XLA's int32 arithmetic at INT_MIN.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import int8 as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import int8 as q  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.zo_perturb import fastmod_magic, keep_bound  # noqa: E402

R_MAX, P_ZERO, SHIFT = 3, 0.33, 1
# LeNet-5's five int8 leaves (conv1 and fc3 end in a ragged tail of the
# kernels' 16-element runs), then two views of one buffer that start off
# 16-byte alignment
LENET = [(5, 5, 1, 6), (5, 5, 6, 16), (784, 120), (120, 84), (84, 10)]
VIEWS = [(1, (150,)), (307, (7, 41))]
SALTS = [11, 2**30 - 1, 0, 977, 123456]


def _leaves(seed=0):
    """(numpy leaves, torch leaves): LeNet-5's shapes, then the views."""
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(-127, 128, s, dtype=np.int8) for s in LENET]
    flat = torch.from_numpy(rng.integers(-127, 128, 1000, dtype=np.int8))
    views = [flat[o:o + int(np.prod(s))].view(s) for o, s in VIEWS]
    return (arrs + [v.numpy().copy() for v in views],
            [torch.from_numpy(a.copy()) for a in arrs] + views)


def _salts(n):
    return (SALTS * 2)[:n]


def _seeds(steps, probes, seed=3):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, (steps, probes), dtype=np.uint64)
    gs = rng.choice(np.array([-1, 1], np.int32), size=(steps, probes))
    gs[steps // 2, probes // 2] = 0
    return seeds.astype(np.uint32), gs


def _u32_seed(s):
    return torch.from_numpy(np.array([s], np.uint32).view(np.int32))


@pytest.mark.parametrize("k", [1, -1])
def test_perturb_leaves_plain_equals_per_leaf_and_jax(k):
    arrs, leaves = _leaves()
    salts, seed = _salts(len(leaves)), 2**31 + 77
    got = ops.int8_perturb_leaves(leaves, _u32_seed(seed), salts, k, R_MAX,
                                  P_ZERO)
    assert len(got) == len(leaves)
    for a, t, g, salt in zip(arrs, leaves, got, salts):
        one = ref.int8_perturb_ref(t, _u32_seed(seed), salt, k, R_MAX, P_ZERO)
        want = jref.int8_perturb_ref(jnp.asarray(a), jnp.uint32(seed), salt,
                                     k, R_MAX, jnp.float32(P_ZERO))
        assert g.shape == t.shape and g.dtype == torch.int8
        assert torch.equal(g, one)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("steps,probes", [(1, 1), (8, 4)])
def test_replay_leaves_plain_equals_per_leaf_jax_and_in_place(steps, probes):
    arrs, leaves = _leaves(1)
    salts = _salts(len(leaves))
    seeds, gs = _seeds(steps, probes)
    sd, g = torch.from_numpy(seeds.view(np.int32)), torch.from_numpy(gs)
    got = ops.zo_fused_replay_int8_leaves(leaves, sd, g, salts, R_MAX, P_ZERO,
                                          SHIFT)
    for a, t, n, salt in zip(arrs, leaves, got, salts):
        one = ref.zo_fused_replay_int8_ref(t, sd, g, salt, R_MAX, P_ZERO,
                                           SHIFT)
        want = jref.zo_fused_replay_int8_ref(
            jnp.asarray(a), jnp.asarray(seeds), jnp.asarray(gs), salt, R_MAX,
            jnp.float32(P_ZERO), SHIFT)
        assert torch.equal(n, one)
        np.testing.assert_array_equal(n.numpy(), np.asarray(want))
    live = [t.clone() for t in leaves]
    out = ops.zo_fused_replay_int8_leaves(live, sd, g, salts, R_MAX, P_ZERO,
                                          SHIFT, outs=live)
    assert all(o is t for o, t in zip(out, live))
    assert all(torch.equal(a, b) for a, b in zip(live, got))


def test_replay_int8_in_place_steps_equal_one_replay():
    """S single in-place steps of ``core.int8.replay_int8`` over a QTensor
    tree equal one S-step call, and leave the exponents alone."""
    _, leaves = _leaves(2)
    params = {f"l{i}": {"w": q.qtensor(t.clone(), -7 - i)}
              for i, t in enumerate(leaves)}
    seeds, gs = _seeds(4, 2, seed=5)
    sd, g = torch.from_numpy(seeds.view(np.int32)), torch.from_numpy(gs)
    once = q.replay_int8(params, sd, g, R_MAX, P_ZERO, SHIFT)
    for s in range(4):
        assert q.replay_int8(params, sd[s:s + 1], g[s:s + 1], R_MAX, P_ZERO,
                             SHIFT, in_place=True) is params
    for name in params:
        assert torch.equal(params[name]["w"].data, once[name]["w"].data)
        assert int(once[name]["w"].exp) == -7 - int(name[1:])


def _keep_f32(bits, p_zero):
    """The plain version's keep test on uint32 values held in int64."""
    return torch.from_numpy(bits).to(torch.float32) < q.keep_threshold(p_zero)


@pytest.mark.parametrize("p_zero", [0.0, 0.33, 0.5, 1.0])
def test_keep_bound_equals_the_f32_test_near_the_bound(p_zero):
    T = keep_bound(p_zero)
    assert 0 <= T <= 2**32
    bits = np.arange(max(T - 2**16, 0), min(T + 2**16, 2**32 - 1) + 1,
                     dtype=np.int64)
    want = _keep_f32(bits, p_zero)
    np.testing.assert_array_equal(torch.from_numpy(bits < T).numpy(),
                                  want.numpy())
    jax_keep = (jnp.asarray(bits.astype(np.uint32)).astype(jnp.float32)
                < jnp.float32(q.keep_threshold(p_zero)))
    np.testing.assert_array_equal(np.asarray(jax_keep), want.numpy())


@pytest.mark.parametrize("p_zero", [0.0, 0.33, 0.5, 1.0])
def test_keep_bound_equals_the_f32_test_on_random_bits(p_zero):
    bits = np.random.default_rng(7).integers(0, 2**32, 2**20, dtype=np.int64)
    bits[:4] = [0, 1, 2**32 - 1, 2**32 - 128]
    np.testing.assert_array_equal(bits < keep_bound(p_zero),
                                  _keep_f32(bits, p_zero).numpy())


def test_keep_bound_ends():
    """p_zero 0 keeps below 2**32 - 128 (float32(2**32 - 128) rounds to
    2**32, the threshold); p_zero 1 keeps nothing; a threshold above
    every float32 of a uint32 keeps everything."""
    assert keep_bound(0.0) == 2**32 - 128
    assert keep_bound(1.0) == 0
    assert keep_bound(-1.0) == 2**32


def _fastmod(a, d):
    """The kernel's fastmod (csrc/zo_noise.cuh) in numpy uint64: low =
    magic * a mod 2**64, then (low * d) >> 64 in 32-bit pieces."""
    a = a.astype(np.uint64)
    low = np.uint64(fastmod_magic(d)) * a
    hi, lo = low >> np.uint64(32), low & np.uint64(0xFFFFFFFF)
    d = np.uint64(d)
    return (hi * d + ((lo * d) >> np.uint64(32))) >> np.uint64(32)


@pytest.mark.parametrize("r_max", [0, 1, 2, 3, 4, 5, 6, 7])
def test_fastmod_equals_remainder(r_max):
    d = 2 * r_max + 1
    edges = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1]
    mult = np.arange(0, 2**32, d * 4099, dtype=np.int64)
    near = np.concatenate([mult - 1, mult, mult + 1, 2**32 - 1 - np.arange(64),
                           np.array(edges)])
    near = near[(near >= 0) & (near < 2**32)]
    rnd = np.random.default_rng(r_max).integers(0, 2**32, 2**20,
                                                dtype=np.int64)
    for a in (near, rnd):
        np.testing.assert_array_equal(_fastmod(a, d).astype(np.int64), a % d)


@pytest.mark.parametrize("s", [-3, 0, 1, 5, 31, 32, 33, 40])
def test_psr_shift_keeps_int32_at_int_min(s):
    """XLA holds |INT_MIN| as INT_MIN, so every intermediate is an int32
    value."""
    x = np.array([-2**31, -2**31 + 1, 2**31 - 1, -5, 5, 0], np.int32)
    np.testing.assert_array_equal(
        q.psr_shift(torch.from_numpy(x), s).numpy(),
        np.asarray(jq.psr_shift(jnp.asarray(x), jnp.int32(s))))
