"""Port parity: hash bits, paged attention and top-k/top-p.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode, and its refs) and through the port's plain PyTorch
versions. Contracts: hash bits bitwise, KV writes bitwise, attention
output of active rows within 1e-5 (f32), keep-sets exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import prng as jprng  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attn import paged_attention_step as jpaged  # noqa: E402
from repro.kernels.topk_mask import topk_topp_mask as jtopk  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


# ------------------------------------------------------------------ #
# counter-hash bits
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,salt,shape,offset", [
    (0, 0, (7,), 0),
    (123456789, 0x5E17E1, (3, 5), 17),
    (0xFFFFFFFF, 0xFFFFFFFF, (1000,), 2**32 - 10),   # index wraps 2**32
    (42, 7, (4, 4, 4), 2**31),
    (2**31 + 5, 3, (), 99),
])
def test_uniform_bits_bitwise(seed, salt, shape, offset):
    want = np.asarray(jprng.uniform_bits(jnp.uint32(seed), salt, shape,
                                         offset)).astype(np.int64)
    got = prng.uniform_bits(seed, salt, shape, offset).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_uniform_bits_batched_seeds_are_rows():
    seeds = torch.tensor([1, 2**32 - 1, 77], dtype=torch.int64)
    rows = prng.uniform_bits(seeds, 9, (2, 5), 3)
    for i, s in enumerate(seeds.tolist()):
        want = np.asarray(jprng.uniform_bits(jnp.uint32(s), 9, (2, 5), 3))
        np.testing.assert_array_equal(rows[i].numpy(), want.astype(np.int64))


# ------------------------------------------------------------------ #
# paged attention (cases of tests/test_serve_paged.py)
# ------------------------------------------------------------------ #
def _fused_case(seed=0):
    """Rows 0-2 as in the JAX package's paged tests; row 3 is inactive
    (seq_len 0, all-null table), as engine padding slots are."""
    rng = np.random.default_rng(seed)
    B, KVd, G, Dh, N, ps, P = 4, 2, 4, 16, 16, 8, 4
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((B, KVd, G, Dh), (B, KVd, Dh), (B, KVd, Dh),
             (N, ps, KVd, Dh), (N, ps, KVd, Dh))]
    pt = np.zeros((B, P), np.int32)
    pt[0, :2] = [3, 7]
    pt[1, :4] = [1, 2, 4, 5]
    pt[2, :1] = [9]
    sl = np.array([11, 30, 3, 0], np.int32)
    return arrs, pt, sl


def _run_both(arrs, pt, sl, window):
    q, kn, vn, kp, vp = arrs
    jargs = [jnp.asarray(a) for a in arrs] + [jnp.asarray(pt), jnp.asarray(sl)]
    o_ref, kr, vr = jref.paged_attn_step_ref(*jargs, scale=0.25,
                                             window=window)
    o_pal, kpal, vpal = jpaged(*jargs, scale=0.25, window=window,
                               interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    o = ops.paged_attention_step(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, torch.from_numpy(pt), torch.from_numpy(sl), scale=0.25,
        window=window)
    return (o.numpy(), tk.numpy(), tv.numpy()), \
        [np.asarray(a) for a in (o_ref, kr, vr)], \
        [np.asarray(a) for a in (o_pal, kpal, vpal)]


@pytest.mark.parametrize("window", [0, 6])
def test_paged_attention_matches_jax(window):
    arrs, pt, sl = _fused_case()
    (o, k, v), jr, jp = _run_both(arrs, pt, sl, window)
    for j in (jr, jp):
        assert np.abs(o[:3] - j[0][:3]).max() <= 1e-5
        np.testing.assert_array_equal(k, j[1])       # the fused KV write
        np.testing.assert_array_equal(v, j[2])
    ps_ = arrs[3].shape[1]
    for b, pos in enumerate(sl):
        np.testing.assert_array_equal(k[pt[b, pos // ps_], pos % ps_],
                                      arrs[1][b])


def test_paged_attention_reclaimed_null_pages():
    """Row 1 at pos 30 with window 6: its first three pages are out of
    the window, reclaimed and nulled; its output must not change."""
    arrs, pt, sl = _fused_case()
    (o_full, _, _), _, _ = _run_both(arrs, pt, sl, 6)
    rec = pt.copy()
    rec[1, :3] = 0
    (o, k, v), jr, jp = _run_both(arrs, rec, sl, 6)
    assert np.abs(o[1] - o_full[1]).max() <= 1e-6
    for j in (jr, jp):
        assert np.abs(o[:3] - j[0][:3]).max() <= 1e-5
        np.testing.assert_array_equal(k, j[1])
        np.testing.assert_array_equal(v, j[2])


def test_paged_attention_inactive_row():
    """An inactive row (seq_len 0, all-null table) writes into the null
    page. Active rows and the pools agree with both JAX paths; the
    inactive row follows the JAX ref (mean of the null page's V), where
    the Pallas kernel, like the CUDA kernel, gives 0."""
    arrs, pt, sl = _fused_case(seed=1)
    (o, k, v), jr, jp = _run_both(arrs, pt, sl, 0)
    for j in (jr, jp):
        assert np.abs(o[:3] - j[0][:3]).max() <= 1e-5
        np.testing.assert_array_equal(k, j[1])
        np.testing.assert_array_equal(v, j[2])
    assert np.abs(o[3] - jr[0][3]).max() <= 1e-5
    assert np.abs(jp[0][3]).max() == 0.0


# ------------------------------------------------------------------ #
# sort-free top-k / top-p
# ------------------------------------------------------------------ #
def _topk_case(seed):
    rng = np.random.default_rng(seed)
    B, V = 8, 512
    x = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    x[2] = np.round(x[2])                 # long tied runs
    x[3] = np.round(x[3] * 2) / 2
    x[4, ::7] = -0.0                      # -0.0 beside +0.0 ties
    x[4, 1::7] = 0.0
    k = np.array([50, 0, 1, 20, 0, 10, V, 5], np.int32)
    p = np.array([0.95, 1.0, 1.0, 0.8, 0.5, 1.0, 0.3, 0.999], np.float32)
    return x, k, p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_topp_matches_jax(seed):
    x, k, p = _topk_case(seed)
    got = ops.topk_topp_mask(torch.from_numpy(x), torch.from_numpy(k),
                             torch.from_numpy(p)).numpy()
    want_ref = np.asarray(jref.topk_topp_mask_ref(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(p)))
    want_pal = np.asarray(jtopk(jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(p), interpret=True))
    keep = got > ref.NEG_INF / 2
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(keep, want > ref.NEG_INF / 2)
        np.testing.assert_array_equal(got[keep], want[keep])
    assert keep[1].all() and keep[2].sum() >= 1    # disabled row, k = 1
