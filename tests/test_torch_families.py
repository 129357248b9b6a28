"""Port parity of the MoE, RWKV6 and Mamba/hybrid model math.

The port's ``models/moe.py``, ``models/ssm.py`` and the non-attention
branches of ``models/transformer.py`` against the JAX package in one
process, at ``reduced(..., dtype="float32")``. Parameters come from the
JAX package's init, through numpy (``repro_torch.convert``); the block
tests add seeded noise to every leaf so that the zero- and one-valued
inits (the mixing mus, the norms) take part. Contracts: the MoE keep
mask bitwise and its output within 1e-5; block outputs and states within
1e-4 (the port walks chunk boundaries in order where the reference takes
``jax.lax.associative_scan``'s tree, so sums differ in order); prefill
and paged-decode logits within 1e-4. Each tolerance is absolute for
values up to 1 in magnitude and relative to the largest magnitude above
that: a reduced MoE's outputs reach ~30, where one f32 ulp is 1.9e-6 and
products summed in another order differ by a few.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ServeConfig as JServe  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.transformer import make_paged_caches as jmake_paged  # noqa: E402
from repro.serve import kv_pages as jkv  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ATTN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402
from repro_torch.models.transformer import make_paged_caches  # noqa: E402
from repro_torch.serve import kv_pages  # noqa: E402

TOL = 1e-4
MOE_TOL = 1e-5


def _cfgs(arch, **kw):
    return (jreduced(JARCHS[arch], dtype="float32", **kw),
            tconfigs.reduced(tconfigs.ARCHS[arch], dtype="float32", **kw))


def _rules(jcfg):
    shape = ShapeConfig("b", seq_len=32, global_batch=2, kind="prefill")
    return ShardingRules(None, jcfg, shape)


def _noisy(params, seed):
    """numpy leaves of a JAX param tree, each plus 0.1 N(0, 1) noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape))
        .astype(np.float32), params)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.size:
        err = np.abs(got - want).max()
        assert err <= tol * max(1.0, np.abs(want).max()), err


def _jit(fn, jcfg):
    """The reference block ``fn(p, x, cfg, rules, state)``, jitted (one
    compile a case where eager dispatch compiles every op)."""
    rules = _rules(jcfg)
    return jax.jit(lambda p, x, st: fn(p, x, jcfg, rules, st))


def port_params_for_jax(tcfg, jm):
    """The port's own init of ``tcfg`` (seed 0, on the CPU) as the numpy
    tree the reference takes; its structure, shapes and dtypes are held
    against the reference's init (``jax.eval_shape``, no draw: the
    reference's eager init of reduced Jamba alone takes ~7 s here)."""
    tp = api.init(tcfg, seed=0, device="cpu")
    jp = jax.tree.map(lambda t: np.asarray(t.numpy()), tp)
    want = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(jp) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(jp), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (w.shape, w.dtype)
    return jp, tp


def _states_close(tstate, jstate):
    assert sorted(tstate) == sorted(jstate)
    for name in jstate:
        _close(tstate[name], jstate[name])


# ------------------------------------------------------------------ #
# MoE
# ------------------------------------------------------------------ #
def _jax_routing(p, x, cfg):
    """The reference's routing (repro/models/moe.py, moe_ffn's first
    half) traced in jnp: (sort_idx, keep)."""
    B, S, _ = x.shape
    K = cfg.experts_per_token
    C = jmoe.capacity(cfg, S)
    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    _, top_i = jax.lax.top_k(gates, K)
    slot_e = top_i.reshape(B, S * K)
    sort_idx = jnp.argsort(slot_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(slot_e, sort_idx, axis=1)
    ar = jnp.arange(S * K, dtype=jnp.int32)[None, :]
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), bool), sorted_e[:, 1:] != sorted_e[:, :-1]], 1)
    run_start = jax.lax.cummax(jnp.where(is_start, ar, 0), axis=1)
    return sort_idx, (ar - run_start) < C


def test_moe_ffn_matches_jax_with_dropped_slots():
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    jp = _noisy(jmoe.init_moe(jax.random.key(1), jcfg, jnp.float32), 2)
    tp = params_from_jax(jp, "cpu")
    x = np.random.default_rng(3).normal(size=(3, 16, jcfg.d_model)) \
        .astype(np.float32)
    sort_idx, keep, _, _ = moe.route(tp, torch.from_numpy(x), tcfg)
    j_sort, j_keep = _jax_routing(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(sort_idx.numpy(), np.asarray(j_sort))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    assert not keep.all(), "capacity dropped no slot: the test is vacuous"
    want = _jit(lambda p, x, c, r, _: jmoe.moe_ffn(p, x, c, r), jcfg)(
        jp, jnp.asarray(x), None)
    _close(moe.moe_ffn(tp, torch.from_numpy(x), tcfg), want, MOE_TOL)


# ------------------------------------------------------------------ #
# RWKV6 and Mamba blocks: prefill from zeros, from a state, the S=1 step
# ------------------------------------------------------------------ #
def _block_case(init, state_of, arch, seed):
    jcfg, tcfg = _cfgs(arch)
    jp = _noisy(init(jax.random.key(seed), jcfg, jnp.float32), seed + 1)
    rng = np.random.default_rng(seed + 2)
    x = rng.normal(size=(2, 19, jcfg.d_model)).astype(np.float32)
    state = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         state_of(jcfg, 2, jnp.float32))
    return jcfg, tcfg, jp, params_from_jax(jp, "cpu"), x, state


@pytest.mark.parametrize("S,with_state", [(19, False), (19, True),
                                          (1, True)])
def test_rwkv_time_mix_matches_jax(S, with_state):
    jcfg, tcfg, jp, tp, x, state = _block_case(
        jssm.init_rwkv_block, jssm.init_rwkv_state, "rwkv6-1.6b", 10)
    x = x[:, :S]
    st = state if with_state else None
    jy, jst = _jit(jssm.rwkv_time_mix, jcfg)(jp, jnp.asarray(x), st)
    ty, tst = ssm.rwkv_time_mix(
        tp, torch.from_numpy(x), tcfg,
        None if st is None else params_from_jax(st, "cpu"))
    _close(ty, jy)
    _states_close(tst, jst)


@pytest.mark.parametrize("S,with_init", [(37, False), (37, True), (5, True)])
def test_wkv_chunked_matches_jax(S, with_init):
    rng = np.random.default_rng(S + with_init)
    B, H, Dh = 2, 3, 8
    r, k, v = (rng.normal(size=(B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(1e-4, jssm.DECAY_CLAMP, (B, S, H, Dh)) \
        .astype(np.float32)
    u = rng.normal(size=(H, Dh)).astype(np.float32)
    init = rng.normal(size=(B, H, Dh, Dh)).astype(np.float32) \
        if with_init else None
    jo, jst = jax.jit(jssm._wkv_chunked)(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)),
        init=None if init is None else jnp.asarray(init))
    to, tst = ssm._wkv_chunked(
        *(torch.from_numpy(a) for a in (r, k, v, logw, u)),
        init=None if init is None else torch.from_numpy(init))
    _close(to, jo)
    _close(tst, jst)


@pytest.mark.parametrize("S,with_state", [(19, False), (19, True),
                                          (1, True)])
def test_mamba_block_matches_jax(S, with_state):
    jcfg, tcfg, jp, tp, x, state = _block_case(
        jssm.init_mamba_block, jssm.init_mamba_state, "jamba-v0.1-52b", 30)
    x = x[:, :S]
    st = state if with_state else None
    jy, jst = _jit(jssm.mamba_block, jcfg)(jp, jnp.asarray(x), st)
    ty, tst = ssm.mamba_block(
        tp, torch.from_numpy(x), tcfg,
        None if st is None else params_from_jax(st, "cpu"))
    _close(ty, jy)
    _states_close(tst, jst)


def test_mamba_segments_match_jax(monkeypatch):
    """A prefill longer than one segment carries the state across the
    segment boundary (SEGMENT cut to 8 in both packages)."""
    monkeypatch.setattr(jssm, "SEGMENT", 8)
    monkeypatch.setattr(ssm, "SEGMENT", 8)
    jcfg, tcfg, jp, tp, x, _ = _block_case(
        jssm.init_mamba_block, jssm.init_mamba_state, "jamba-v0.1-52b", 40)
    jy, jst = _jit(jssm.mamba_block, jcfg)(jp, jnp.asarray(x), None)
    ty, tst = ssm.mamba_block(tp, torch.from_numpy(x), tcfg, None)
    _close(ty, jy)
    _states_close(tst, jst)


# ------------------------------------------------------------------ #
# whole models: prefill logits, admission, one paged decode step
# ------------------------------------------------------------------ #
FAMILIES = ["jamba-v0.1-52b", "rwkv6-1.6b", "mixtral-8x7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_paged_decode_logits_match_jax(arch):
    """Two rows of 20 tokens (beyond reduced Mixtral's window of 16), one
    paged decode step each from slots 2 and 0 of 3."""
    jcfg, tcfg = _cfgs(arch)
    S, ps, slots, npages = 20, 4, 3, 16
    P = JServe(page_size=ps, max_seq_len=24).max_pages_per_seq
    shape = ShapeConfig("p", seq_len=S, global_batch=2, kind="prefill")
    jm = japi.build(jcfg, shape, JLane(), ShardingRules(None, jcfg, shape))
    jparams, tparams = port_params_for_jax(tcfg, jm)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    last = np.full(2, S - 1, np.int32)
    jl, jdense = jax.jit(jm.prefill_logits)(
        jparams, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    tl, tdense = api.prefill_logits(tparams, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(last))
    _close(tl, jl)

    pages = [[3, 5, 1, 2, 4], [6, 7, 8, 9, 10]]
    table = np.zeros((slots, P), np.int32)
    row_of = {2: 0, 0: 1}                       # slot -> prefill row
    for slot, row in row_of.items():
        table[slot, :5] = pages[row]
        table[slot, 5] = 11 + row                # the write opens page 6
    pos = np.array([S, 0, S], np.int32)          # slot 1 inactive
    dshape = ShapeConfig("d", seq_len=24, global_batch=slots, kind="decode")
    drules = ShardingRules(None, jcfg, dshape)
    jmd = japi.build(jcfg, dshape, JLane(), drules)
    jc = japi.split_caches(jmake_paged(jcfg, slots, npages, ps, drules),
                           jcfg, JLane())
    jc = jkv.admit_prefill(jc, jdense, jcfg, [2, 0], pages, ps, P)
    nxt = np.array([[11], [0], [22]], np.int32)
    jd, jc = jax.jit(jmd.decode_step_paged)(
        jparams, jnp.asarray(nxt), jc, jnp.asarray(table), jnp.asarray(pos))

    tc = api.split_caches(
        make_paged_caches(tcfg, slots, npages, ps, device="cpu"),
        tcfg, tconfigs.LaneConfig())
    kv_pages.admit_prefill(tc, tdense, tcfg, [2, 0], pages, ps, P)
    td = api.decode_step_paged(tparams, tcfg, torch.from_numpy(nxt), tc,
                               torch.from_numpy(table), torch.from_numpy(pos))
    active = [0, 2]
    _close(td[active], np.asarray(jd)[active])
    for part in ("zo", "bp"):                    # the slots' new state
        for kind, te, je in zip(tcfg.pattern, tc[part], jc[part]):
            if kind != ATTN:
                for name in je:
                    _close(te[name][:, active],
                           np.asarray(je[name])[:, active])


# ------------------------------------------------------------------ #
# conversion keeps each leaf's own dtype on request
# ------------------------------------------------------------------ #
def test_convert_keeps_the_bf16_models_router_f32():
    """Reduced Jamba in bf16, the reference's init of its first two
    blocks (Mamba + dense FFN, Mamba + MoE FFN)."""
    jcfg = jreduced(JARCHS["jamba-v0.1-52b"])            # bf16
    jp = {f"blk{i}": jax.tree.map(np.asarray, jtf.init_block(
        jax.random.key(i), jcfg, kind, i, jnp.bfloat16))
        for i, kind in enumerate(jcfg.pattern[:2])}
    assert "moe" in jp["blk1"] and "mlp" in jp["blk0"]
    tp = params_from_jax(jp, "cpu", dtype=None)
    n_f32 = 0
    for (path, w), t in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree.leaves(tp)):
        want = torch.float32 if w.dtype == np.float32 else torch.bfloat16
        assert t.dtype == want, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32))
        n_f32 += t.dtype == torch.float32
    assert tp["blk1"]["moe"]["router"].dtype == torch.float32
    assert n_f32 == 1                       # the router, and nothing else
    # a caller that names a dtype still gets every float leaf in it
    assert params_from_jax(jp, "cpu", torch.bfloat16)["blk1"]["moe"][
        "router"].dtype == torch.bfloat16
