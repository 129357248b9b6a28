"""Port parity: the ElasticZO step of the MoE, RWKV6 and Mamba/hybrid
families against the JAX package.

Reduced f32 Mixtral and RWKV6 at two periods (so that the BP tail holds
MoE, RWKV6 and attention blocks), Mixtral at one period, and Jamba at two
periods and at one each take one elastic_zo step. A one-period stack has
an empty BP-period tail: its BP part is the final norm and the
unembedding only. Jamba's two-period tail is a whole Jamba period, so its
step differentiates Mamba, attention and MoE blocks. Every case runs at
batch 2 x seq 24, which passes reduced Mixtral's window of 16 and is not
a multiple of the recurrent chunk (16). Both packages start from the
port's init (seed 0), handed to JAX as numpy, and the same key data and
batch.

The JAX side of Mixtral and RWKV6 is the package's jitted ``train_step``,
traced once a case in a module fixture. JAX traces and compiles reduced
Jamba's whole elastic_zo step in ~50 s here, so Jamba's JAX side is the
same step put together from the package's own parts (``jax_probe_step``):
``zo.perturb`` (jitted once for both Jamba cases, whose ZO heads have one
shape) at +eps and -eps, the jitted value and tail gradient of
``loss_fn`` at each, ``zo.projected_gradient``, the update
theta - coeff * z (``zo.perturb`` at -coeff, which is
``Fp32Engine.zo_apply`` of one probe) and ``Fp32Engine.tail_apply`` of
the averaged tail gradient.

The step's metrics carry the probe pair: ``loss`` is (l+ + l-) / 2 and
``zo_g`` is |g| = |l+ - l-| / 2 eps, the coefficient over the learning
rate; its sign shows in the ZO head's update. Tolerances, relative to
max(1, |value|): ``loss`` within 1e-5 (a mean over 48 tokens of f32 sums
taken in another order; 1.5e-7 seen); ``zo_g`` within 5e-3, since
1 / 2 eps = 500 amplifies the losses' rounding (1e-4 seen); every
parameter after the step within 1e-4, the bound the recurrent chunk walks
set (the port walks chunk boundaries in order where the reference takes
``associative_scan``'s tree; 2.3e-5 seen). The BP part's change in the
step, lr x the tail gradient, is a small part of a parameter (1e-5 to
1e-3 here), so it is also held alone: each tail leaf's change within one
ulp of its new value plus TAIL_TOL = 1e-4 of the largest change of that
leaf in JAX's step (2.4e-5 seen, Jamba's Mamba x_proj; 5e-7 Mixtral,
2e-6 RWKV6). A change below an ulp of its leaf (Mamba's dt_bias, -4.6)
shows nothing of the gradient, so the tail gradients are held directly
too: the port's autograd of the +eps probe's loss over each BP leaf
within GRAD_TOL = 1e-4 of that leaf's largest gradient in JAX (3.0e-5
seen, Jamba's Mamba B_norm and C_norm; 1.5e-6 Mixtral, 6.5e-6 RWKV6).
In the port, the fused antithetic pair's losses are bitwise the unfused
ones.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import elastic as jelastic  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.core.elastic import TrainState as JState  # noqa: E402
from repro.core.engine import Fp32Engine, tail_learning_rate  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.core import api, elastic, keys, prng, zo  # noqa: E402
from repro_torch.core.elastic import TrainState  # noqa: E402
from repro_torch.data.synthetic import token_batch  # noqa: E402

B, S = 2, 24
LOSS_TOL = 1e-5
G_TOL = 5e-3
PARAM_TOL = 1e-4
TAIL_TOL = 1e-4
GRAD_TOL = 1e-4
CASES = {   # name: (arch, config overrides, JAX side: its step or its parts)
    "mixtral": ("mixtral-8x7b", {}, "train_step"),
    "rwkv6": ("rwkv6-1.6b", {}, "train_step"),
    "mixtral-1-period": ("mixtral-8x7b", {"num_layers": 1}, "train_step"),
    "jamba-2-periods": ("jamba-v0.1-52b", {"num_layers": 16}, "parts"),
    "jamba-1-period": ("jamba-v0.1-52b", {}, "parts"),
}
_jax_perturb = jax.jit(jzo.perturb)


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if want.size:
        err = np.abs(got - want).max()
        assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _clone(tree):
    return zo.map_with_path(lambda _p, t: t.clone(), tree)


def jax_probe(m, jl, params, batch, seed):
    """(zo_part, bp_part, key, at): ``key`` is step 0's probe 0 key
    (``Fp32Engine.make_step``'s), and ``at(scale)`` JAX's loss and its
    gradient over the BP part with the ZO head at theta + scale * z."""
    zo_part, bp_part = jelastic.partition(params, jl)
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.wrap_key_data(jnp.asarray(seed)), 0), 0)
    value_grad = jax.jit(jax.value_and_grad(
        lambda bp, zp: m.loss_fn(jelastic.merge(zp, bp), batch)))

    def at(scale):
        return value_grad(bp_part,
                          _jax_perturb(zo_part, key, jnp.float32(scale)))
    return zo_part, bp_part, key, at


def jax_probe_step(m, jl, params, batch, seed):
    """JAX's elastic_zo step of one probe at step 0 from the package's
    parts, in ``Fp32Engine.make_step``'s order (probe mask all ones):
    (metrics, new params, the +eps probe's tail gradient)."""
    assert jl.zo_num_probes == 1 and jl.bp_grad_mode == "avg_perturbed"
    zo_part, bp_part, key, at = jax_probe(m, jl, params, batch, seed)
    (lp, gp), (lm, gm) = at(jl.zo_eps), at(-jl.zo_eps)
    g = jzo.projected_gradient(lp, lm, jl.zo_eps, jl.zo_clip)
    coeff = jnp.float32(jl.learning_rate) * g
    new_zo = _jax_perturb(zo_part, key, -coeff)
    tail_grad = jax.tree.map(lambda a, b: (a + b) * 0.5, gp, gm)
    new_bp = Fp32Engine.tail_apply(bp_part, tail_grad,
                                   jnp.float32(tail_learning_rate(jl)))
    return ({"loss": 0.5 * (lp + lm), "zo_g": jnp.abs(g)},
            jelastic.merge(new_zo, new_bp), gp)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One elastic_zo step in both packages from the same init; the
    port's init is kept (a step updates the ZO head in place)."""
    arch, kw, jax_side = CASES[request.param]
    jcfg = jreduced(JARCHS[arch], dtype="float32", **kw)
    cfg = configs.reduced(configs.ARCHS[arch], dtype="float32", **kw)
    jl = JLane(lane="elastic_zo")
    lane = LaneConfig(**dataclasses.asdict(jl))
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    m = japi.build(jcfg, shape, jl, ShardingRules(None, jcfg, shape))

    init = api.init(cfg, lane, seed=0, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), init)
    want = jax.eval_shape(m.init, jax.random.key(0))
    assert jax.tree.structure(jp) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(jp), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (w.shape, w.dtype)

    seed = keys.key_data(0)
    x, y, msk = token_batch(B, S, cfg.vocab_size, seed=1, step=0)
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y),
          "mask": jnp.asarray(msk)}
    tb = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y),
          "mask": torch.from_numpy(msk)}
    mask = np.ones((1,), np.float32)

    if jax_side == "train_step":
        jstate = JState(jp, jnp.int32(0), jnp.asarray(seed))
        jnew, jm = jax.jit(m.train_step)(jstate, jb, jnp.asarray(mask))
        jnew = jnew.params
        jgrad = jax_probe(m, jl, jp, jb, seed)[3](jl.zo_eps)[1]
    else:
        jm, jnew, jgrad = jax_probe_step(m, jl, jp, jb, seed)

    state = TrainState(_clone(init), 0, seed.copy())
    new, tm = api.make_train_step(cfg, lane)(state, tb, mask)
    return dict(cfg=cfg, lane=lane, init=init, batch=tb, seed=seed,
                jax=(jm, jax.tree.map(np.asarray, jnew)),
                jax_tail_grad=jax.tree.map(np.asarray, jgrad),
                port=(tm, new.params))


def _probe_seed(seed):
    key = keys.fold_in(keys.fold_in(seed, 0), 0)
    return zo.device_seeds([prng.seed_from_key(key)], "cpu")


ELASTIC = LaneConfig()


def _unfused_losses(c):
    """(l+, l-) of elastic_zo's probe 0 from the init, unfused."""
    zo_part, bp_part = elastic.partition(c["init"], ELASTIC)
    sd, eps = _probe_seed(c["seed"]), ELASTIC.zo_eps
    with torch.no_grad():
        return [api.loss_fn(elastic.merge(zo.perturb(zo_part, sd, s), bp_part),
                            c["cfg"], c["batch"]) for s in (eps, -eps)]


def _leaves(tree):
    return dict((zo.keystr(p), t) for p, t in zo.leaves_with_path(tree))


def test_step_metrics_match_jax(case):
    jm, _ = case["jax"]
    tm, _ = case["port"]
    _close(tm["loss"], jm["loss"], LOSS_TOL, "loss")
    _close(tm["zo_g"], jm["zo_g"], G_TOL, "zo_g")


def test_step_parameters_match_jax(case):
    """Every leaf after the step, ZO head and BP part, finite and within
    PARAM_TOL of JAX's."""
    _, jparams = case["jax"]
    want = dict((jax.tree_util.keystr(p), w) for p, w in
                jax.tree_util.tree_flatten_with_path(jparams)[0])
    got = _leaves(case["port"][1])
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.isfinite(got[name]).all(), name
        _close(got[name], w, PARAM_TOL, name)


def test_tail_update_matches_jax(case):
    """Each BP leaf's change in the step (lr x its tail gradient) within
    one ulp of the new value (each package rounds it to f32) plus
    TAIL_TOL of the largest change of that leaf in JAX's step."""
    init = _leaves(case["init"])
    got = _leaves(case["port"][1])
    want = dict((jax.tree_util.keystr(p), w) for p, w in
                jax.tree_util.tree_flatten_with_path(case["jax"][1])[0])
    held = 0
    for name, w in want.items():
        if name.startswith(tuple(f"['{g}']" for g in elastic.ZO_GROUPS)) \
                or not w.size:
            continue
        base = init[name].numpy()
        dw = w - base
        dg = got[name].detach().numpy() - base
        scale = np.abs(dw).max()
        assert scale > 0, name
        excess = np.abs(dg - dw) - np.spacing(np.abs(w))
        assert excess.max() <= TAIL_TOL * scale, (name, excess.max() / scale)
        held += 1
    assert held


def test_tail_gradients_match_jax(case):
    """The gradient of the +eps probe's loss over each BP leaf, the
    port's autograd against JAX's, within GRAD_TOL of the leaf's largest
    JAX gradient: it sees the tail's backward where a leaf's change in
    the step is below an ulp of the leaf (Mamba's dt_bias, -4.6)."""
    zo_part, bp_part = elastic.partition(case["init"], ELASTIC)
    with torch.no_grad():
        head = zo.perturb(zo_part, _probe_seed(case["seed"]), ELASTIC.zo_eps)
    bp = zo.map_with_path(lambda _p, t: t.clone().requires_grad_(), bp_part)
    leaves = [(zo.keystr(p), t) for p, t in zo.leaves_with_path(bp)
              if t.numel()]
    grads = torch.autograd.grad(
        api.loss_fn(elastic.merge(head, bp), case["cfg"], case["batch"]),
        [t for _, t in leaves])
    want = dict((jax.tree_util.keystr(p), w) for p, w in
                jax.tree_util.tree_flatten_with_path(
                    case["jax_tail_grad"])[0])
    assert sorted(name for name, _ in leaves) == \
        sorted(n for n, w in want.items() if w.size)
    for (name, _), g in zip(leaves, grads):
        w = want[name]
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, (name, err)


def test_step_moves_the_head_and_the_bp_part(case):
    init, got = _leaves(case["init"]), _leaves(case["port"][1])
    moved = {"zo": False, "bp": False}
    for name, t in got.items():
        part = "zo" if any(name.startswith(f"['{g}']")
                           for g in elastic.ZO_GROUPS) else "bp"
        moved[part] |= bool(t.numel()) and not torch.equal(t, init[name])
    assert moved == {"zo": True, "bp": True}


def test_fused_pair_losses_are_the_unfused_ones(case):
    """Each family's fused elastic_zo pair (its two streams through the
    head one period's slice at a time)."""
    zo_part, bp_part = elastic.partition(case["init"], ELASTIC)
    lp, lm = api.paired_loss(bp_part, zo_part, case["cfg"], ELASTIC,
                             case["batch"], _probe_seed(case["seed"]))
    ulp, ulm = _unfused_losses(case)
    assert torch.equal(lp, ulp) and torch.equal(lm, ulm)
