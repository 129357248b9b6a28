"""Port parity: Whisper's encoder-decoder and LLaVA's image-token prefix.

Reduced f32 whisper-small (two encoder and two decoder layers over 16
frames, learned positions) and llava-next-34b (two layers behind 8 image
tokens, GQA) in both packages, the port's weights carried across from
JAX's init with ``convert.params_from_jax``. The frames and image
embeddings are random from a numpy seed, so the encoder and the image
prefix do real work (the engines feed zeros, as the JAX engine does).

Against JAX: prefill logits within 1e-4 and the prefill caches (self-
and cross-attention K/V) within ``LM_TOL``; the port's ``Engine`` gives
the JAX ``Engine``'s streams, greedy and sampled, with more requests than
slots; one elastic_zo probe's (l+, l-), the step's metrics and the +eps
probe's tail gradients (JAX's side put together from its parts, as
``tests/test_torch_train_families.py``'s ``jax_probe_step``), and
full_bp's loss and gradients over every leaf, the encoder's included.
Gradients are held within GRAD_TOL of each leaf's largest.

Within the port: the paged engine's greedy streams equal
``dense_generate``'s; the fused probe pair's losses are bitwise the
unfused ones. The JAX package's fused lane runs both streams' BP tail
over the +eps encoder's output (``repro/core/api.py`` ``paired_loss``),
so its fused losses differ from its own unfused ones; the port keeps
each stream's own encoder output, and one test shows the difference.
And the serving repairs of this slice: ``grow_dense_caches`` leaves the
cross-attention K/V alone, bucketing caps a LLaVA prompt at
``max_seq_len`` less its image tokens, and ``submit`` counts them.
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
from repro.configs import ServeConfig as JServe  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import elastic as jelastic  # noqa: E402
from repro.core import zo as jzo  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import LaneConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import api, elastic, keys, prng, zo  # noqa: E402
from repro_torch.core.elastic import TrainState  # noqa: E402
from repro_torch.data.synthetic import token_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import make_caches  # noqa: E402
from repro_torch.serve import (Engine, SamplingParams, ServeConfig,  # noqa: E402
                               dense_generate, grow_dense_caches)

ARCHS = ("whisper-small", "llava-next-34b")
B, S = 2, 12                     # batch rows, text tokens
LOGIT_TOL = 1e-4
LM_TOL = dict(rtol=1e-3, atol=1e-4)
G_TOL = 5e-3                     # zo_g: 1 / 2 eps = 500 amplifies rounding
GRAD_TOL = 1e-4
_jax_perturb = jax.jit(jzo.perturb)


def _configs(arch):
    return (jreduced(JARCHS[arch], dtype="float32"),
            configs.reduced(configs.ARCHS[arch], dtype="float32"))


def _model(arch, seq_len, kind, lane=None):
    """(JAX BuiltModel, its init as JAX arrays, the port's copy, the
    port's config); ``seq_len`` counts the image tokens and sizes a
    learned ``pos_embed``."""
    jcfg, cfg = _configs(arch)
    shape = ShapeConfig("t", seq_len=seq_len, global_batch=B, kind=kind)
    m = japi.build(jcfg, shape, lane or JLane(),
                   ShardingRules(None, jcfg, shape))
    jp = jax.jit(m.init)(jax.random.key(0))
    return m, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), cfg


def _stub_inputs(cfg, rows, seed=11):
    """Random frames / image embeddings (numpy), as the config takes."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        out["img"] = rng.standard_normal(
            (rows, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _both(arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _keyed(tree):
    return dict((jax.tree_util.keystr(p), np.asarray(w)) for p, w in
                jax.tree_util.tree_flatten_with_path(tree)[0])


class _Count:
    def __init__(self, monkeypatch):
        self.flash = self.chunked = 0
        flash, chunked = ops.flash_attention, layers._chunked_self_attention

        def f(*a, **k):
            self.flash += 1
            return flash(*a, **k)

        def c(*a, **k):
            self.chunked += 1
            return chunked(*a, **k)
        monkeypatch.setattr(ops, "flash_attention", f)
        monkeypatch.setattr(layers, "_chunked_self_attention", c)


# ------------------------------------------------------------------ #
# parameters and prefill
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carry_the_new_subtrees(arch):
    """The port's init has JAX's tree, shapes and dtypes (pos_embed with
    the model's max_seq rows, the encoder, ln_cross / cross), and
    ``params_from_jax`` carries every leaf across exactly."""
    jcfg, cfg = _configs(arch)
    m, jp, tp, _ = _model(arch, 24, "prefill")
    own = api.init(cfg, seed=0, device="cpu", max_seq=24)
    want, got, conv = _keyed(jp), _keyed(jax.tree.map(
        lambda t: t.numpy(), own)), _keyed(jax.tree.map(lambda t: t.numpy(),
                                                        tp))
    assert sorted(got) == sorted(want) == sorted(conv)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype
        assert np.array_equal(conv[name], w), name
    names = " ".join(want)
    new = (("['pos_embed']", "['encoder']['periods']['blk0']['attn']['wq']",
            "['ln_cross']", "['cross']['wk']") if cfg.encoder_layers else ())
    assert all(n in names for n in new)
    assert ("pos_embed" in names) == (cfg.rope_theta <= 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch, monkeypatch):
    n_img = _configs(arch)[1].num_image_tokens
    m, jp, tp, cfg = _model(arch, S + n_img, "prefill")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    last = np.array([n_img + S - 1, n_img + 6], np.int32)
    jx, tx = _both(_stub_inputs(cfg, B))
    jl, jd = jax.jit(m.prefill_logits)(jp, {"tokens": jnp.asarray(toks),
                                            **jx}, jnp.asarray(last))
    count = _Count(monkeypatch)
    tl, td = api.prefill_logits(tp, cfg, torch.from_numpy(toks),
                                torch.from_numpy(last), **tx)
    # every attention is gradient-free: the encoder's, each decoder
    # block's self- and cross-attention, all through the flash path
    want = cfg.encoder_layers + cfg.num_layers * (2 if cfg.encoder_layers
                                                  else 1)
    assert (count.flash, count.chunked) == (want, 0)
    err = np.abs(tl.numpy() - np.asarray(jl)).max()
    assert err <= LOGIT_TOL, err
    names = ("k", "v", "ck", "cv") if cfg.encoder_layers else ("k", "v")
    for half in ("zo", "bp"):
        for entry, jentry in zip(td[half], jd[half]):
            assert sorted(entry) == sorted(jentry) == sorted(names)
            for name in names:
                np.testing.assert_allclose(entry[name].numpy(),
                                           np.asarray(jentry[name]), **LM_TOL)


# ------------------------------------------------------------------ #
# serving: against the JAX Engine, and paged against dense
# ------------------------------------------------------------------ #
KNOBS = [dict(), dict(temperature=0.8, top_k=7, seed=11),
         dict(temperature=1.1, top_p=0.9, seed=23), dict(temperature=0.9,
                                                         seed=3)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, monkeypatch):
    """4 requests over 3 slots (the fourth is admitted when a slot
    frees, and its cross-attention K/V overwrite the slot's), greedy and
    sampled; every prompt has one length, so JAX compiles few prefills."""
    kw = dict(page_size=4, num_pages=32, max_batch_slots=3, max_seq_len=32,
              max_new_tokens=6, megastep=1)
    jcfg, _ = _configs(arch)
    m, jp, tp, cfg = _model(arch, kw["max_seq_len"], "prefill")
    jeng = JEngine(jcfg, JServe(**kw), params=jp)
    teng = Engine(cfg, ServeConfig(**kw), params=tp, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, 5)) for _ in KNOBS]
    jr = [jeng.submit(p, JSP(**k), 6) for p, k in zip(prompts, KNOBS)]
    tr = [teng.submit(p, SamplingParams(**k), 6)
          for p, k in zip(prompts, KNOBS)]
    jout, tout = jeng.run(), teng.run()
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    assert teng.sched.pool.used_pages == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matches_dense(arch):
    """The paged engine's greedy streams equal the dense baseline's: the
    image tokens count in the paged cache (``submit``'s prefix_extra) and
    in the dense one (``DenseServer.total``), and Whisper's decode reads
    its cross-attention K/V from each slot and from each dense row."""
    cfg = configs.reduced(configs.ARCHS[arch])
    serve = ServeConfig(page_size=8, num_pages=64, max_batch_slots=3,
                        max_seq_len=64, max_new_tokens=6)
    eng = Engine(cfg, serve, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 10))
    paged = eng.generate([list(p) for p in prompts], SamplingParams(), 6)
    dense = dense_generate(cfg, eng.params, prompts, 6)
    assert [list(d) for d in dense] == paged
    eng.sched.check_invariants()
    assert eng.sched.pool.used_pages == 0


def test_grow_dense_caches_leaves_cross_kv_alone():
    """Only the self-attention k / v grow; Whisper's ck / cv keep their
    encoder_seq (16) rows when ``total`` (30) passes it."""
    cfg = configs.reduced(configs.ARCHS["whisper-small"], dtype="float32")
    params = api.init(cfg, seed=1, device="cpu", max_seq=30)
    Lp, total = 12, 30
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, Lp)))
    frames = torch.from_numpy(_stub_inputs(cfg, B)["frames"])
    _, caches = api.prefill_step(params, cfg, toks, frames=frames)
    grown = grow_dense_caches(caches, cfg, total)
    want = api.split_caches(make_caches(cfg, B, total, device="cpu"), cfg,
                            LaneConfig())
    for part in ("zo", "bp"):
        assert api.tree_map(lambda a: a.shape, grown[part]) == \
            api.tree_map(lambda a: a.shape, want[part])
        for old, new in zip(caches[part], grown[part]):
            assert new["ck"] is old["ck"] and new["cv"] is old["cv"]
            assert old["ck"].shape[2] == cfg.encoder_seq
            assert new["k"].shape[2] == total
            assert torch.equal(new["k"][:, :, :Lp], old["k"])


def test_prefill_bucket_leaves_room_for_the_image_tokens(monkeypatch):
    """A 17-token LLaVA prompt buckets to 32 text tokens, which with its
    8 image tokens would pass max_seq_len 32: the bucket is capped at 24,
    and the streams still equal the dense baseline's."""
    cfg = configs.reduced(configs.ARCHS["llava-next-34b"], dtype="float32")
    serve = ServeConfig(page_size=4, num_pages=64, max_batch_slots=2,
                        max_seq_len=32, max_new_tokens=3,
                        bucket_prompts=True)
    eng = Engine(cfg, serve, device="cpu")
    widths = []
    prefill = api.prefill_logits
    monkeypatch.setattr(api, "prefill_logits", lambda p, c, toks, *a, **k: (
        widths.append(toks.shape[1]) or prefill(p, c, toks, *a, **k)))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 17))
    out = eng.generate([list(prompt[0])], SamplingParams(), 3)
    assert widths == [serve.max_seq_len - cfg.num_image_tokens]
    assert out == [list(t) for t in dense_generate(cfg, eng.params, prompt,
                                                   3)]


def test_submit_counts_the_image_tokens():
    cfg = configs.reduced(configs.ARCHS["llava-next-34b"], dtype="float32")
    eng = Engine(cfg, ServeConfig(page_size=4, num_pages=64,
                                  max_batch_slots=2, max_seq_len=32),
                 device="cpu")
    eng.submit(list(range(20)), SamplingParams(), 4)       # 8 + 20 + 4
    assert eng.sched.waiting[0].req.prefix_extra == cfg.num_image_tokens
    with pytest.raises(ValueError, match="cache tokens"):
        eng.submit(list(range(21)), SamplingParams(), 4)   # 8 + 21 + 4


# ------------------------------------------------------------------ #
# training
# ------------------------------------------------------------------ #
def _probe_key(seed):
    return jax.random.fold_in(jax.random.fold_in(
        jax.random.wrap_key_data(jnp.asarray(seed)), 0), 0)


def _probe_seed(seed):
    key = keys.fold_in(keys.fold_in(seed, 0), 0)
    return zo.device_seeds([prng.seed_from_key(key)], "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def train_case(request):
    """One elastic_zo probe in both packages from JAX's init; JAX's side
    from its parts: the jitted perturbation, and the jitted loss and
    tail gradient at theta +/- eps z."""
    arch = request.param
    jl = JLane(lane="elastic_zo")
    lane = LaneConfig(**dataclasses.asdict(jl))
    jcfg, cfg = _configs(arch)
    m, jp, tp, cfg = _model(arch, S + cfg.num_image_tokens, "train", jl)
    x, y, msk = token_batch(B, S, cfg.vocab_size, seed=1, step=0)
    jx, tx = _both({"tokens": x, "labels": y, "mask": msk,
                    **_stub_inputs(cfg, B)})
    seed = keys.key_data(0)
    key = _probe_key(seed)
    zo_part, bp_part = jelastic.partition(jp, jl)
    value_grad = jax.jit(jax.value_and_grad(
        lambda bp, zp: m.loss_fn(jelastic.merge(zp, bp), jx)))
    (lp, gp), (lm, gm) = (value_grad(bp_part, _jax_perturb(
        zo_part, key, jnp.float32(s))) for s in (jl.zo_eps, -jl.zo_eps))
    g = jzo.projected_gradient(lp, lm, jl.zo_eps, jl.zo_clip)
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, lane=lane, jlane=jl, m=m,
                jparams=jp, params=tp, jbatch=jx, batch=tx, seed=seed,
                key=key, jax_losses=(float(lp), float(lm)),
                jax_metrics={"loss": 0.5 * (lp + lm), "zo_g": jnp.abs(g)},
                jax_tail_grad=_keyed(gp))


def _unfused_losses(c):
    zo_part, bp_part = elastic.partition(c["params"], c["lane"])
    sd, eps = _probe_seed(c["seed"]), c["lane"].zo_eps
    with torch.no_grad():
        return [api.loss_fn(elastic.merge(zo.perturb(zo_part, sd, s),
                                          bp_part), c["cfg"], c["batch"])
                for s in (eps, -eps)]


def test_probe_losses_and_step_metrics_match_jax(train_case):
    c = train_case
    got = [float(v) for v in _unfused_losses(c)]
    np.testing.assert_allclose(got, c["jax_losses"], **LM_TOL)
    step = api.make_train_step(c["cfg"], c["lane"])
    params = zo.map_with_path(lambda _p, t: t.clone(), c["params"])
    new, metrics = step(TrainState(params, 0, c["seed"].copy()), c["batch"],
                        np.ones((1,), np.float32))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(c["jax_metrics"]["loss"]), **LM_TOL)
    want_g = float(c["jax_metrics"]["zo_g"])
    assert abs(float(metrics["zo_g"]) - want_g) <= G_TOL * max(1.0, want_g)
    moved = {part: any(not torch.equal(t, dict(zo.leaves_with_path(
        c["params"]))[p]) for p, t in zo.leaves_with_path(new.params)
        if (p[0] in elastic.ZO_GROUPS) == (part == "zo"))
        for part in ("zo", "bp")}
    assert moved == {"zo": True, "bp": True}


def test_tail_gradients_match_jax(train_case):
    """The +eps probe's gradient over each BP leaf (the tail's
    cross-attention over the encoder output included) within GRAD_TOL of
    the leaf's largest in JAX."""
    c = train_case
    zo_part, bp_part = elastic.partition(c["params"], c["lane"])
    with torch.no_grad():
        head = zo.perturb(zo_part, _probe_seed(c["seed"]), c["lane"].zo_eps)
    bp = zo.map_with_path(lambda _p, t: t.clone().requires_grad_(), bp_part)
    leaves = [(zo.keystr(p), t) for p, t in zo.leaves_with_path(bp)]
    grads = torch.autograd.grad(
        api.loss_fn(elastic.merge(head, bp), c["cfg"], c["batch"]),
        [t for _, t in leaves])
    want = c["jax_tail_grad"]
    assert sorted(n for n, _ in leaves) == sorted(want)
    if c["cfg"].encoder_layers:
        assert "['periods_bp']['blk0']['cross']['wk']" in want
    for (name, _), g in zip(leaves, grads):
        err = np.abs(g.numpy() - want[name]).max() / np.abs(want[name]).max()
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_bp_loss_and_gradients_match_jax(arch):
    """full_bp differentiates everything: Whisper's encoder through the
    non-causal chunked attention, and its cross-attention's K/V."""
    jl = JLane(lane="full_bp")
    jcfg, cfg = _configs(arch)
    m, jp, tp, cfg = _model(arch, S + cfg.num_image_tokens, "train", jl)
    x, y, msk = token_batch(B, S, cfg.vocab_size, seed=2, step=0)
    jx, tx = _both({"tokens": x, "labels": y, "mask": msk,
                    **_stub_inputs(cfg, B, seed=4)})
    jloss, jgrad = jax.jit(jax.value_and_grad(m.loss_fn))(jp, jx)
    params = zo.map_with_path(lambda _p, t: t.clone().requires_grad_(), tp)
    leaves = [(zo.keystr(p), t) for p, t in zo.leaves_with_path(params)
              if t.numel()]
    loss = api.loss_fn(params, cfg, tx)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LM_TOL)
    want = _keyed(jgrad)
    held = 0
    for (name, _), g in zip(leaves, grads):
        scale = np.abs(want[name]).max()
        if scale == 0:                        # embedding rows no token uses
            assert not g.any(), name
            continue
        err = np.abs(g.numpy() - want[name]).max() / scale
        assert err <= GRAD_TOL, (name, err)
        held += name.startswith("['encoder']")
    assert held == (11 if cfg.encoder_layers else 0)  # every encoder leaf


def test_fused_pair_losses_are_the_unfused_ones(train_case):
    c = train_case
    zo_part, bp_part = elastic.partition(c["params"], c["lane"])
    lp, lm = api.paired_loss(bp_part, zo_part, c["cfg"], c["lane"],
                             c["batch"], _probe_seed(c["seed"]))
    ulp, ulm = _unfused_losses(c)
    assert torch.equal(lp, ulp) and torch.equal(lm, ulm)


@pytest.mark.parametrize("train_case", ["whisper-small"], indirect=True)
def test_jax_fused_whisper_pair_reads_the_plus_encoder(train_case,
                                                       monkeypatch):
    """JAX's fused lane gives both streams' BP tail the +eps encoder's
    output (``repro/core/api.py`` ``paired_loss``): its l+ is its
    unfused l+, its l- is not its unfused l-, and so its projected
    gradient misses the unfused one. The port's fused pair is JAX's
    unfused pair."""
    c = train_case
    captured = {}
    make = jelastic.make_elastic_step

    def spy(loss_fn, lane, partition_fn=None, paired_loss_fn=None):
        captured["paired"] = paired_loss_fn
        return make(loss_fn, lane, partition_fn, paired_loss_fn)
    monkeypatch.setattr(jelastic, "make_elastic_step", spy)
    jl = dataclasses.replace(c["jlane"], fused_probes=True)
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    japi.build(c["jcfg"], shape, jl, ShardingRules(None, c["jcfg"], shape))
    zo_part, bp_part = jelastic.partition(c["jparams"], jl)
    jfp, jfm = (float(v) for v in jax.jit(captured["paired"])(
        bp_part, zo_part, c["jbatch"], c["key"]))
    up, um = c["jax_losses"]
    eps = jl.zo_eps
    np.testing.assert_allclose(jfp, up, **LM_TOL)
    g_fused, g_unfused = (jfp - jfm) / (2 * eps), (up - um) / (2 * eps)
    assert abs(g_fused - g_unfused) > 10 * G_TOL * max(1.0, abs(g_unfused))
    tzo, tbp = elastic.partition(c["params"], c["lane"])
    tp, tm = (float(v) for v in api.paired_loss(
        tbp, tzo, c["cfg"], c["lane"], c["batch"], _probe_seed(c["seed"])))
    np.testing.assert_allclose([tp, tm], [up, um], **LM_TOL)
    assert abs((tp - tm) / (2 * eps) - g_unfused) <= G_TOL * max(
        1.0, abs(g_unfused))


# ------------------------------------------------------------------ #
# the launchers
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--paged", "--batch", "3", "--slots", "2",
                       "--prompt-len", "5", "--tokens", "3",
                       "--page-size", "4"])
    for lane in ("elastic_zo", "full_zo", "full_bp"):
        hist = launch_train.main(["--arch", arch, "--smoke", "--device",
                                  "cpu", "--steps", "2", "--seq", "24",
                                  "--lane", lane])
        assert len(hist) == 2 and all(np.isfinite(float(loss))
                                      for _, loss in hist)
    out = capsys.readouterr().out
    assert "[serve] paged: 9 tokens across 3 requests" in out
    assert out.count("[train] done at step 2") == 3
