"""Port parity: the training infrastructure.

The port's ``data/pipeline.py`` (batches by step, the prefetching
``Prefetcher``), ``train/optimizer.py`` (sgd, adam, the schedules) and
``train/elastic_runtime.py`` (resume from (params checkpoint, step)),
held against the JAX package on the same numpy inputs, and the twins of
``tests/test_pipeline_elastic.py`` and of ``tests/test_checkpoint.py``'s
optimizer and schedule tests. Tolerances: the batches and a restored
checkpoint bitwise; sgd bitwise (products and sums round alike); adam
within 2 ulp of the leaf's dtype after 20 updates (``b ** t`` is a
transcendental); the schedules within 1 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.elastic_runtime import (  # noqa: E402
    resume_on_mesh as jresume_on_mesh)
from repro_torch.benchmarks.bench_util import ulps as bench_ulps  # noqa: E402
from repro_torch.configs import (LaneConfig, ShapeConfig, get_arch,  # noqa: E402
                                 reduced)
from repro_torch.core import api, zo  # noqa: E402
from repro_torch.core.engine import step_memory_analysis  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher, device_put_batch,  # noqa: E402
                                       lm_batch_fn, stub_dtypes)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import tree_map  # noqa: E402
from repro_torch.obs.memory import step_footprint  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.elastic_runtime import (build_for_mesh,  # noqa: E402
                                               resume_on_mesh)

SHAPE = ShapeConfig("t", seq_len=32, global_batch=2, kind="train")
LANE = LaneConfig(lane="elastic_zo", bp_tail_layers=1)
PM = np.ones((1,), np.float32)


def _llama():
    return reduced(get_arch("llama3-8b"))


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 as int16, f32 as int32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32 if x.dtype == torch.float32
                              else x.numpy().dtype)
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def ulps(port: torch.Tensor, ref) -> int:
    """``bench_util.ulps`` of the port's tensor and a JAX array."""
    return bench_ulps(port, torch.from_numpy(np.array(_bits(ref))).view(port.dtype))


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(zo.leaves_with_path(a), zo.leaves_with_path(b)))


# ------------------------------------------------------------------ #
# twins of tests/test_pipeline_elastic.py
# ------------------------------------------------------------------ #
def test_batch_fn_pure_function_of_step():
    fn = lm_batch_fn(_llama(), SHAPE, seed=3)
    a, b = fn(17), fn(17)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["tokens"], fn(18)["tokens"])


def test_prefetcher_ordered_and_restartable():
    fn = lm_batch_fn(_llama(), SHAPE, seed=0)
    with Prefetcher(fn, start_step=5, device="cpu") as pf:
        got = [pf.get() for _ in range(3)]
    assert [s for s, _ in got] == [5, 6, 7]
    # a restarted prefetcher at step 6 replays batch 6 exactly
    with Prefetcher(fn, start_step=6, device="cpu") as pf2:
        s2, b2 = pf2.get()
    assert s2 == 6
    assert torch.equal(got[1][1]["tokens"], b2["tokens"])
    for k, v in device_put_batch(fn(7), "cpu").items():
        assert torch.equal(got[2][1][k], v)


def test_elastic_resume_roundtrip(tmp_path):
    """3 steps, checkpoint, resume through the elastic runtime, 3 more:
    every leaf bitwise an uninterrupted 6-step run's (the resumed part
    fed by the Prefetcher, the rest by device_put_batch)."""
    cfg = _llama()
    fn = lm_batch_fn(cfg, SHAPE, seed=1)

    def batch(step):
        return device_put_batch(fn(step), "cpu")

    sA, _, step = resume_on_mesh(None, cfg, SHAPE, LANE, device="cpu")
    for t in range(6):
        sA, _ = step(sA, batch(t), PM)
    sB, _, step2 = resume_on_mesh(None, cfg, SHAPE, LANE, device="cpu")
    for t in range(3):
        sB, _ = step2(sB, batch(t), PM)
    ckpt.save(tmp_path, 3, sB.params)
    sC, _, step3 = resume_on_mesh(tmp_path, cfg, SHAPE, LANE, device="cpu")
    assert sC.step == 3
    assert np.array_equal(sC.seed, sA.seed)
    with Prefetcher(fn, sC.step, "cpu") as pf:
        for t in range(3, 6):
            s, b = pf.get()
            assert s == t
            sC, _ = step3(sC, b, PM)
    assert sC.step == sA.step == 6
    assert _leaves_equal(sA.params, sC.params)


# ------------------------------------------------------------------ #
# twins of tests/test_checkpoint.py's optimizer and schedule tests
# ------------------------------------------------------------------ #
def test_optimizers_descend():
    def loss(p):
        return torch.sum(torch.square(p["w"] - 3.0))
    for o in (opt.sgd(0.1), opt.sgd(0.1, momentum=0.9),
              opt.sgd(0.1, momentum=0.9, nesterov=True), opt.adam(0.2)):
        params = {"w": torch.zeros(4)}
        state = o.init(params)
        for s in range(50):
            w = params["w"].clone().requires_grad_(True)
            g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
            upd, state = o.update(g, state, torch.tensor(s, dtype=torch.int32))
            params = opt.apply_updates(params, upd)
        assert float(loss(params)) < 0.1


def test_schedules():
    assert float(opt.step_decay(1.0, 0.8, 10)(0)) == 1.0
    assert abs(float(opt.step_decay(1.0, 0.8, 10)(25)) - 0.64) < 1e-6
    c = opt.cosine(1.0, 100, warmup=10)
    assert float(c(0)) == 0.0
    assert abs(float(c(10)) - 1.0) < 1e-6
    assert float(c(100)) < 1e-6
    assert c(torch.tensor(50)).dtype == torch.float32


# ------------------------------------------------------------------ #
# parity with the JAX package
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch,seq", [("llama3-8b", 32), ("whisper-small", 24),
                                      ("llava-next-34b", 40)])
def test_lm_batch_fn_is_the_jax_packages(arch, seq):
    """Bitwise, with frames for the encoder and img for the image
    tokens (S_tok = seq - num_image_tokens)."""
    shape = ShapeConfig("t", seq_len=seq, global_batch=3, kind="train")
    cfg = reduced(get_arch(arch))
    ours = lm_batch_fn(cfg, shape, seed=4)(9)
    ref = jpipeline.lm_batch_fn(jreduced(jget_arch(arch)),
                                JShape("t", seq_len=seq, global_batch=3,
                                       kind="train"), seed=4)(9)
    assert sorted(ours) == sorted(ref)
    assert ours["tokens"].shape == (3, seq - cfg.num_image_tokens)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k],
                                                                ref[k]), k
    dev = device_put_batch(ours, "cpu", stub_dtypes(cfg))
    for k, v in api.stub_inputs(cfg, 3, "cpu").items():
        assert dev[k].dtype == v.dtype and torch.equal(dev[k], v)


def _leaf_arrays(rng, dtype):
    shapes = {"a": {"w": (16, 8), "b": (8,)}, "c": (4, 4, 2)}
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32)
                        .astype(dtype), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


OPTS = {
    "sgd": lambda m: m.sgd(0.05),
    "momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "nesterov": lambda m: m.sgd(0.05, momentum=0.9, nesterov=True),
    "adam": lambda m: m.adam(0.01),
    "adam_cosine": lambda m: m.adam(m.cosine(0.01, 20, warmup=5)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizers_match_jax(name, dtype):
    """20 updates of random f32 or bf16 leaves, the same gradients: the
    params within 2 ulp of their dtype and the f32 optimizer state within
    2 ulp of f32 (sgd and momentum are bitwise)."""
    rng = np.random.default_rng(11)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    tdt = getattr(torch, dtype)
    p0 = _leaf_arrays(rng, np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), p0)
    jo, to = OPTS[name](jopt), OPTS[name](opt)
    js, ts = jo.init(jp), to.init(tp)
    for s in range(20):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), p0)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        tg = tree_map(lambda a: torch.from_numpy(a).to(tdt), g)
        ju, js = jo.update(jg, js, jnp.int32(s))
        tu, ts = to.update(tg, ts, s if s % 2 else torch.tensor(s))
        jp = jopt.apply_updates(jp, ju)
        tp = opt.apply_updates(tp, tu)
    bound = 2 if name.startswith("adam") else 0
    for (path, a), (_, b) in zip(zo.leaves_with_path(tp),
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert a.dtype == tdt
        assert ulps(a, np.asarray(b)) <= bound, (path, ulps(a, np.asarray(b)))
    tl = [t for _, t in zo.leaves_with_path(ts)] if isinstance(ts, dict) \
        else []
    jl = jax.tree.leaves(js)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        assert ulps(a, np.asarray(b)) <= bound


@pytest.mark.parametrize("sched", ["step_decay", "cosine", "cosine_floor",
                                   "cosine_nowarm"])
def test_schedules_match_jax(sched):
    """At step 0, the warmup's end, mid and the end, within 1 ulp."""
    make = {"step_decay": lambda m: m.step_decay(0.05, 0.8, 10),
            "cosine": lambda m: m.cosine(0.3, 100, warmup=10),
            "cosine_floor": lambda m: m.cosine(0.3, 100, warmup=7,
                                               floor=0.1),
            "cosine_nowarm": lambda m: m.cosine(1e-2, 60)}[sched]
    j, t = make(jopt), make(opt)
    for s in (0, 7, 10, 25, 55, 60, 100, 130):
        a = t(s)
        assert a.dtype == torch.float32 and a.shape == ()
        assert ulps(a, np.asarray(j(jnp.int32(s)))) <= 1, s
        assert torch.equal(t(torch.tensor(s)), a)


def test_resume_restores_a_jax_checkpoint(tmp_path):
    """A checkpoint that repro.train.checkpoint.save wrote from the JAX
    package's init restores through resume_on_mesh bitwise, at the step
    in its manifest, into the port's shape-only template."""
    jcfg = jreduced(jget_arch("llama3-8b"))
    jshape = JShape("t", seq_len=32, global_batch=2, kind="train")
    jstate, _, _ = jresume_on_mesh(None, jcfg, jshape,
                                   JLane(lane="elastic_zo", bp_tail_layers=1),
                                   mesh=None, seed=5)
    jckpt.save(tmp_path, 7, jstate.params)
    state, model, step = resume_on_mesh(tmp_path, _llama(), SHAPE, LANE,
                                        seed=5, device="cpu")
    assert state.step == 7
    assert np.array_equal(state.seed, np.asarray(jstate.seed, np.uint32))
    flat = ckpt.flatten_with_keys(state.params)
    jflat = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (k, a), (_, b) in zip(flat, jflat):
        b = np.asarray(b)
        assert a.device.type == "cpu" and tuple(a.shape) == b.shape, k
        assert np.array_equal(_bits(a), _bits(b)), k
    # the step built for the restored state runs
    state, metrics = step(state, device_put_batch(
        lm_batch_fn(_llama(), SHAPE, 1)(7), "cpu"), PM)
    assert state.step == 8 and np.isfinite(float(metrics["loss"]))
    assert model.engine.lane == LANE


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-small",
                                  "jamba-v0.1-52b"])
def test_abstract_params_are_inits_shapes(arch):
    """The restore template: init's tree, shapes and dtypes, on meta."""
    cfg = reduced(get_arch(arch))
    real = api.init(cfg, LANE, seed=0, device="cpu", max_seq=32)
    meta = api.abstract_params(cfg, LANE, max_seq=32)
    got = list(zo.leaves_with_path(meta))
    want = list(zo.leaves_with_path(real))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, m), (_, r) in zip(got, want):
        assert m.device.type == "meta" and m.shape == r.shape \
            and m.dtype == r.dtype, p


def test_restore_into_meta_template_needs_a_device(tmp_path):
    cfg = _llama()
    params = api.init(cfg, LANE, seed=0, device="cpu")
    ckpt.save(tmp_path, 2, params)
    with pytest.raises(ValueError, match="meta"):
        ckpt.restore(tmp_path, api.abstract_params(cfg, LANE))
    back, at = ckpt.restore(tmp_path, api.abstract_params(cfg, LANE),
                            device="cpu")
    assert at == 2 and _leaves_equal(back, params)


def test_a_mesh_is_not_ported(monkeypatch):
    """What of a mesh is not ported: a strategy the rules do not name
    raises on a mesh and without one. Every stack builds and resumes on
    a mesh in the tp, fsdp and serve strategies: RWKV6 and Jamba's
    Mamba, attention and MoE blocks here (a rank's view of a 2x2 mesh,
    ``torch_recurrent_ranks.RankView``, in place of the process groups),
    whose sharded init is the one-device init's shards, leaf by leaf (the
    constants it does not draw, gn_scale, conv_b, dt_bias, A_log and
    D_skip, cut to the rank's slice too); the attention-only decoder
    stacks (tests/test_torch_mesh.py, tests/test_torch_strategies.py),
    the MoE stacks (tests/test_torch_mesh_moe.py), RWKV6 and Jamba
    (tests/test_torch_mesh_rwkv.py, tests/test_torch_mesh_jamba.py),
    Whisper's encoder-decoder and LLaVA's image-token prefix
    (tests/test_torch_mesh_encdec.py) train on ranks; without a mesh
    every strategy is the one-device step."""
    import torch_recurrent_ranks
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding import collectives
    from repro_torch.sharding.params import shard_leaf
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for m in (mesh, None):
        with pytest.raises(ValueError, match="strategy 'dp'"):
            build_for_mesh(_llama(), SHAPE, LANE, mesh=m, strategy="dp")
        with pytest.raises(ValueError, match="strategy 'dp'"):
            resume_on_mesh(None, _llama(), SHAPE, LANE, mesh=m,
                           strategy="dp", device="cpu")
    for strategy in ("tp", "fsdp", "serve"):
        model, _ = build_for_mesh(_llama(), SHAPE, LANE, strategy=strategy)
        assert model.run is None
    monkeypatch.setattr(collectives, "MeshRun", torch_recurrent_ranks.RankView)
    for arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        cfg = reduced(get_arch(arch))
        whole = api.init(cfg, LANE, seed=0, device="cpu")
        for strategy in ("tp", "fsdp", "serve"):
            state, model, _ = resume_on_mesh(None, cfg, SHAPE, LANE,
                                             mesh=mesh, strategy=strategy,
                                             device="cpu")
            assert model.run.rules.strategy == strategy
            sharded = 0
            for p, t in zo.leaves_with_path(state.params):
                d = zo._at(model.run.descs, p)
                assert torch.equal(t, shard_leaf(zo._at(whole, p), d)), \
                    (arch, strategy, zo.keystr(p))
                sharded += not d.whole
            assert sharded > 0


# ------------------------------------------------------------------ #
# the Prefetcher's failure path
# ------------------------------------------------------------------ #
def test_pipeline_puts_batches_on_the_card_unless_asked(monkeypatch):
    """With no device, ``device_put_batch`` and ``Prefetcher`` go to the
    card, as every entry point of the port does: without one they raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = lm_batch_fn(_llama(), SHAPE, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_put_batch(fn(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Prefetcher(fn, 0)


def test_worker_exception_reaches_get():
    fn = lm_batch_fn(_llama(), SHAPE, seed=0)

    def flaky(step):
        if step == 2:
            raise ValueError("no batch 2")
        return fn(step)

    pf = Prefetcher(flaky, 0, "cpu")
    assert [pf.get()[0] for _ in range(2)] == [0, 1]
    for _ in range(2):                      # and again on the next call
        with pytest.raises(RuntimeError) as e:
            pf.get()
        assert isinstance(e.value.__cause__, ValueError)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_order_under_thread_switching():
    """Depth 1 and a switch interval of a microsecond: 40 batches in step
    order, each the batch function's, and the worker joined."""
    import sys
    fn = lm_batch_fn(_llama(), SHAPE, seed=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = Prefetcher(fn, 3, "cpu", depth=1)
        for t in range(3, 43):
            s, b = pf.get()
            assert s == t and np.array_equal(b["tokens"].numpy(),
                                             fn(t)["tokens"])
        pf.close()
    finally:
        sys.setswitchinterval(interval)
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        pf.get()


# ------------------------------------------------------------------ #
# the launcher: prefetched batches and --ckpt-dir through resume_on_mesh
# ------------------------------------------------------------------ #
def _argv(*extra):
    return ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--probes", "2", "--probe-drop", "0.5",
            *extra]


def test_launcher_prefetched_losses_equal_the_plain_batches():
    from repro_torch.train.train_loop import run
    t = launch_train.setup(launch_train.parse_args(_argv("--steps", "3")))
    _, plain = run(t.step_fn, t.state, t.batch_fn, t.loop, log=None)
    assert launch_train.main(_argv("--steps", "3")) == plain


def test_launcher_resumes_through_the_elastic_runtime(tmp_path):
    """2 steps with --ckpt-dir, then a run to step 4 from the checkpoint:
    the losses of 4 straight steps (probes dropped at random: the resumed
    run draws the masks of steps 2 and 3)."""
    whole = launch_train.main(_argv("--steps", "4"))
    d = str(tmp_path / "ck")
    first = launch_train.main(_argv("--steps", "2", "--ckpt-dir", d))
    assert ckpt.latest_step(d) == 2
    t = launch_train.setup(launch_train.parse_args(
        _argv("--steps", "4", "--ckpt-dir", d)))
    assert t.state.step == 2
    rest = launch_train.main(_argv("--steps", "4", "--ckpt-dir", d))
    assert first + rest == whole


# ------------------------------------------------------------------ #
# the step's memory account
# ------------------------------------------------------------------ #
def test_step_memory_analysis_is_none_on_the_cpu():
    cfg = _llama()
    state, _, step = resume_on_mesh(None, cfg, SHAPE, LANE, device="cpu")
    before = [t.clone() for t in zo.leaves(state.params)]
    batch = device_put_batch(lm_batch_fn(cfg, SHAPE, 1)(0), "cpu")
    assert step_memory_analysis(step, state, batch, PM) is None
    assert step_footprint(step, state, batch, PM, "cpu") is None
    assert all(torch.equal(a, b) for a, b in
               zip(before, zo.leaves(state.params)))
