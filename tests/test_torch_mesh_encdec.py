"""Port parity of Whisper's encoder-decoder and LLaVA's image-token prefix
trained across a mesh, on CPU ranks.

Four spawned gloo ranks (``torch_encdec_ranks.py``, one intra-op thread
each; rendezvous at a ``file://`` store under the test's temporary
directory, never a TCP port) train reduced whisper-small and
llava-next-34b in f32 from one init in every case of ``CASES``: 2
elastic_zo steps and 1 full_bp step each, in every strategy (``tp``,
``fsdp`` at a batch that dp * tp divides and at one it does not,
``serve``), under both attention plans (``tp``, with LLaVA's kv_dup 2 at
1x4; ``seq`` with 6 heads over 4 ranks, Whisper's at 16 and 18 decoder
rows over 18 frames, so the last rank holds fewer rows), and on the pod
mesh; the fused probe pair at 2x2 ``tp`` and ``fsdp``; and a ``tp``
checkpoint restored under ``fsdp``. Then rank 0 alone runs both archs on
a 1x1 mesh. The frames and image embeddings are random from a numpy
seed (the launcher's are zeros, in which a row-slicing fault would not
show). Meanwhile subprocesses with 4 forced host devices run JAX's
jitted step in every case from the same init and batches.

Tolerances: the sharded products and sums add in other orders than one
device's (and than XLA's), so steps agree within ``LM_TOL`` (as
``test_torch_strategies.py``); the full_bp step moves every leaf, the
encoder's included, so an encoder gradient summed over the wrong axes
(the cross-attention's K/V share of each `model` rank) leaves the
tolerance. The fused pair and the one-rank world are bitwise. The JAX
package's fused Whisper lane reads the +eps encoder for both streams
(ROADMAP.md queue 3), so the port's fused runs are held against JAX's
unfused step, which they equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_encdec_ranks as ranks  # noqa: E402
from repro_torch.core import api, zo  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

LM_TOL = dict(rtol=1e-3, atol=1e-4)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS, LaneConfig, ShapeConfig, reduced
    from repro.core import api
    from repro.core.elastic import TrainState
    from repro.launch.mesh import make_mesh
    from repro.sharding.params import param_shardings
    from repro.sharding.rules import ShardingRules

    out = sys.argv[1]
    cases = json.loads(sys.argv[2])
    assert jax.device_count() == 4
    meshes = {}
    for name, (arch, shape, axes, strategy, B, S, heads, enc, lane, steps,
               init_name, batch_names) in cases.items():
        cfg = reduced(ARCHS[arch], dtype="float32")
        if heads:
            cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                      num_kv_heads=heads[1])
        if enc:
            cfg = dataclasses.replace(cfg, encoder_seq=enc)
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_mesh(shape, axes)
        shp = ShapeConfig("t", seq_len=S + cfg.num_image_tokens,
                          global_batch=B, kind="train")
        rules = ShardingRules(meshes[key], cfg, shp, strategy=strategy)
        model = api.build(cfg, shp, LaneConfig(
            lane=lane, bp_tail_layers=1, zo_num_probes=1), rules)
        abstract = model.abstract_params()
        pshard = param_shardings(abstract, rules)
        init = np.load(os.path.join(out, init_name + ".npz"))
        paths, tdef = jax.tree_util.tree_flatten_with_path(abstract)
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(init[jax.tree_util.keystr(p)]) for p, _ in paths])
        params = jax.tree.map(jax.device_put, params, pshard)
        # the step and key committed (replicated) as the step returns
        # them, so the second step reuses the first one's compile
        rep = rules.ns()
        state = TrainState(params, jax.device_put(jnp.int32(0), rep),
                           jax.device_put(jax.random.key_data(
                               jax.random.key(0)), rep))
        bshard = api.batch_shardings(model.input_specs(), rules)
        step = jax.jit(model.train_step)
        losses = []
        for s in range(steps):
            z = np.load(os.path.join(out, batch_names[s] + ".npz"))
            batch = {k: jax.device_put(jnp.asarray(z[k]), bshard[k])
                     for k in z.files}
            state, met = step(state, batch, jnp.ones((1,), jnp.float32))
            losses.append(float(met["loss"]))
        flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
        np.savez(os.path.join(out, f"jax_{name}.npz"),
                 losses=np.array(losses), attn=np.array(rules.attn.kind),
                 **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    print("JAX_OK")
""")

JAX_PROCS = 3           # JAX subprocesses, each compiling part of the cases


def _jax_cases():
    """Every case in both lanes: its fields, the lane, the steps, and
    the names of its init and batches."""
    out = {}
    for name, case in ranks.CASES.items():
        for lane, steps in ranks.LANE_STEPS.items():
            out[f"{name}_{lane}"] = list(case) + [
                lane, steps, ranks.init_name(case),
                [ranks.batch_name(case, s) for s in range(steps)]]
    return out


def _save_inputs(out):
    """Each config's init (the port's, as numpy) and each case's global
    batches, which both packages read."""
    for case in ranks.CASES.values():
        name = ranks.init_name(case)
        path = os.path.join(out, name + ".npz")
        if not os.path.exists(path):
            params = api.init(ranks.cfg_of(case), ranks.lane_of("elastic_zo"),
                              seed=0, device="cpu",
                              max_seq=ranks.seq_len(case))
            np.savez(path, **{zo.keystr(p): t.numpy() for p, t in
                              zo.leaves_with_path(params)})
        for s in range(max(ranks.LANE_STEPS.values())):
            np.savez(os.path.join(out, ranks.batch_name(case, s) + ".npz"),
                     **ranks.make_batch(case, s))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case once: the JAX subprocesses (the cases dealt out among
    ``JAX_PROCS`` of them, whose compiles take most of the time) and
    the four port ranks run side by side. Returns the output
    directory."""
    out = str(tmp_path_factory.mktemp("mesh_encdec"))
    _save_inputs(out)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cases = list(_jax_cases().items())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, out,
         json.dumps(dict(cases[i::JAX_PROCS]))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(JAX_PROCS)]
    try:
        mesh_lib.spawn(ranks.encdec_rank, 4,
                       ("file://" + os.path.join(out, "store"), out))
    finally:
        done = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, done):
        assert p.returncode == 0 and "JAX_OK" in stdout, stderr[-3000:]
    return out


def _load(out, name):
    path = os.path.join(out, name + ".npz")
    arrays = dict(np.load(path)) if os.path.exists(path) else {}
    meta = os.path.join(out, name + ".json")
    return arrays, (json.load(open(meta)) if os.path.exists(meta) else {})


def _close(got, want, what):
    assert set(got) >= set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **LM_TOL)


def _one_device(out, case, lane_name):
    """The port's run on one device from the same init and batches."""
    params = ranks.load_params(
        os.path.join(out, ranks.init_name(case) + ".npz"), case)
    steps = ranks.LANE_STEPS[lane_name]
    return ranks.run_steps(
        api.make_train_step(ranks.cfg_of(case), ranks.lane_of(lane_name)),
        params, ranks.batches(out, case, steps))


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_case_matches_jax(runs, case, lane):
    """Losses of 2 elastic_zo steps, and every leaf after them (the tail's
    BP update), or after 1 full_bp step (every leaf moved, the encoder's
    and pos_embed included), within LM_TOL of JAX's step on the same
    mesh in the same strategy."""
    got, meta = _load(runs, f"{case}_{lane}")
    want = dict(np.load(os.path.join(runs, f"jax_{case}_{lane}.npz")))
    assert meta["attn"] == str(want.pop("attn"))
    np.testing.assert_allclose(meta["losses"], want.pop("losses"), **LM_TOL)
    _close(got, want, f"{case} {lane} against JAX")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_case_matches_one_device(runs, case, lane):
    """The same runs within LM_TOL of the port's one-device step, the
    replicated leaves and the copies of each shard bitwise on every rank
    (``MeshRun.check_replicas``)."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, params = _one_device(runs, ranks.CASES[case], lane)
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, {zo.keystr(p): t.numpy()
                 for p, t in zo.leaves_with_path(params)},
           f"{case} {lane} against one device")
    assert meta["replica_pairs"] > 0


PLANS = {"whisper_seq_s16": ("seq", 1), "whisper_seq_s18": ("seq", 1),
         "llava_seq": ("seq", 1), "llava_kv_dup": ("tp", 2)}
BATCH_AXES = {"whisper_fsdp_b4": ["data", "model"],
              "whisper_fsdp_b2": ["data"], "llava_fsdp": ["data", "model"],
              "whisper_pod": ["pod", "data"]}


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_rules_take_the_plan(runs, case):
    """6 heads over 4 ranks pad to 8 (33% waste): the seq plan; LLaVA's
    2 KV heads over 4 ranks: the tp plan with kv_dup 2; every other case
    the tp plan with no duplication. fsdp puts the rows over (data,
    model) where 4 rows divide 2 x 2 and over data alone at 2 rows,
    where the `model` ranks hold the same rows (and the same frames);
    the pod mesh over (pod, data)."""
    _, meta = _load(runs, f"{case}_full_bp")
    assert (meta["attn"], meta["kv_dup"]) == PLANS.get(case, ("tp", 1))
    assert meta["batch_axes"] == BATCH_AXES.get(case, ["data"])
    if case == "whisper_fsdp_b2":
        assert meta["rows"] == [0, 1]             # rank 0: (data 0, model 0)


@pytest.mark.parametrize("case", list(ranks.FUSED))
def test_fused_pair_is_bitwise_the_unfused_pair(runs, case):
    _, meta = _load(runs, case)
    assert meta["fused_pair"] == meta["unfused_pair"]


@pytest.mark.parametrize("case", list(ranks.FUSED))
def test_fused_matches_jax_unfused(runs, case):
    """The fused lane's 2 steps within LM_TOL of JAX's unfused lane on
    the same mesh (for Whisper, JAX's fused lane reads the +eps
    encoder for both streams)."""
    got, meta = _load(runs, case)
    base = ranks.FUSED[case]
    want = dict(np.load(os.path.join(runs, f"jax_{base}_elastic_zo.npz")))
    want.pop("attn")
    np.testing.assert_allclose(meta["losses"], want.pop("losses"), **LM_TOL)
    _close(got, want, f"{case} against JAX's unfused lane")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("arch", list(ranks.ONE_RANK))
def test_one_rank_world_is_one_device(runs, arch, lane):
    res = json.load(open(os.path.join(runs, "one_rank.json")))
    assert res[f"{arch}_{lane}"] == {"losses": True, "params": True}


def test_tp_checkpoint_restores_under_fsdp(runs):
    """Whisper saved at 2x2 tp, restored at 2x2 fsdp: on every rank each
    shard, the encoder's and both pos_embeds included, is bytes-equal to
    the whole leaf's slice."""
    _, meta = _load(runs, "restored_fsdp")
    for same, names, sharded, at in meta["ranks"]:
        assert same and at == 1
        assert any(n.startswith("['encoder']") for n in names)
        for leaf in ("['pos_embed']", "['encoder']['pos_embed']",
                     "['encoder']['periods']['blk0']['attn']['wq']",
                     "['periods_zo']['blk0']['cross']['wk']"):
            assert leaf in sharded


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch and the port
    only, and runs nothing when imported)."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_per_step_at_full_width():
    """The launches a rank makes a step in the card's mesh lanes
    (``chip_smoke.py::mesh_per_step``): whisper-small whole 54 / 27 /
    68 (27 ZO leaves: embed, pos_embed, the encoder's 2 + 9 stacked,
    the decoder's 14 stacked; flash 2 x (12 encoder blocks + 11 ZO
    periods x self- and cross-attention)), fused 334 / 27 / 68;
    llava-next-34b at 2 layers 20 / 10 / 2; qwen3-4b at 4 layers 24 /
    12 / 6, fused 68 / 12 / 6, as its earlier lanes asserted them."""
    import dataclasses
    from repro_torch.configs import ARCHS
    cs = _chip_smoke()
    llava = dataclasses.replace(ARCHS[ranks.LLAVA], num_layers=2)
    qwen = dataclasses.replace(ARCHS["qwen3-4b"], num_layers=4)
    got = [tuple(cs.mesh_per_step(c, f).values()) for c, f in (
        (ARCHS[ranks.WHISPER], False), (ARCHS[ranks.WHISPER], True),
        (llava, False), (qwen, False), (qwen, True))]
    assert got == [(54, 27, 68), (334, 27, 68), (20, 10, 2), (24, 12, 6),
                   (68, 12, 6)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["whisper_tp", "whisper_seq_s18", "llava_tp"])
def test_mesh_per_step_counts_a_step(case, fused, monkeypatch):
    """``mesh_per_step`` of a reduced config is what one elastic_zo step
    calls of each kernel's entry point in ``kernels.ops`` on one device
    (the CPU runs the plain versions; a mesh rank makes the same calls
    under the tp plan, every strategy)."""
    from repro_torch.kernels import ops
    cs = _chip_smoke()
    counts = {}
    for name in ("zo_perturb", "zo_fused_replay", "flash_attention"):
        def count(*a, _f=getattr(ops, name), _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, name, count)
    c = ranks.CASES[case]
    cfg = ranks.cfg_of(c)
    lane = ranks.lane_of("elastic_zo", fused=fused)
    params = api.init(cfg, lane, seed=0, device="cpu",
                      max_seq=ranks.seq_len(c))
    batch = {k: torch.from_numpy(v) for k, v in ranks.make_batch(c, 0).items()}
    ranks.run_steps(api.make_train_step(cfg, lane), params, [batch])
    assert counts == cs.mesh_per_step(cfg, fused)
