"""Port parity of ElasticZO training across a mesh, on CPU ranks.

Four spawned gloo ranks (``torch_mesh_ranks.py``, one intra-op thread
each; rendezvous at a ``file://`` store under the test's temporary
directory, never a TCP port) train reduced qwen3-4b in f32 from one init
on 2x2 and 1x4 meshes in the ``tp`` strategy, save a checkpoint at 2x2
and restore it on 1x4, 4x1 and one device, resume at 1x4, and run
``compressed_psum``. Meanwhile one subprocess with 4 forced host devices
runs JAX's 2x2 step from the same init, and JAX's ``shard_map``
``compressed_psum``. Tolerances: the sharded products and the
vocab-parallel loss sum in other orders than one device's (and than
XLA's), so steps agree within ``LM_TOL`` (as ``test_torch_train.py``);
the noise, the checkpoints, the quantised payloads and the coefficients
across ranks are bitwise (the engine asserts the coefficients every
step).
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

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.core import api, keys, zo  # noqa: E402
from repro_torch.core.elastic import TrainState  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

LM_TOL = dict(rtol=1e-3, atol=1e-4)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import ARCHS, LaneConfig, ShapeConfig, reduced
    from repro.core import api
    from repro.core.elastic import TrainState
    from repro.data.synthetic import token_batch
    from repro.launch.mesh import make_mesh
    from repro.sharding.params import param_shardings
    from repro.sharding.rules import ShardingRules
    from repro.train.compress import compressed_psum

    out = sys.argv[1]
    assert jax.device_count() == 4
    cfg = reduced(ARCHS["qwen3-4b"], dtype="float32")
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = ShardingRules(mesh, cfg, shape)
    init = np.load(os.path.join(out, "init.npz"))
    for lane in ("elastic_zo", "full_bp"):
        model = api.build(cfg, shape, LaneConfig(lane=lane, bp_tail_layers=1,
                                                 zo_num_probes=1), rules)
        abstract = model.abstract_params()
        pshard = param_shardings(abstract, rules)
        paths, tdef = jax.tree_util.tree_flatten_with_path(abstract)
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(init[jax.tree_util.keystr(p)]) for p, _ in paths])
        params = jax.tree.map(jax.device_put, params, pshard)
        state = TrainState(params, jnp.int32(0),
                           jax.random.key_data(jax.random.key(0)))
        bshard = api.batch_shardings(model.input_specs(), rules)
        step = jax.jit(model.train_step)
        losses = []
        for s in range(2):
            x, y, m = token_batch(2, 16, cfg.vocab_size, seed=1, step=s)
            batch = {k: jax.device_put(jnp.asarray(v), bshard[k])
                     for k, v in (("tokens", x), ("labels", y), ("mask", m))}
            state, met = step(state, batch, jnp.ones((1,), jnp.float32))
            losses.append(float(met["loss"]))
        flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
        np.savez(os.path.join(out, f"jax_{lane}.npz"), losses=np.array(losses),
                 **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})

    g = np.load(os.path.join(out, "psum_in.npy"))
    dmesh = Mesh(np.array(jax.devices()), ("d",))

    def f(gs, rs):
        x = gs[0] + rs[0]
        scale = jax.lax.pmax(jnp.maximum(jnp.max(jnp.abs(x), initial=0.0),
                                         1e-30), "d") / 127.0
        q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
        avg, new_r = compressed_psum({"w": gs[0]}, {"w": rs[0]}, "d")
        return q[None], scale[None], avg["w"][None], new_r["w"][None]

    q, scale, avg, new_r = jax.jit(shard_map(
        f, mesh=dmesh, in_specs=(P("d"), P("d")),
        out_specs=(P("d"), P("d"), P("d"), P("d"))))(
            jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    np.savez(os.path.join(out, "jax_psum.npz"), q=np.asarray(q),
             scale=np.asarray(scale), avg=np.asarray(avg),
             new_r=np.asarray(new_r))
    print("JAX_OK")
""")


def _init(out):
    """The port's init of reduced qwen3-4b (f32, seed 0), saved by keystr
    for both sides; and compressed_psum's input rows of four magnitudes."""
    params = api.init(ranks._cfg(), ranks._lane("elastic_zo"), seed=0,
                      device="cpu", max_seq=ranks.SEQ)
    np.savez(os.path.join(out, "init.npz"),
             **{zo.keystr(p): t.numpy() for p, t in
                zo.leaves_with_path(params)})
    rng = np.random.default_rng(0)
    np.save(os.path.join(out, "psum_in.npy"),
            np.concatenate([rng.normal(size=(1, 64)) * 10.0 ** k
                            for k in range(4)]).astype(np.float32))
    return params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded case once: the JAX subprocess and the four port
    ranks run side by side. Returns the output directory."""
    out = str(tmp_path_factory.mktemp("mesh"))
    _init(out)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, out],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        mesh_lib.spawn(ranks.mesh_rank, 4,
                       ("file://" + os.path.join(out, "store"), out))
    finally:
        stdout, stderr = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0 and "JAX_OK" in stdout, stderr[-3000:]
    return out


def _load(out, name):
    arrays = dict(np.load(os.path.join(out, name + ".npz")))
    meta = os.path.join(out, name + ".json")
    return arrays, (json.load(open(meta)) if os.path.exists(meta) else {})


def _unsharded(out, lane, steps=ranks.STEPS):
    """The port's run on one device from the same init."""
    params = ranks.load_params(os.path.join(out, "init.npz"))
    step = api.make_train_step(ranks._cfg(), ranks._lane(lane))
    state = TrainState(params, 0, keys.key_data(0))
    from repro_torch.data.pipeline import lm_batch_fn
    fn = lm_batch_fn(ranks._cfg(), ranks._shape(), seed=1)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in fn(s).items()}
        state, m = step(state, batch, np.ones(1, np.float32))
        losses.append(float(m["loss"]))
    return losses, {zo.keystr(p): t.numpy()
                    for p, t in zo.leaves_with_path(state.params)}


def _close(got, want, what):
    assert set(got) >= set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **LM_TOL)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("lane", ranks.LANES)
def test_sharded_step_matches_jax_2x2(runs, lane, mesh):
    got, meta = _load(runs, f"{lane}_{mesh}")
    want = dict(np.load(os.path.join(runs, f"jax_{lane}.npz")))
    np.testing.assert_allclose(meta["losses"], want.pop("losses"), **LM_TOL)
    _close(got, want, f"{lane} {mesh} against JAX 2x2")


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("lane", ranks.LANES)
def test_sharded_step_matches_unsharded(runs, lane, mesh):
    got, meta = _load(runs, f"{lane}_{mesh}")
    losses, params = _unsharded(runs, lane)
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, params, f"{lane} {mesh} against one device")
    # replicated leaves and copies of shards bitwise on every rank
    assert meta["replica_pairs"] > 0
    assert meta["kv_dup"] == (2 if mesh == "1x4" else 1)


@pytest.mark.parametrize("mesh", ["1x4", "4x1"])
def test_checkpoint_restores_bitwise_on_other_meshes(runs, mesh):
    got, meta = _load(runs, f"restored_{mesh}")
    assert meta["step"] == 1
    template = api.abstract_params(ranks._cfg(), ranks._lane("elastic_zo"),
                                   max_seq=ranks.SEQ)
    whole, at = ckpt.restore(os.path.join(runs, "ckpt"), template,
                             device="cpu")
    assert at == 1
    for p, t in zo.leaves_with_path(whole):
        assert np.array_equal(got[zo.keystr(p)], t.numpy()), p


def test_checkpoint_restores_on_one_device_as_jax_reads_it(runs):
    """The 2x2 save wrote today's file format: one global array a leaf,
    which one device (mesh=None) restores bitwise equal to the ranks'
    gathered leaves."""
    template = api.abstract_params(ranks._cfg(), ranks._lane("elastic_zo"),
                                   max_seq=ranks.SEQ)
    whole, at = ckpt.restore(os.path.join(runs, "ckpt"), template,
                             device="cpu")
    got, _ = _load(runs, "restored_1x4")
    manifest = json.load(open(os.path.join(runs, "ckpt", "step_00000001",
                                           "manifest.json")))
    assert manifest["keys"] == [k for k, _ in ckpt.flatten_with_keys(whole)]
    for p, t in zo.leaves_with_path(whole):
        assert tuple(t.shape) == tuple(got[zo.keystr(p)].shape)
        assert np.array_equal(t.numpy(), got[zo.keystr(p)])


def test_resume_on_mesh_continues_as_uninterrupted(runs):
    """Saved at 2x2 after step 1, resumed on 1x4 for step 2: the 2x2
    run of 2 straight steps within LM_TOL."""
    got, meta = _load(runs, "resumed_1x4")
    want, want_meta = _load(runs, "elastic_zo_2x2")
    assert meta["step"] == 2
    np.testing.assert_allclose(meta["losses"], want_meta["losses"][1:],
                               **LM_TOL)
    _close(got, want, "resumed 1x4 against straight 2x2")


def test_compressed_psum_matches_jax_shard_map(runs):
    """q and the shared scale bitwise, the average within 1e-6; the
    residual x - q * scale within one rounding of q * scale (XLA on the
    CPU contracts it into a fused multiply-add, the port rounds the
    product first)."""
    want = dict(np.load(os.path.join(runs, "jax_psum.npz")))
    for r in range(4):
        got = dict(np.load(os.path.join(runs, f"psum_{r}.npz")))
        assert np.array_equal(got["q"], want["q"][r]), r
        scale = got["scale"].reshape(())
        assert np.array_equal(scale, want["scale"][r].reshape(())), r
        np.testing.assert_allclose(got["avg"], want["avg"][r], rtol=0,
                                   atol=1e-6)
        step = np.spacing(np.abs(got["q"].astype(np.float32) * scale))
        assert np.all(np.abs(got["new_r"] - want["new_r"][r]) <= step), r


def test_launcher_mesh_matches_unsharded(tmp_path):
    """``launch/train.py --mesh 2x2:data,model --dist-backend gloo
    --device cpu --smoke`` spawns its 4 ranks and exits; its losses
    within LM_TOL of the run without ``--mesh``."""
    argv = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps",
            "3"]
    plain = launch_train.main(argv)
    meshed = launch_train.main(argv + [
        "--mesh", "2x2:data,model", "--dist-backend", "gloo",
        "--dist-init", "file://" + str(tmp_path / "store")])
    assert [s for s, _ in meshed] == [s for s, _ in plain] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in meshed],
                               [v for _, v in plain], **LM_TOL)
