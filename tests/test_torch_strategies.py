"""Port parity of the ``fsdp`` and ``serve`` strategies, the ``seq``
attention plan, the `pod` axis and fused probes across a mesh, on CPU
ranks.

Four spawned gloo ranks (``torch_strategy_ranks.py``, one intra-op
thread each; rendezvous at a ``file://`` store under the test's
temporary directory, never a TCP port) train reduced qwen3-4b in f32 (6
Q heads over 2 KV heads for the seq plan, which 4 ranks then take) from
one init in every case of ``CASES``: 2 elastic_zo steps and 1 full_bp
step each, the fused probe pair at 2x2 ``tp`` and ``fsdp``, the
launcher's path on the pod mesh, and a ``tp`` checkpoint restored under
the other strategies; then rank 0 alone runs ``fsdp`` on a 1x1 mesh.
Meanwhile two subprocesses with 4 forced host devices each run JAX's
step in every case from the same init (its compiles take most of the
time; two halve it). Tolerances: the sharded products and
sums add in other orders than one device's (and than XLA's), so steps
agree within ``LM_TOL`` (as ``test_torch_train.py``); the full_bp step
moves every leaf, so a gradient summed over the wrong axes (a tail
gradient tp times too large) leaves the tolerance. The fused pair and
the one-rank world are bitwise.
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

import torch_strategy_ranks as ranks  # noqa: E402
from repro_torch.core import api, keys, zo  # noqa: E402
from repro_torch.core.elastic import TrainState  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.elastic_runtime import (STRATEGIES,  # noqa: E402
                                               build_for_mesh)

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
    from repro.data.synthetic import token_batch
    from repro.launch.mesh import make_mesh
    from repro.sharding.params import param_shardings
    from repro.sharding.rules import ShardingRules

    out = sys.argv[1]
    cases = json.loads(sys.argv[2])
    assert jax.device_count() == 4
    meshes = {}
    for name, (shape, axes, strategy, B, S, heads, lane, steps,
               fused) in cases.items():
        cfg = reduced(ARCHS["qwen3-4b"], dtype="float32")
        if heads:
            cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                      num_kv_heads=heads[1])
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_mesh(shape, axes)
        shp = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
        rules = ShardingRules(meshes[key], cfg, shp, strategy=strategy)
        model = api.build(cfg, shp, LaneConfig(
            lane=lane, bp_tail_layers=1, zo_num_probes=1,
            fused_probes=fused), rules)
        abstract = model.abstract_params()
        pshard = param_shardings(abstract, rules)
        init = np.load(os.path.join(
            out, "init.npz" if not heads else
            f"init_h{heads[0]}_{heads[1]}.npz"))
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
            x, y, m = token_batch(B, S, cfg.vocab_size, seed=1, step=s)
            batch = {k: jax.device_put(jnp.asarray(v), bshard[k])
                     for k, v in (("tokens", x), ("labels", y), ("mask", m))}
            state, met = step(state, batch, jnp.ones((1,), jnp.float32))
            losses.append(float(met["loss"]))
        flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
        np.savez(os.path.join(out, f"jax_{name}.npz"),
                 losses=np.array(losses), attn=np.array(rules.attn.kind),
                 **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    print("JAX_OK")
""")


def _jax_cases():
    """Every case the JAX subprocess steps: each strategy case in both
    lanes, and the two fused cases."""
    out = {}
    for name, case in ranks.CASES.items():
        for lane, steps in ranks.LANE_STEPS.items():
            out[f"{name}_{lane}"] = list(case) + [lane, steps, False]
    for name, case in ranks.FUSED.items():
        out[name] = list(case) + ["elastic_zo", 2, True]
    return out


def _init(out, heads):
    params = api.init(ranks.cfg_of(heads), ranks.lane_of("elastic_zo"),
                      seed=0, device="cpu", max_seq=16)
    np.savez(os.path.join(out, ranks.init_name(heads) + ".npz"),
             **{zo.keystr(p): t.numpy() for p, t in
                zo.leaves_with_path(params)})


JAX_PROCS = 2           # JAX subprocesses, each compiling part of the cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case once: the JAX subprocesses (the cases dealt out among
    ``JAX_PROCS`` of them, whose compiles take most of the time) and
    the four port ranks run side by side. Returns the output
    directory."""
    out = str(tmp_path_factory.mktemp("strategies"))
    for heads in {c[5] for c in {**ranks.CASES, **ranks.EMPTY_RANK,
                                 **ranks.FUSED}.values()}:
        _init(out, heads)
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
        mesh_lib.spawn(ranks.strategy_rank, 4,
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


def _one_device(case, lane_name):
    """The port's run on one device from the same init."""
    _, _, _, B, S, heads = case
    cfg = ranks.cfg_of(heads)
    params = api.init(cfg, ranks.lane_of("elastic_zo"), seed=0,
                      device="cpu", max_seq=16)
    steps = ranks.LANE_STEPS[lane_name]
    return ranks.run_steps(
        api.make_train_step(cfg, ranks.lane_of(lane_name)), params,
        ranks.batches(cfg, ranks.shape_of(B, S), steps))


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_strategy_matches_jax(runs, case, lane):
    """Losses of 2 elastic_zo steps, and every leaf after them (the tail's
    BP update) or after 1 full_bp step, within LM_TOL of JAX's step on
    the same mesh in the same strategy."""
    got, meta = _load(runs, f"{case}_{lane}")
    want = dict(np.load(os.path.join(runs, f"jax_{case}_{lane}.npz")))
    assert meta["attn"] == str(want.pop("attn"))
    np.testing.assert_allclose(meta["losses"], want.pop("losses"), **LM_TOL)
    _close(got, want, f"{case} {lane} against JAX")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(ranks.CASES) + list(ranks.EMPTY_RANK))
def test_strategy_matches_one_device(runs, case, lane):
    """The same runs within LM_TOL of the port's one-device step, the
    replicated leaves and the copies of each shard bitwise on every rank
    (``MeshRun.check_replicas``)."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, params = _one_device({**ranks.CASES, **ranks.EMPTY_RANK}[case],
                                 lane)
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, {zo.keystr(p): t.numpy()
                 for p, t in zo.leaves_with_path(params)},
           f"{case} {lane} against one device")
    assert meta["replica_pairs"] > 0


@pytest.mark.parametrize("case", ["seq_s16", "seq_s18", "seq_s6"])
def test_seq_plan_taken(runs, case):
    """6 Q heads over 4 ranks pad to 8 (33% waste): the rules take the
    seq plan, and the batch stays over `data`."""
    _, meta = _load(runs, f"{case}_elastic_zo")
    assert meta["attn"] == "seq" and meta["batch_axes"] == ["data"]


def test_batch_axes_follow_the_rules(runs):
    """fsdp puts the rows over (data, model) when 4 rows divide 2 x 2,
    over data alone at 2 rows; serve over data; pod over (pod, data)."""
    axes = {c: _load(runs, f"{c}_full_bp")[1]["batch_axes"]
            for c in ("fsdp_b4", "fsdp_b2", "serve", "pod")}
    assert axes == {"fsdp_b4": ["data", "model"], "fsdp_b2": ["data"],
                    "serve": ["data"], "pod": ["pod", "data"]}


@pytest.mark.parametrize("case", list(ranks.FUSED))
def test_fused_pair_is_bitwise_the_unfused_pair(runs, case):
    _, meta = _load(runs, case)
    assert meta["fused_pair"] == meta["unfused_pair"]


@pytest.mark.parametrize("case", list(ranks.FUSED))
def test_fused_matches_jax_fused(runs, case):
    got, meta = _load(runs, case)
    want = dict(np.load(os.path.join(runs, f"jax_{case}.npz")))
    want.pop("attn")
    np.testing.assert_allclose(meta["losses"], want.pop("losses"), **LM_TOL)
    _close(got, want, f"{case} against JAX's fused lane")


def test_launcher_on_the_pod_mesh(runs):
    """``launch/train.py::train`` on the 2x1x2 (pod, data, model) mesh:
    its losses within LM_TOL of the same flags without a mesh."""
    _, meta = _load(runs, "launcher_pod")
    plain = launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device",
                               "cpu", "--steps", "3"])
    assert [s for s, _ in meta["history"]] == [s for s, _ in plain]
    np.testing.assert_allclose([v for _, v in meta["history"]],
                               [v for _, v in plain], **LM_TOL)


@pytest.mark.parametrize("strategy", ranks.RESTORE_UNDER)
def test_tp_checkpoint_restores_under_strategy(runs, strategy):
    """Saved at 2x2 tp, restored at 2x2 under ``strategy``: on every rank
    each shard is bytes-equal to the whole leaf's slice."""
    _, meta = _load(runs, f"restored_{strategy}")
    for same, n, sharded, at in meta["ranks"]:
        assert same and n > 0 and at == 1
        assert sharded > 0 if strategy == "fsdp" else sharded >= 0


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
def test_one_rank_fsdp_world_is_one_device(runs, lane):
    res = json.load(open(os.path.join(runs, "one_rank_fsdp.json")))
    assert res[lane] == {"losses": True, "params": True}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_without_a_mesh_is_the_default(strategy):
    """``build_for_mesh(mesh=None, strategy=s)``: the one-device step,
    bitwise, as JAX's ``ShardingRules(None, ...)`` is for every s."""
    cfg, lane = ranks.cfg_of(), ranks.lane_of("elastic_zo")
    shape = ranks.shape_of(2, 16)
    out = []
    for step_fn in (api.make_train_step(cfg, lane),
                    build_for_mesh(cfg, shape, lane, None, strategy)[1]):
        params = api.init(cfg, lane, seed=0, device="cpu", max_seq=16)
        state = TrainState(params, 0, keys.key_data(0))
        for b in ranks.batches(cfg, shape, 2):
            state, m = step_fn(state, b, np.ones(1, np.float32))
        out.append((float(m["loss"]), state.params))
    assert out[0][0] == out[1][0]
    for p, t in zo.leaves_with_path(out[0][1]):
        assert torch.equal(t, zo._at(out[1][1], p)), p


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_query_offset_chunks(causal, window):
    """Rows [lo, hi) of a sequence at ``q_offset = lo`` against keys 0 ..
    hi - 1 (all keys where not causal): the chunks concatenated are the
    whole call, an empty last chunk included (18 rows in blocks of 5, 5,
    5, 3; and 6 rows in blocks of 2, 2, 2, 0)."""
    g = torch.Generator().manual_seed(0)
    for S, tp in ((18, 4), (6, 4)):
        q = torch.randn(2, 6, S, 16, generator=g)
        k = torch.randn(2, 2, S, 16, generator=g)
        v = torch.randn(2, 2, S, 16, generator=g)
        whole = ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
        c = -(-S // tp)
        parts = []
        for r in range(tp):
            lo, hi = min(r * c, S), min((r + 1) * c, S)
            T = hi if causal else S
            parts.append(ref.flash_attention_ref(
                q[:, :, lo:hi], k[:, :, :T], v[:, :, :T], causal=causal,
                window=window, q_offset=lo))
        assert parts[-1].shape[2] == S - min((tp - 1) * c, S)
        torch.testing.assert_close(torch.cat(parts, dim=2), whole,
                                   rtol=0, atol=1e-6)
