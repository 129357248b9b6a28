"""Port parity of the MoE stacks trained across a mesh, on CPU ranks:
expert parallelism (the ``ep`` plan) with its dispatch all-to-all, and
the MoE ``tp`` plan.

Four spawned gloo ranks (``torch_moe_ranks.py``, one intra-op thread
each; rendezvous at a ``file://`` store under the test's temporary
directory, never a TCP port) train reduced mixtral-8x7b in f32 from one
init in every case of ``CASES``: 2 elastic_zo steps and 1 full_bp step
each, in every strategy. 4 experts over 2 `model` ranks take the ``ep``
plan: under ``fsdp`` at batch 4 the rows are over (data, model) and the
buffers go through the all-to-all; at batch 2, and under ``tp`` and
``serve``, the `model` ranks hold the same rows and each computes its own
experts. 6 experts over 4 ranks take the MoE ``tp`` plan (d_ff split
under ``tp``, the one-device form on gathered weights under ``fsdp``).
The pod mesh runs ``ep`` under ``tp``. Then the fused probe pair at 2x2
``tp`` and ``fsdp``, a ``tp`` checkpoint restored under ``fsdp``, and
rank 0 alone on a 1x1 mesh. Meanwhile subprocesses with 4 forced host
devices run JAX's jitted step in every case from the same init and
batches.

Tolerances: the sharded products and sums add in other orders than one
device's (and than XLA's), so steps agree within ``LM_TOL`` (as
``test_torch_strategies.py``); the full_bp step moves every leaf, so an
x gradient through the expert inputs left unsummed over `model` (or the
router's summed there) leaves the tolerance. The fused pair, the
all-to-all and the one-rank world are bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_moe_ranks as ranks  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import api, zo  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

LM_TOL = dict(rtol=1e-3, atol=1e-4)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
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
    for name, (arch, seq, shape, axes, strategy, B, E, lane, steps,
               init_name, batch_names) in cases.items():
        cfg = reduced(ARCHS[arch], dtype="float32", num_experts=E)
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_mesh(shape, axes)
        shp = ShapeConfig("t", seq_len=seq, global_batch=B, kind="train")
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
                 losses=np.array(losses), moe=np.array(rules.moe),
                 batch_axes=np.array(",".join(rules.batch_axes)),
                 **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    print("JAX_OK")
""")

JAX_PROCS = 3           # JAX subprocesses, each compiling part of the cases


def _jax_cases():
    """Every case in both lanes: the arch, the sequence, the case's
    fields, the lane, the steps, and the names of its init and
    batches."""
    out = {}
    for name, case in ranks.CASES.items():
        for lane, steps in ranks.LANE_STEPS.items():
            out[f"{name}_{lane}"] = [ranks.ARCH, ranks.SEQ] + list(case) + [
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
                              seed=0, device="cpu", max_seq=ranks.SEQ)
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
    out = str(tmp_path_factory.mktemp("mesh_moe"))
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
        mesh_lib.spawn(ranks.moe_rank, 4,
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


def _jax(out, name):
    """JAX's run ``name``: (losses, rules.moe, batch axes, leaves)."""
    want = dict(np.load(os.path.join(out, f"jax_{name}.npz")))
    axes = str(want.pop("batch_axes"))
    return (want.pop("losses"), str(want.pop("moe")),
            axes.split(",") if axes else [], want)


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
    BP update, its experts' and router's included), or after 1 full_bp
    step (every leaf moved), within LM_TOL of JAX's step on the same mesh
    in the same strategy."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, moe, _, want = _jax(runs, f"{case}_{lane}")
    assert meta["moe"] == moe
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, want, f"{case} {lane} against JAX")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_case_matches_one_device(runs, case, lane):
    """The same runs within LM_TOL of the port's one-device step, the
    replicated leaves (the router over `model`) and the copies of each
    shard bitwise on every rank (``MeshRun.check_replicas``)."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, params = _one_device(runs, ranks.CASES[case], lane)
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, {zo.keystr(p): t.numpy()
                 for p, t in zo.leaves_with_path(params)},
           f"{case} {lane} against one device")
    assert meta["replica_pairs"] > 0


PLANS = {"tp_e6": "tp", "fsdp_e6": "tp"}
BATCH_AXES = {"fsdp_b4": ["data", "model"], "fsdp_e6": ["data", "model"],
              "pod": ["pod", "data"]}


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_rules_take_the_plan(runs, case):
    """4 experts over 2 `model` ranks: the ``ep`` plan in every strategy,
    the expert dim kept over `model` (``MeshRun.expert_axis``); 6
    experts over 4: the MoE ``tp`` plan, no expert axis. fsdp puts the
    rows over (data, model) where 4 rows divide the mesh (the
    all-to-all) and over data alone at 2 rows, where the `model` ranks
    hold the same rows; the pod mesh over (pod, data). JAX's rules say
    the same."""
    _, meta = _load(runs, f"{case}_full_bp")
    _, moe, axes, _ = _jax(runs, f"{case}_full_bp")
    plan = PLANS.get(case, "ep")
    assert meta["moe"] == moe == plan
    assert meta["expert_axis"] == ("model" if plan == "ep" else None)
    assert meta["batch_axes"] == axes == BATCH_AXES.get(case, ["data"])
    if case == "fsdp_b2":
        assert meta["rows"] == [0, 1]             # rank 0: (data 0, model 0)


def test_all_to_all_is_exact_and_reverses(runs):
    """``collectives.all_to_all`` over `model` on bf16 tensors: on every
    rank each part lands whole and bitwise at its place, in bf16, and
    the gradient comes back through the reverse all-to-all."""
    _, meta = _load(runs, "all_to_all")
    assert meta["ranks"] == [{"forward": True, "dtype": "torch.bfloat16",
                              "backward": True}] * 4


@pytest.mark.parametrize("case", list(ranks.FUSED))
def test_fused_pair_is_bitwise_the_unfused_pair(runs, case):
    """The fused pair perturbs each period's gathered slice (``fsdp``: an
    expert leaf's block of experts at its global flat indices) or the
    shard of the slice (``tp``); either is bitwise the unfused pair."""
    _, meta = _load(runs, case)
    assert meta["fused_pair"] == meta["unfused_pair"]


@pytest.mark.parametrize("case", list(ranks.FUSED))
def test_fused_matches_jax_unfused(runs, case):
    """The fused lane's 2 steps within LM_TOL of JAX's unfused lane on
    the same mesh (the fused pair is the unfused one)."""
    got, meta = _load(runs, case)
    losses, _, _, want = _jax(runs, f"{ranks.FUSED[case]}_elastic_zo")
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, want, f"{case} against JAX's unfused lane")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
def test_one_rank_world_is_one_device(runs, lane):
    res = json.load(open(os.path.join(runs, "one_rank.json")))
    assert res[lane] == {"moe": "tp", "losses": True, "params": True}


def test_tp_checkpoint_restores_under_fsdp(runs):
    """Mixtral saved at 2x2 tp, restored at 2x2 fsdp: on every rank each
    shard is bytes-equal to the whole leaf's slice, and an expert leaf's
    shard is the rank's block of 2 of the 4 experts (its `model`
    coordinate's) and half of d_model (its `data` coordinate's)."""
    _, meta = _load(runs, "restored_fsdp")
    leaf = "['periods_zo']['blk0']['moe']['w_gate']"
    for rank, (same, starts, shapes, at) in enumerate(meta["ranks"]):
        data, model = divmod(rank, 2)
        assert same and at == 1
        assert shapes[leaf] == [1, 2, 32, 128]
        assert starts[leaf] == [0, 2 * model, 32 * data, 0]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 8), (4, 4)])
def test_expert_block_maps_are_one_run(arch, mesh):
    """The map ``MeshRun.period_maps(..., gathered=True)`` gives an expert
    leaf under ``fsdp`` + ``ep`` (``params.kept_desc``: gathered over
    `data`, still split over `model`): a period's block of E / tp
    experts is one contiguous run at p * size + its first expert's
    offset, which the noise kernels take in their offset form."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.prng import IndexMap
    from repro_torch.sharding.params import (kept_desc, param_shardings,
                                             period_map, shard_desc)
    from repro_torch.sharding.rules import ShardingRules
    cfg = dataclasses.replace(ARCHS[arch], num_layers=4)
    rules = ShardingRules(mesh_lib.AbstractMesh(mesh, ("data", "model")), cfg,
                          ShapeConfig("t", seq_len=16, global_batch=2,
                                      kind="train"), strategy="fsdp")
    assert rules.moe == "ep"
    abstract = api.abstract_params(cfg, ranks.lane_of("elastic_zo"))
    specs = param_shardings(abstract, rules)
    tp, E = mesh[1], cfg.num_experts
    for name in ("w_gate", "w_up", "w_down"):
        shape = tuple(abstract["periods_zo"]["blk0"]["moe"][name].shape)
        spec = specs["periods_zo"]["blk0"]["moe"][name]
        assert spec[1] == "model"
        size = int(np.prod(shape[1:]))
        for data in range(mesh[0]):
            for model in range(tp):
                d = shard_desc(shape, spec, {"data": data, "model": model},
                               {"data": mesh[0], "model": tp})
                k = kept_desc(d, (None, "model"))
                assert k.local_shape == (shape[0], E // tp) + shape[2:]
                for p in range(shape[0]):
                    m = period_map(k, p)
                    assert m.is_contiguous
                    assert m.base == p * size + model * (size // tp)
                    assert m.numel == size // tp
                    assert period_map(kept_desc(d, (None,)), p).levels == \
                        IndexMap(p * size, ((size, 1),)).levels


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
    """The launches a rank makes a step in the card's Mixtral mesh lanes
    (``chip_smoke.py::mesh_per_step``) at 2 of 32 layers: 11 ZO leaves
    (embed, and the ZO period's ln_attn, wq / wk / wv / wo, ln_ffn,
    router and the 3 expert leaves), so 22 / 11 / 2, fused 22 / 11 / 2
    (one ZO period); every strategy alike."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(ARCHS["mixtral-8x7b"],
                              num_layers=cs.MESH_MOE_LAYERS)
    assert [tuple(cs.mesh_per_step(cfg, f).values()) for f in (False, True)
            ] == [(22, 11, 2), (22, 11, 2)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["tp", "tp_e6"])
def test_mesh_per_step_counts_a_step(case, fused, monkeypatch):
    """``mesh_per_step`` of reduced Mixtral is what one elastic_zo step
    calls of each kernel's entry point in ``kernels.ops`` on one device
    (the CPU runs the plain versions; a mesh rank makes the same calls
    in every strategy and MoE plan)."""
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
    params = api.init(cfg, lane, seed=0, device="cpu", max_seq=ranks.SEQ)
    batch = {k: torch.from_numpy(v) for k, v in ranks.make_batch(c, 0).items()}
    ranks.run_steps(api.make_train_step(cfg, lane), params, [batch])
    assert counts == cs.mesh_per_step(cfg, fused)
