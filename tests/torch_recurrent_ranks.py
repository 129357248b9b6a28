"""The ranks of ``test_torch_mesh_rwkv.py`` and ``test_torch_mesh_jamba.py``:
spawned processes, so this module imports torch and the port only (no
JAX, no pytest).

``recurrent_rank`` joins a gloo group of 4 CPU ranks at a ``file://``
store and runs every case of one test module's ``SUITES`` entry in that
one world (each mesh a ``DeviceMesh`` over it) from the inits and
batches the test saved under ``out``, writing what the tests compare to
``out``/<case>.npz or .json: rank 0 writes the global leaves, gathered
from the shards, and every case's losses. Then rank 0 alone joins a
world of one rank and runs the suite's stack on a 1x1 mesh.
"""
import json
import os
import sys
import types

import numpy as np
import torch

import torch_strategy_ranks
from torch_strategy_ranks import _gathered, _pair, _shards, run_steps

RWKV, JAMBA = "rwkv6-1.6b", "jamba-v0.1-52b"
SEQ = 16
LOW = 1e-3      # the ZO rate of the cases marked with it (rate_of)
DATA_MODEL = ("data", "model")
POD = ("pod", "data", "model")
# config name: (arch, overrides of the reduced config)
CONFIGS = {
    "rwkv": (RWKV, {}),
    # 2 heads of 32: tp 4 divides d_model (w_r, cm_k) but not the heads
    "rwkv_h2": (RWKV, {"rwkv_head_dim": 32}),
    # two periods of (Mamba, Mamba + MoE, attention): the BP tail holds
    # one of each kind
    "jamba3": (JAMBA, {"block_pattern": ("mamba", "mamba", "attn"),
                       "num_layers": 6}),
    "jamba8": (JAMBA, {}),                   # its own pattern, one period
}
# name: (mesh shape, axes, strategy, global batch, config name[, the
# elastic_zo lane's ZO rate where it is not the lane's: rate_of])
SUITES = {
    "rwkv": {
        "cases": {
            "tp": ((2, 2), DATA_MODEL, "tp", 2, "rwkv"),
            "fsdp_b4": ((2, 2), DATA_MODEL, "fsdp", 4, "rwkv", LOW),
            "fsdp_b2": ((2, 2), DATA_MODEL, "fsdp", 2, "rwkv"),
            "serve": ((2, 2), DATA_MODEL, "serve", 2, "rwkv"),
            "tp_1x4": ((1, 4), DATA_MODEL, "tp", 2, "rwkv"),
            "pod": ((2, 1, 2), POD, "tp", 2, "rwkv"),
        },
        # held against one device only
        "local": {"tp_h2": ((1, 4), DATA_MODEL, "tp", 2, "rwkv_h2", LOW)},
        "fused": {"tp_fused": "tp"},
        "restore": "tp",
        "one_rank": "tp",
    },
    "jamba": {
        "cases": {
            "tp": ((2, 2), DATA_MODEL, "tp", 2, "jamba3"),
            "fsdp_b4": ((2, 2), DATA_MODEL, "fsdp", 4, "jamba3"),
            "serve": ((2, 2), DATA_MODEL, "serve", 2, "jamba3", LOW),
            "tp_1x4": ((1, 4), DATA_MODEL, "tp", 2, "jamba3"),
            "tp8": ((2, 2), DATA_MODEL, "tp", 2, "jamba8", LOW),
        },
        "local": {},
        "fused": {"fsdp_b4_fused": "fsdp_b4"},
        "restore": None,
        "one_rank": "tp",
    },
}
LANE_STEPS = {"elastic_zo": 2, "full_bp": 1}


def rate_of(case):
    """The elastic_zo lane's ZO rate of ``case``: its sixth field, else
    None (the lane's, 1e-2, as every mesh suite's). The four cases marked
    LOW take 1e-3 (the tail's stays 1e-2): at 1e-2 the first ZO step
    moves the head so far that the second step's coefficient carries
    the first step's rounding amplified, and two meshes land outside
    LM_TOL of each other, JAX's alike
    (``torch_recurrent_rates.py``, PERF.md §6)."""
    return case[5] if len(case) > 5 else None


def lane_of(name, case=None, fused=False):
    """The suite's lane ``name``; elastic_zo at ``case``'s ZO rate."""
    import dataclasses
    lane = torch_strategy_ranks.lane_of(name, fused)
    rate = rate_of(case) if case else None
    if name != "elastic_zo" or rate is None:
        return lane
    return dataclasses.replace(lane, learning_rate=rate,
                               tail_learning_rate=lane.learning_rate)


def suite_cases(suite_name, rate=None):
    """The suite's cases, those held against one device only included;
    every elastic_zo lane at ``rate`` where it is given."""
    suite = SUITES[suite_name]
    cases = {**suite["cases"], **suite["local"]}
    if rate is None:
        return cases
    return {k: c[:5] + (rate,) for k, c in cases.items()}


def cfg_of(case):
    from repro_torch.configs import ARCHS, reduced
    arch, over = CONFIGS[case[4]]
    return reduced(ARCHS[arch], dtype="float32", **over)


def shape_of(case):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=SEQ, global_batch=case[3], kind="train")


def init_name(case):
    return f"init_{case[4]}"


def batch_name(case, step):
    return f"batch_b{case[3]}_{case[4]}_{step}"


def make_batch(case, step):
    """The global batch of ``step``: the launcher's synthetic tokens
    (seed 1)."""
    from repro_torch.data.pipeline import lm_batch_fn
    return lm_batch_fn(cfg_of(case), shape_of(case), seed=1)(step)


def load_params(path, case, device="cpu"):
    """The init saved by the test (npz keyed by keystr) as a tree."""
    from repro_torch.core import api, zo
    z = np.load(path)
    template = api.abstract_params(cfg_of(case), lane_of("elastic_zo"),
                                   max_seq=SEQ)
    return zo.map_with_path(
        lambda p, _t: torch.from_numpy(z[zo.keystr(p)].copy()).to(device),
        template)


def batches(out, case, steps, rows=None):
    rows = rows or slice(None)
    out_list = []
    for s in range(steps):
        z = np.load(os.path.join(out, batch_name(case, s) + ".npz"))
        out_list.append({k: torch.from_numpy(np.ascontiguousarray(z[k][rows]))
                         for k in z.files})
    return out_list


def _build(case, lane, meshes, strategy=None):
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.train.elastic_runtime import build_for_mesh
    shape, axes, strat = case[:3]
    model, step_fn = build_for_mesh(cfg_of(case), shape_of(case), lane,
                                    meshes[(shape, axes)],
                                    strategy or strat)
    run = model.run
    return model, step_fn, rank_rows(shape_of(case), run.rules, run.coords)


class RankView:
    """What ``build_for_mesh``, the engine and the sharded init read of a
    ``MeshRun`` (the rules, the mesh's axis sizes, the rank's
    coordinates and shard descriptors), for a rank at ``coords`` of an
    ``AbstractMesh``, with no process group: patched in for
    ``collectives.MeshRun`` where a test builds a stack on a mesh
    without ranks."""

    coords = {"data": 0, "model": 1}

    def __init__(self, mesh, rules, abstract_params):
        from repro_torch.launch.mesh import axis_shape
        from repro_torch.sharding.params import param_shardings, shard_descs
        self.rules, self.sizes = rules, axis_shape(mesh)
        self.specs = param_shardings(abstract_params, rules)
        self.descs = shard_descs(abstract_params, self.specs, self.coords,
                                 self.sizes)

    def index_maps(self):
        return None


def in_proj_record(meshes):
    """``ssm.py::in_proj_channels`` at tp 2 (the 2x2 mesh) and tp 4 (1x4)
    on the rank's shard of a random in_proj [32, 2 x 24]: whether its xs
    and z are bitwise the rank's channels of the one-device product's
    halves, and whether the gradient it returns to the shard is the
    whole gradient's shard (within f32 rounding)."""
    from repro_torch.models.ssm import in_proj_channels
    gen = torch.Generator().manual_seed(7)
    h = torch.randn(2, 5, 32, generator=gen)
    w = torch.randn(32, 48, generator=gen)
    up = torch.randn(2, 5, 48, generator=gen)
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = meshes[(shape, DATA_MODEL)]
        tp, r = shape[1], mesh.get_local_rank("model")
        run = types.SimpleNamespace(model_group=mesh.get_group("model"),
                                    model_rank=r, tp=tp)
        dl = 24 // tp
        shard = w[:, r * 48 // tp:(r + 1) * 48 // tp].clone() \
            .requires_grad_(True)
        xs, z = in_proj_channels(h, shard, run)
        xs_all, z_all = torch.einsum("bsd,de->bse", h, w).chunk(2, dim=-1)
        cols = slice(r * dl, (r + 1) * dl)
        upx, upz = up[..., :24][..., cols], up[..., 24:][..., cols]
        ((xs * upx).sum() + (z * upz).sum()).backward()
        wg = w.clone().requires_grad_(True)
        xa, za = torch.einsum("bsd,de->bse", h, wg).chunk(2, dim=-1)
        ((xa * up[..., :24]).sum() + (za * up[..., 24:]).sum()).backward()
        out[f"tp{tp}"] = {
            "xs": bool(torch.equal(xs.detach(), xs_all[..., cols])),
            "z": bool(torch.equal(z.detach(), z_all[..., cols])),
            "grad": bool(torch.allclose(
                shard.grad, wg.grad[:, r * 48 // tp:(r + 1) * 48 // tp],
                rtol=1e-5, atol=1e-6))}
    return out


def recurrent_rank(rank, store, out, suite_name, rate=None):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding.params import shard_leaf
    from repro_torch.train import checkpoint as ckpt
    suite = SUITES[suite_name]
    cases = suite_cases(suite_name, rate)
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    meshes = {}
    for shape, axes in [c[:2] for c in cases.values()] + [
            ((2, 2), DATA_MODEL), ((1, 4), DATA_MODEL)]:
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = mesh_lib.make_mesh(shape, axes)
    inits = {}

    def init(case):
        name = init_name(case)
        if name not in inits:
            inits[name] = load_params(os.path.join(out, name + ".npz"), case)
        return inits[name]

    def write(name, arrays=None, meta=None):
        if rank != 0:
            return
        if arrays is not None:
            np.savez(os.path.join(out, name + ".npz"), **arrays)
        if meta is not None:
            with open(os.path.join(out, name + ".json"), "w") as f:
                json.dump(meta, f)

    if suite_name == "jamba":
        every = [None] * 4
        dist.all_gather_object(every, in_proj_record(meshes))
        write("in_proj", meta={"ranks": every})

    # every case: 2 elastic_zo steps, 1 full_bp step
    for name, case in cases.items():
        for lane_name, steps in LANE_STEPS.items():
            model, step_fn, rows = _build(case, lane_of(lane_name, case),
                                          meshes)
            run = model.run
            losses, params = run_steps(step_fn, _shards(run, init(case)),
                                       batches(out, case, steps, rows))
            write(f"{name}_{lane_name}", _gathered(run, params),
                  {"losses": losses, "attn": run.rules.attn.kind,
                   "moe": run.rules.moe, "batch_axes": list(run.batch_axes),
                   "replica_pairs": run.check_replicas(params)})

    # fused probes: 2 steps, and one probe pair fused and unfused
    for name, base in suite["fused"].items():
        case = cases[base]
        lane = lane_of("elastic_zo", case, fused=True)
        model, step_fn, rows = _build(case, lane, meshes)
        run = model.run
        bl = batches(out, case, 2, rows)
        pair = {f: _pair(cfg_of(case), case, lane, run,
                         _shards(run, init(case)), bl[0], f)
                for f in (True, False)}
        losses, params = run_steps(step_fn, _shards(run, init(case)), bl)
        write(name, _gathered(run, params),
              {"losses": losses, "fused_pair": pair[True],
               "unfused_pair": pair[False]})

    # a checkpoint saved under tp after one step, restored under fsdp:
    # every shard bytes-equal to its leaf's slice
    if suite["restore"]:
        ck = os.path.join(out, "ckpt")
        case = cases[suite["restore"]]
        model, step_fn, rows = _build(case, lane_of("elastic_zo"), meshes)
        _, params = run_steps(step_fn, _shards(model.run, init(case)),
                              batches(out, case, 1, rows))
        ckpt.save(ck, 1, params, run=model.run)
        template = api.abstract_params(cfg_of(case), lane_of("elastic_zo"),
                                       max_seq=SEQ)
        whole, _ = ckpt.restore(ck, template, device="cpu")
        m2, _, _ = _build(case, lane_of("elastic_zo"), meshes, "fsdp")
        got, at = ckpt.restore(ck, template, device="cpu",
                               shardings=m2.run.descs)
        same = [bool(torch.equal(t, shard_leaf(zo._at(whole, p),
                                               zo._at(m2.run.descs, p))))
                for p, t in zo.leaves_with_path(got)]
        sharded = sum(not zo._at(m2.run.descs, p).whole
                      for p, _ in zo.leaves_with_path(got))
        every = [None] * 4
        dist.all_gather_object(every, [all(same), len(same), sharded, at])
        write("restored_fsdp", meta={"ranks": every})
    dist.destroy_process_group()

    # a world of one rank: the stack on a 1x1 mesh
    if rank == 0:
        one_rank_world(store + "_one", out, init,
                       cases[suite["one_rank"]])


def one_rank_world(store, out, init, base):
    """2 elastic_zo and 1 full_bp steps on a 1x1 mesh, and of one device,
    from the same init: whether each is bitwise."""
    import torch.distributed as dist
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_ranks("gloo", "cpu", 0, 1, store)
    meshes = {((1, 1), DATA_MODEL): mesh_lib.make_mesh((1, 1), DATA_MODEL)}
    case = ((1, 1), DATA_MODEL) + base[2:]
    res = {}
    for lane_name, steps in LANE_STEPS.items():
        lane = lane_of(lane_name, case)
        model, step_fn, rows = _build(case, lane, meshes)
        bl = batches(out, case, steps, rows)
        copy = zo.map_with_path(lambda p, t: t.clone(), init(case))
        lm, pm = run_steps(step_fn, copy, bl)
        copy = zo.map_with_path(lambda p, t: t.clone(), init(case))
        lo, po = run_steps(api.make_train_step(cfg_of(case), lane), copy, bl)
        res[lane_name] = {
            "losses": lm == lo,
            "params": all(torch.equal(a, zo._at(po, p))
                          for p, a in zo.leaves_with_path(pm))}
    dist.destroy_process_group()
    with open(os.path.join(out, "one_rank.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------- #
# the test modules' fixture: JAX subprocesses beside the port's ranks
# ---------------------------------------------------------------------- #
# JAX's jitted step on 4 forced host devices, a subprocess (this module
# imports no JAX): each case of argv[2] from the saved init and batches
JAX_SCRIPT = """
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
for name, (arch, over, seq, shape, axes, strategy, B, lane, lr, tail_lr,
           steps, init_name, batch_names) in cases.items():
    if "block_pattern" in over:
        over["block_pattern"] = tuple(over["block_pattern"])
    cfg = reduced(ARCHS[arch], dtype="float32", **over)
    key = (tuple(shape), tuple(axes))
    if key not in meshes:
        meshes[key] = make_mesh(shape, axes)
    shp = ShapeConfig("t", seq_len=seq, global_batch=B, kind="train")
    rules = ShardingRules(meshes[key], cfg, shp, strategy=strategy)
    model = api.build(cfg, shp, LaneConfig(
        lane=lane, bp_tail_layers=1, zo_num_probes=1, learning_rate=lr,
        tail_learning_rate=tail_lr), rules)
    abstract = model.abstract_params()
    pshard = param_shardings(abstract, rules)
    init = np.load(os.path.join(out, init_name + ".npz"))
    paths, tdef = jax.tree_util.tree_flatten_with_path(abstract)
    params = jax.tree_util.tree_unflatten(tdef, [
        jnp.asarray(init[jax.tree_util.keystr(p)]) for p, _ in paths])
    params = jax.tree.map(jax.device_put, params, pshard)
    # the step and key committed (replicated) as the step returns them,
    # so the second step reuses the first one's compile
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
             moe=np.array(rules.moe),
             batch_axes=np.array(",".join(rules.batch_axes)),
             **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
print("JAX_OK")
"""


def jax_cases(suite_name, rate=None):
    """Every case of the suite held against JAX (at ``rate``, where it is
    given, every case), in both lanes: the case's arch, overrides,
    sequence and fields, the lane, its rates, the steps, and the names
    of its init and batches."""
    out = {}
    cases = suite_cases(suite_name, rate) if rate else \
        SUITES[suite_name]["cases"]
    for name, case in cases.items():
        arch, over = CONFIGS[case[4]]
        for lane_name, steps in LANE_STEPS.items():
            lane = lane_of(lane_name, case)
            out[f"{name}_{lane_name}"] = [
                arch, dict(over), SEQ, *case[:4], lane_name,
                lane.learning_rate, lane.tail_learning_rate, steps,
                init_name(case), [batch_name(case, s) for s in range(steps)]]
    return out


def save_inputs(out, suite_name):
    """Each config's init (the port's, as numpy) and each case's global
    batches, which both packages read."""
    from repro_torch.core import api, zo
    for case in suite_cases(suite_name).values():
        path = os.path.join(out, init_name(case) + ".npz")
        if not os.path.exists(path):
            params = api.init(cfg_of(case), lane_of("elastic_zo"), seed=0,
                              device="cpu", max_seq=SEQ)
            np.savez(path, **{zo.keystr(p): t.numpy() for p, t in
                              zo.leaves_with_path(params)})
        for s in range(max(LANE_STEPS.values())):
            np.savez(os.path.join(out, batch_name(case, s) + ".npz"),
                     **make_batch(case, s))


def _deal(cases, n):
    """The JAX cases dealt among ``n`` processes, each, costliest first,
    to the least loaded. A case's compile cost is taken as its stack's
    blocks (a one-period Jamba step traces all eight), an elastic_zo
    step's as 3 times a full_bp step's (two probe forwards and the
    tail's backward; 58 s against 18 s for one-period Jamba here)."""
    from repro_torch.configs import ARCHS, reduced

    def cost(item):
        arch, over, lane = item[1][0], item[1][1], item[1][7]
        return reduced(ARCHS[arch], **over).num_layers * (
            3 if lane == "elastic_zo" else 1)
    parts, load = [{} for _ in range(n)], [0] * n
    for name, case in sorted(cases.items(), key=cost, reverse=True):
        i = load.index(min(load))
        parts[i][name] = case
        load[i] += cost((name, case))
    return [p for p in parts if p]


def run_suite(out, suite_name, jax_procs, rate=None):
    """Every case of the suite once: ``jax_procs`` JAX subprocesses (the
    cases dealt out among them; their compiles take most of the time)
    and the port's four ranks side by side, writing under ``out``. At
    ``rate``, where it is given, every case's elastic_zo lane takes that
    ZO rate, and JAX runs the cases held against one device only too."""
    import json as _json
    import subprocess
    from repro_torch.launch import mesh as mesh_lib
    save_inputs(out, suite_name)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, out, _json.dumps(part)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in _deal(jax_cases(suite_name, rate), jax_procs)]
    try:
        mesh_lib.spawn(recurrent_rank, 4, ("file://" + os.path.join(
            out, "store"), out, suite_name, rate))
    finally:
        done = [p.communicate(timeout=400) for p in procs]
    for p, (stdout, stderr) in zip(procs, done):
        if p.returncode != 0 or "JAX_OK" not in stdout:
            raise AssertionError(stderr[-3000:])
