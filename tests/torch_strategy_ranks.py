"""The ranks of ``test_torch_strategies.py``: spawned processes, so this
module imports torch and the port only (no JAX, no pytest).

``strategy_rank`` joins a gloo group of 4 CPU ranks at a ``file://``
store and runs every case of the test module in that one world (each
mesh a ``DeviceMesh`` over it), writing what the tests compare to
``out``/<case>.npz or .json: rank 0 writes the global leaves, gathered
from the shards, and every case's losses. Then rank 0 alone joins a
world of one rank and runs the ``fsdp`` strategy on a 1x1 mesh.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

# name: (mesh shape, axes, strategy, global batch, seq, (heads, kv heads))
DATA_MODEL = ("data", "model")
CASES = {
    "fsdp_b4": ((2, 2), DATA_MODEL, "fsdp", 4, 16, None),
    "fsdp_b2": ((2, 2), DATA_MODEL, "fsdp", 2, 16, None),
    "serve": ((2, 2), DATA_MODEL, "serve", 2, 16, None),
    "seq_s16": ((1, 4), DATA_MODEL, "tp", 2, 16, (6, 2)),
    "seq_s18": ((1, 4), DATA_MODEL, "tp", 2, 18, (6, 2)),
    "pod": ((2, 1, 2), ("pod", "data", "model"), "tp", 2, 16, None),
}
# the seq plan with a rank that holds no query row (6 rows over 4 ranks
# in blocks of 2), held against one device only
EMPTY_RANK = {"seq_s6": ((1, 4), DATA_MODEL, "tp", 2, 6, (6, 2))}
FUSED = {"fused_tp": ((2, 2), DATA_MODEL, "tp", 2, 16, None),
         "fused_fsdp": ((2, 2), DATA_MODEL, "fsdp", 4, 16, None)}
LANE_STEPS = {"elastic_zo": 2, "full_bp": 1}
RESTORE_UNDER = ("fsdp", "serve")


def cfg_of(heads=None):
    from repro_torch.configs import ARCHS, reduced
    cfg = reduced(ARCHS["qwen3-4b"], dtype="float32")
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    return cfg


def shape_of(batch, seq):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")


def lane_of(name, fused=False):
    from repro_torch.configs import LaneConfig
    return LaneConfig(lane=name, bp_tail_layers=1, zo_num_probes=1,
                      fused_probes=fused)


def init_name(heads):
    return "init" if heads is None else f"init_h{heads[0]}_{heads[1]}"


def load_params(path, cfg, device="cpu"):
    """The init saved by the test (npz keyed by keystr) as a tree."""
    from repro_torch.core import api, zo
    z = np.load(path)
    template = api.abstract_params(cfg, lane_of("elastic_zo"), max_seq=16)
    return zo.map_with_path(
        lambda p, _t: torch.from_numpy(z[zo.keystr(p)].copy()).to(device),
        template)


def batches(cfg, shape, steps, rows=None):
    from repro_torch.data.pipeline import lm_batch_fn
    fn = lm_batch_fn(cfg, shape, seed=1, rows=rows)
    return [{k: torch.from_numpy(v) for k, v in fn(s).items()}
            for s in range(steps)]


def run_steps(step_fn, params, batch_list):
    """The losses of ``len(batch_list)`` steps from ``params`` (step 0,
    key of seed 0) and the final params."""
    from repro_torch.core import keys
    from repro_torch.core.elastic import TrainState
    state = TrainState(params, 0, keys.key_data(0))
    losses = []
    for b in batch_list:
        state, m = step_fn(state, b, np.ones(1, np.float32))
        losses.append(float(m["loss"]))
    return losses, state.params


def _shards(run, params):
    from repro_torch.core import zo
    from repro_torch.sharding.params import shard_leaf
    return zo.map_with_path(
        lambda p, t: shard_leaf(t, zo._at(run.descs, p)).clone(), params)


def _gathered(run, params):
    from repro_torch.core import zo
    return {zo.keystr(p): run.gather_leaf(p, t).numpy()
            for p, t in zo.leaves_with_path(params)}


def _build(case, lane, meshes):
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.train.elastic_runtime import build_for_mesh
    shape, axes, strategy, B, S, heads = case
    cfg = cfg_of(heads)
    model, step_fn = build_for_mesh(cfg, shape_of(B, S), lane,
                                    meshes[(shape, axes)], strategy)
    run = model.run
    return cfg, model, step_fn, rank_rows(shape_of(B, S), run.rules,
                                          run.coords)


def _pair(cfg, case, lane, run, params, batch, fused):
    """(l+, l-) of probe seed 4242 on ``params`` (the rank's shards), by
    the fused pair or by perturbing the whole ZO part (the unfused
    step's two forwards)."""
    from repro_torch.core import api, elastic, zo
    zo_part, bp_part = elastic.partition(params, lane)
    seed = zo.device_seeds([4242], "cpu")
    with torch.no_grad():
        if fused:
            lp, lm = api.paired_loss(bp_part, zo_part, cfg, lane, batch,
                                     seed, run=run)
        else:
            maps = elastic.partition(run.index_maps(), lane)[0]
            ls = [api.loss_fn(elastic.merge(zo.perturb(zo_part, seed, e,
                                                       maps), bp_part),
                              cfg, batch, run=run)
                  for e in (lane.zo_eps, -lane.zo_eps)]
            lp, lm = ls
    return [float(lp), float(lm)]


def strategy_rank(rank, store, out):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding.params import shard_leaf
    from repro_torch.train import checkpoint as ckpt
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    all_cases = {**CASES, **EMPTY_RANK, **FUSED}
    meshes = {}
    for shape, axes, *_ in all_cases.values():
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = mesh_lib.make_mesh(shape, axes)
    inits = {}

    def init(heads):
        if heads not in inits:
            inits[heads] = load_params(
                os.path.join(out, init_name(heads) + ".npz"), cfg_of(heads))
        return inits[heads]

    def write(name, arrays=None, meta=None):
        if rank != 0:
            return
        if arrays is not None:
            np.savez(os.path.join(out, name + ".npz"), **arrays)
        if meta is not None:
            with open(os.path.join(out, name + ".json"), "w") as f:
                json.dump(meta, f)

    # every strategy case: 2 elastic_zo steps, 1 full_bp step
    for name, case in {**CASES, **EMPTY_RANK}.items():
        for lane_name, steps in LANE_STEPS.items():
            cfg, model, step_fn, rows = _build(case, lane_of(lane_name),
                                               meshes)
            run = model.run
            shape = shape_of(*case[3:5])
            losses, params = run_steps(step_fn, _shards(run, init(case[5])),
                                       batches(cfg, shape, steps, rows))
            write(f"{name}_{lane_name}", _gathered(run, params),
                  {"losses": losses, "attn": run.rules.attn.kind,
                   "batch_axes": list(run.batch_axes),
                   "replica_pairs": run.check_replicas(params)})

    # fused probes: 2 steps, and one probe pair fused and unfused
    for name, case in FUSED.items():
        lane = lane_of("elastic_zo", fused=True)
        cfg, model, step_fn, rows = _build(case, lane, meshes)
        run = model.run
        shape = shape_of(*case[3:5])
        bl = batches(cfg, shape, 2, rows)
        pair = {f: _pair(cfg, case, lane, run, _shards(run, init(case[5])),
                         bl[0], f) for f in (True, False)}
        losses, params = run_steps(step_fn, _shards(run, init(case[5])), bl)
        write(name, _gathered(run, params),
              {"losses": losses, "fused_pair": pair[True],
               "unfused_pair": pair[False]})

    # the launcher's path on the pod mesh: launch/train.py::train
    argv = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps",
            "3", "--mesh", "2x1x2:pod,data,model"]
    hist = launch_train.train(launch_train.parse_args(argv),
                              meshes[CASES["pod"][:2]])
    write("launcher_pod", meta={"history": hist})

    # a checkpoint saved at 2x2 tp after one step, restored under the
    # other strategies: every shard bytes-equal to the whole leaf's slice
    ck = os.path.join(out, "ckpt")
    base = ((2, 2), DATA_MODEL, "tp", 2, 16, None)
    cfg, model, step_fn, rows = _build(base, lane_of("elastic_zo"), meshes)
    _, params = run_steps(step_fn, _shards(model.run, init(None)),
                          batches(cfg, shape_of(2, 16), 1, rows))
    ckpt.save(ck, 1, params, run=model.run)
    template = api.abstract_params(cfg, lane_of("elastic_zo"), max_seq=16)
    whole, _ = ckpt.restore(ck, template, device="cpu")
    for strategy in RESTORE_UNDER:
        _, m2, _, _ = _build(base[:2] + (strategy,) + base[3:],
                             lane_of("elastic_zo"), meshes)
        got, at = ckpt.restore(ck, template, device="cpu",
                               shardings=m2.run.descs)
        same = [bool(torch.equal(t, shard_leaf(zo._at(whole, p),
                                               zo._at(m2.run.descs, p))))
                for p, t in zo.leaves_with_path(got)]
        sharded = sum(not zo._at(m2.run.descs, p).whole
                      for p, _ in zo.leaves_with_path(got))
        flags = [None] * 4
        flags[rank] = [all(same), len(same), sharded, at]
        gathered = [None] * 4
        dist.all_gather_object(gathered, flags[rank])
        write(f"restored_{strategy}", meta={"ranks": gathered})
    dist.destroy_process_group()

    # a world of one rank: the fsdp strategy on a 1x1 mesh
    if rank == 0:
        one_rank_world(store + "_one", out, init(None))


def one_rank_world(store, out, init):
    """2 elastic_zo and 1 full_bp steps of fsdp on a 1x1 mesh, and of one
    device, from the same init: whether each is bitwise."""
    import torch.distributed as dist
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_ranks("gloo", "cpu", 0, 1, store)
    mesh = {((1, 1), DATA_MODEL): mesh_lib.make_mesh((1, 1), DATA_MODEL)}
    case = ((1, 1), DATA_MODEL, "fsdp", 2, 16, None)
    res = {}
    for lane_name, steps in LANE_STEPS.items():
        lane = lane_of(lane_name)
        cfg, model, step_fn, rows = _build(case, lane, mesh)
        bl = batches(cfg, shape_of(2, 16), steps, rows)
        copy = zo.map_with_path(lambda p, t: t.clone(), init)
        lm, pm = run_steps(step_fn, copy, bl)
        copy = zo.map_with_path(lambda p, t: t.clone(), init)
        lo, po = run_steps(api.make_train_step(cfg, lane), copy, bl)
        res[lane_name] = {"losses": lm == lo, "params": all(
            torch.equal(a, zo._at(po, p)) for p, a in zo.leaves_with_path(pm))}
    dist.destroy_process_group()
    with open(os.path.join(out, "one_rank_fsdp.json"), "w") as f:
        json.dump(res, f)
