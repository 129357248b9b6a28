"""The ranks of ``test_torch_mesh_moe.py``: spawned processes, so this
module imports torch and the port only (no JAX, no pytest).

``moe_rank`` joins a gloo group of 4 CPU ranks at a ``file://`` store
and runs every case of the test module in that one world (each mesh a
``DeviceMesh`` over it) from the inits and batches the test saved under
``out``, writing what the tests compare to ``out``/<case>.npz or .json:
rank 0 writes the global leaves, gathered from the shards, and every
case's losses. Then rank 0 alone joins a world of one rank and runs the
stack on a 1x1 mesh.
"""
import json
import os
import sys

import numpy as np
import torch

from torch_strategy_ranks import (_gathered, _pair, _shards, lane_of,
                                  run_steps)

ARCH = "mixtral-8x7b"
SEQ = 16
DATA_MODEL = ("data", "model")
# name: (mesh shape, axes, strategy, global batch, experts)
CASES = {
    "tp": ((2, 2), DATA_MODEL, "tp", 2, 4),
    "fsdp_b4": ((2, 2), DATA_MODEL, "fsdp", 4, 4),
    "fsdp_b2": ((2, 2), DATA_MODEL, "fsdp", 2, 4),
    "serve": ((2, 2), DATA_MODEL, "serve", 2, 4),
    "tp_e6": ((1, 4), DATA_MODEL, "tp", 2, 6),
    "fsdp_e6": ((1, 4), DATA_MODEL, "fsdp", 4, 6),
    "pod": ((2, 1, 2), ("pod", "data", "model"), "tp", 2, 4),
}
# fused probes: the same runs as the named unfused case, fused
FUSED = {f"{c}_fused": c for c in ("tp", "fsdp_b4", "fsdp_b2")}
LANE_STEPS = {"elastic_zo": 2, "full_bp": 1}
ONE_RANK = "tp"


def cfg_of(case):
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS[ARCH], dtype="float32", num_experts=case[4])


def shape_of(case):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=SEQ, global_batch=case[3], kind="train")


def init_name(case):
    return f"init_e{case[4]}"


def batch_name(case, step):
    return f"batch_b{case[3]}_e{case[4]}_{step}"


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


def _all_to_all_record(rank, meshes):
    """The all-to-all over `model` of the 2x2 mesh, on a bf16 tensor:
    whether its forward moved each part exactly (part j of rank r lands
    at block r of rank j), and whether its backward is the reverse
    all-to-all of the gradient."""
    from repro_torch.sharding import collectives as col
    mesh = meshes[((2, 2), DATA_MODEL)]
    g, r = mesh.get_group("model"), mesh.get_local_rank("model")
    x = (torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
         / 7 + 100 * rank).to(torch.bfloat16).requires_grad_(True)
    y = col.all_to_all(x, g, 0, 1)                     # [1, 6, 4]
    peer = rank + (1 if r == 0 else -1)
    xp = (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) / 7
          + 100 * peer).to(torch.bfloat16)
    parts = [x.detach(), xp] if r == 0 else [xp, x.detach()]
    want = torch.cat([p[r:r + 1] for p in parts], dim=1)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(rank))
    (y.float() * w).sum().backward()
    back = col.all_to_all(w.to(torch.bfloat16), g, 1, 0)
    return {"forward": bool(torch.equal(y.detach(), want)),
            "dtype": str(y.dtype),
            "backward": bool(torch.equal(x.grad, back))}


def moe_rank(rank, store, out):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding.params import shard_leaf
    from repro_torch.train import checkpoint as ckpt
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    meshes = {}
    for shape, axes, *_ in CASES.values():
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

    every = [None] * 4
    dist.all_gather_object(every, _all_to_all_record(rank, meshes))
    write("all_to_all", meta={"ranks": every})

    # every case: 2 elastic_zo steps, 1 full_bp step
    for name, case in CASES.items():
        for lane_name, steps in LANE_STEPS.items():
            model, step_fn, rows = _build(case, lane_of(lane_name), meshes)
            run = model.run
            losses, params = run_steps(step_fn, _shards(run, init(case)),
                                       batches(out, case, steps, rows))
            write(f"{name}_{lane_name}", _gathered(run, params),
                  {"losses": losses, "moe": run.rules.moe,
                   "expert_axis": run.expert_axis,
                   "batch_axes": list(run.batch_axes),
                   "rows": [rows.start, rows.stop],
                   "replica_pairs": run.check_replicas(params)})

    # fused probes: 2 steps, and one probe pair fused and unfused
    for name, base in FUSED.items():
        case = CASES[base]
        lane = lane_of("elastic_zo", fused=True)
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

    # a checkpoint saved at 2x2 tp after one step, restored under fsdp:
    # every shard, each rank's block of experts included, bytes-equal to
    # its leaf's slice
    ck = os.path.join(out, "ckpt")
    case = CASES["tp"]
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
    same = {zo.keystr(p): bool(torch.equal(
        t, shard_leaf(zo._at(whole, p), zo._at(m2.run.descs, p))))
        for p, t in zo.leaves_with_path(got)}
    starts = {zo.keystr(p): list(zo._at(m2.run.descs, p).starts)
              for p, _ in zo.leaves_with_path(got)}
    shapes = {zo.keystr(p): list(t.shape) for p, t in
              zo.leaves_with_path(got)}
    mine = [all(same.values()), starts, shapes, at]
    every = [None] * 4
    dist.all_gather_object(every, mine)
    write("restored_fsdp", meta={"ranks": every})
    dist.destroy_process_group()

    # a world of one rank: the stack on a 1x1 mesh
    if rank == 0:
        one_rank_world(store + "_one", out, init)


def one_rank_world(store, out, init):
    """2 elastic_zo and 1 full_bp steps on a 1x1 mesh, and of one device,
    from the same init: whether each is bitwise."""
    import torch.distributed as dist
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_ranks("gloo", "cpu", 0, 1, store)
    meshes = {((1, 1), DATA_MODEL): mesh_lib.make_mesh((1, 1), DATA_MODEL)}
    case = ((1, 1), DATA_MODEL) + CASES[ONE_RANK][2:]
    res = {}
    for lane_name, steps in LANE_STEPS.items():
        lane = lane_of(lane_name)
        model, step_fn, rows = _build(case, lane, meshes)
        bl = batches(out, case, steps, rows)
        copy = zo.map_with_path(lambda p, t: t.clone(), init(case))
        lm, pm = run_steps(step_fn, copy, bl)
        copy = zo.map_with_path(lambda p, t: t.clone(), init(case))
        lo, po = run_steps(api.make_train_step(cfg_of(case), lane), copy, bl)
        res[lane_name] = {
            "moe": model.run.rules.moe, "losses": lm == lo,
            "params": all(torch.equal(a, zo._at(po, p))
                          for p, a in zo.leaves_with_path(pm))}
    dist.destroy_process_group()
    with open(os.path.join(out, "one_rank.json"), "w") as f:
        json.dump(res, f)
