"""The ranks of ``test_torch_mesh.py``: spawned processes, so this module
imports torch and the port only (no JAX, no pytest).

``mesh_rank`` joins a gloo group of 4 CPU ranks at a ``file://`` store
and runs every sharded case of the test module in that one world (each
mesh is a ``DeviceMesh`` over it), writing what the tests compare to
``out``/<case>.npz or .json: rank 0 writes the global leaves, gathered
from the shards, and every rank its losses.
"""
import json
import os
import sys

import numpy as np
import torch

LANES = ("elastic_zo", "full_bp")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
STEPS = 2
BATCH, SEQ = 2, 16


def _cfg():
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS["qwen3-4b"], dtype="float32")


def _shape():
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")


def _lane(name):
    from repro_torch.configs import LaneConfig
    return LaneConfig(lane=name, bp_tail_layers=1, zo_num_probes=1)


def load_params(path, device="cpu"):
    """The init saved by the test (npz keyed by keystr) as a tree."""
    from repro_torch.core import api, zo
    z = np.load(path)
    template = api.abstract_params(_cfg(), _lane("elastic_zo"), max_seq=SEQ)
    return zo.map_with_path(
        lambda p, _t: torch.from_numpy(z[zo.keystr(p)].copy()).to(device),
        template)


def _gathered(run, params):
    from repro_torch.core import zo
    return {zo.keystr(p): run.gather_leaf(p, t).numpy()
            for p, t in zo.leaves_with_path(params)}


def _steps(run, step_fn, state, cfg, rows, first, last):
    from repro_torch.data.pipeline import lm_batch_fn
    from repro_torch.train.train_loop import LoopConfig
    from repro_torch.train.train_loop import run as loop_run
    fn = lm_batch_fn(cfg, _shape(), seed=1, rows=rows)

    def batch_fn(step):
        return {k: torch.from_numpy(v) for k, v in fn(step).items()}
    loop = LoopConfig(total_steps=last, log_every=1, n_probes=1)
    assert state.step == first
    return loop_run(step_fn, state, batch_fn, loop, log=None,
                    param_shardings=run)


def _build(mesh, lane_name):
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.train.elastic_runtime import build_for_mesh
    model, step_fn = build_for_mesh(_cfg(), _shape(), _lane(lane_name), mesh)
    run = model.run
    return run, step_fn, rank_rows(_shape(), run.rules, run.coords)


def _shard_tree(run, params):
    from repro_torch.core import zo
    from repro_torch.sharding.params import shard_leaf
    return zo.map_with_path(
        lambda p, t: shard_leaf(t, zo._at(run.descs, p)).clone(), params)


def mesh_rank(rank, store, out):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.core import api, keys, zo
    from repro_torch.core.elastic import TrainState
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.compress import compressed_psum, shared_quantise
    from repro_torch.train.elastic_runtime import resume_on_mesh
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    meshes = {k: mesh_lib.make_mesh(v, ("data", "model"))
              for k, v in MESHES.items()}
    init = load_params(os.path.join(out, "init.npz"))
    cfg = _cfg()

    def write(name, arrays=None, meta=None):
        if rank != 0:
            return
        if arrays is not None:
            np.savez(os.path.join(out, name + ".npz"), **arrays)
        if meta is not None:
            with open(os.path.join(out, name + ".json"), "w") as f:
                json.dump(meta, f)

    # 2 steps of each lane on 2x2 and 1x4 from the saved init
    for lane in LANES:
        for name in ("2x2", "1x4"):
            run, step_fn, rows = _build(meshes[name], lane)
            state = TrainState(_shard_tree(run, init), 0, keys.key_data(0))
            state, hist = _steps(run, step_fn, state, cfg, rows, 0, STEPS)
            held = run.check_replicas(state.params)
            write(f"{lane}_{name}", _gathered(run, state.params),
                  {"losses": [h[1] for h in hist], "replica_pairs": held,
                   "kv_dup": run.rules.attn.kv_dup})

    # a checkpoint saved at 2x2 after one step, restored on other meshes
    ck = os.path.join(out, "ckpt")
    run, step_fn, rows = _build(meshes["2x2"], "elastic_zo")
    state = TrainState(_shard_tree(run, init), 0, keys.key_data(0))
    state, _ = _steps(run, step_fn, state, cfg, rows, 0, 1)
    ckpt.save(ck, 1, state.params, run=run)
    template = api.abstract_params(cfg, _lane("elastic_zo"), max_seq=SEQ)
    for name in ("1x4", "4x1"):
        r2, _, _ = _build(meshes[name], "elastic_zo")
        params, at = ckpt.restore(ck, template, device="cpu",
                                  shardings=r2.descs)
        write(f"restored_{name}", _gathered(r2, params), {"step": at})

    # resume_on_mesh at 1x4 from the 2x2 checkpoint, one more step
    state, model, step_fn = resume_on_mesh(
        ck, cfg, _shape(), _lane("elastic_zo"), mesh=meshes["1x4"], seed=0,
        device="cpu")
    from repro_torch.data.pipeline import rank_rows
    rows = rank_rows(_shape(), model.run.rules, model.run.coords)
    state, hist = _steps(model.run, step_fn, state, cfg, rows, 1, STEPS)
    write("resumed_1x4", _gathered(model.run, state.params),
          {"losses": [h[1] for h in hist], "step": state.step})

    # compressed_psum over the world: rank r holds row r of g
    g = np.load(os.path.join(out, "psum_in.npy"))
    gr = {"w": torch.from_numpy(g[rank].copy())}
    rr = {"w": torch.zeros_like(gr["w"])}
    q, scale, _ = shared_quantise(gr["w"], rr["w"])
    avg, new_r = compressed_psum(gr, rr)
    np.savez(os.path.join(out, f"psum_{rank}.npz"), q=q.numpy(),
             scale=scale.numpy(), avg=avg["w"].numpy(),
             new_r=new_r["w"].numpy())
    dist.destroy_process_group()
