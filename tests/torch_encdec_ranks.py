"""The ranks of ``test_torch_mesh_encdec.py``: spawned processes, so this
module imports torch and the port only (no JAX, no pytest).

``encdec_rank`` joins a gloo group of 4 CPU ranks at a ``file://`` store
and runs every case of the test module in that one world (each mesh a
``DeviceMesh`` over it) from the inits and batches the test saved under
``out``, writing what the tests compare to ``out``/<case>.npz or .json:
rank 0 writes the global leaves, gathered from the shards, and every
case's losses. Then rank 0 alone joins a world of one rank and runs both
archs on a 1x1 mesh.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from torch_strategy_ranks import (_gathered, _pair, _shards, lane_of,
                                  run_steps)

WHISPER, LLAVA = "whisper-small", "llava-next-34b"
DATA_MODEL = ("data", "model")
# name: (arch, mesh shape, axes, strategy, global batch, text tokens,
#        (heads, kv heads) or None, encoder_seq or None)
CASES = {
    "whisper_tp": (WHISPER, (2, 2), DATA_MODEL, "tp", 2, 16, None, None),
    "whisper_fsdp_b4": (WHISPER, (2, 2), DATA_MODEL, "fsdp", 4, 16, None,
                        None),
    "whisper_fsdp_b2": (WHISPER, (2, 2), DATA_MODEL, "fsdp", 2, 16, None,
                        None),
    "whisper_serve": (WHISPER, (2, 2), DATA_MODEL, "serve", 2, 16, None,
                      None),
    "whisper_seq_s16": (WHISPER, (1, 4), DATA_MODEL, "tp", 2, 16, (6, 6),
                        18),
    "whisper_seq_s18": (WHISPER, (1, 4), DATA_MODEL, "tp", 2, 18, (6, 6),
                        18),
    "whisper_pod": (WHISPER, (2, 1, 2), ("pod", "data", "model"), "tp", 2,
                    16, None, None),
    "llava_tp": (LLAVA, (2, 2), DATA_MODEL, "tp", 2, 16, None, None),
    "llava_kv_dup": (LLAVA, (1, 4), DATA_MODEL, "tp", 2, 16, None, None),
    "llava_fsdp": (LLAVA, (2, 2), DATA_MODEL, "fsdp", 4, 16, None, None),
    "llava_seq": (LLAVA, (1, 4), DATA_MODEL, "tp", 2, 16, (6, 2), None),
}
# fused probes: the same runs as the named unfused case, fused
FUSED = {f"{c}_fused": c for c in ("whisper_tp", "whisper_fsdp_b4",
                                   "llava_tp", "llava_fsdp")}
LANE_STEPS = {"elastic_zo": 2, "full_bp": 1}
ONE_RANK = {WHISPER: "whisper_tp", LLAVA: "llava_tp"}


def cfg_of(case):
    from repro_torch.configs import ARCHS, reduced
    arch, heads, enc = case[0], case[6], case[7]
    cfg = reduced(ARCHS[arch], dtype="float32")
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    if enc:
        cfg = dataclasses.replace(cfg, encoder_seq=enc)
    return cfg


def seq_len(case):
    """The sequence the positions span: LLaVA's image tokens and the
    text (``ShapeConfig.seq_len``, the rows of a learned pos_embed)."""
    return case[5] + cfg_of(case).num_image_tokens


def shape_of(case):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=seq_len(case), global_batch=case[4],
                       kind="train")


def init_name(case):
    """One init per config and sequence: the arch, heads, encoder_seq
    and the rows of pos_embed."""
    arch, heads, enc = case[0], case[6], case[7]
    h = "" if heads is None else f"_h{heads[0]}_{heads[1]}"
    e = "" if enc is None else f"_e{enc}"
    return f"init_{arch}{h}{e}_s{seq_len(case)}"


def batch_name(case, step):
    return f"batch_{case[0]}_b{case[4]}_s{case[5]}_e{case[7]}_{step}"


def make_batch(case, step):
    """The global batch of ``step``: the synthetic tokens (seed 1), and
    random frames / image embeddings from a numpy seed (the launcher's
    are zeros, in which a row-slicing fault would not show)."""
    from repro_torch.data.pipeline import lm_batch_fn
    cfg = cfg_of(case)
    b = lm_batch_fn(cfg, shape_of(case), seed=1)(step)
    rng = np.random.default_rng(1000 + step)
    for k in ("frames", "img"):
        if k in b:
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32)
    return b


def load_params(path, case, device="cpu"):
    """The init saved by the test (npz keyed by keystr) as a tree."""
    from repro_torch.core import api, zo
    z = np.load(path)
    template = api.abstract_params(cfg_of(case), lane_of("elastic_zo"),
                                   max_seq=seq_len(case))
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
    _, shape, axes, strat = case[:4]
    model, step_fn = build_for_mesh(cfg_of(case), shape_of(case), lane,
                                    meshes[(shape, axes)],
                                    strategy or strat)
    run = model.run
    return model, step_fn, rank_rows(shape_of(case), run.rules, run.coords)


def encdec_rank(rank, store, out):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding.params import shard_leaf
    from repro_torch.train import checkpoint as ckpt
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    meshes = {}
    for _, shape, axes, *_ in CASES.values():
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

    # every case: 2 elastic_zo steps, 1 full_bp step
    for name, case in CASES.items():
        for lane_name, steps in LANE_STEPS.items():
            model, step_fn, rows = _build(case, lane_of(lane_name), meshes)
            run = model.run
            losses, params = run_steps(step_fn, _shards(run, init(case)),
                                       batches(out, case, steps, rows))
            write(f"{name}_{lane_name}", _gathered(run, params),
                  {"losses": losses, "attn": run.rules.attn.kind,
                   "kv_dup": run.rules.attn.kv_dup,
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
    # every shard, the encoder's included, bytes-equal to its leaf's slice
    ck = os.path.join(out, "ckpt")
    case = CASES["whisper_tp"]
    model, step_fn, rows = _build(case, lane_of("elastic_zo"), meshes)
    _, params = run_steps(step_fn, _shards(model.run, init(case)),
                          batches(out, case, 1, rows))
    ckpt.save(ck, 1, params, run=model.run)
    template = api.abstract_params(cfg_of(case), lane_of("elastic_zo"),
                                   max_seq=seq_len(case))
    whole, _ = ckpt.restore(ck, template, device="cpu")
    m2, _, _ = _build(case, lane_of("elastic_zo"), meshes, "fsdp")
    got, at = ckpt.restore(ck, template, device="cpu",
                           shardings=m2.run.descs)
    same = {zo.keystr(p): bool(torch.equal(
        t, shard_leaf(zo._at(whole, p), zo._at(m2.run.descs, p))))
        for p, t in zo.leaves_with_path(got)}
    sharded = sorted(zo.keystr(p) for p, _ in zo.leaves_with_path(got)
                     if not zo._at(m2.run.descs, p).whole)
    mine = [all(same.values()), sorted(same), sharded, at]
    every = [None] * 4
    dist.all_gather_object(every, mine)
    write("restored_fsdp", meta={"ranks": every})
    dist.destroy_process_group()

    # a world of one rank: each arch on a 1x1 mesh
    if rank == 0:
        one_rank_world(store + "_one", out, init)


def one_rank_world(store, out, init):
    """2 elastic_zo and 1 full_bp steps of each arch on a 1x1 mesh, and
    of one device, from the same init: whether each is bitwise."""
    import torch.distributed as dist
    from repro_torch.core import api, zo
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_ranks("gloo", "cpu", 0, 1, store)
    meshes = {((1, 1), DATA_MODEL): mesh_lib.make_mesh((1, 1), DATA_MODEL)}
    res = {}
    for arch, base in ONE_RANK.items():
        case = (arch, (1, 1), DATA_MODEL) + CASES[base][3:]
        for lane_name, steps in LANE_STEPS.items():
            lane = lane_of(lane_name)
            model, step_fn, rows = _build(case, lane, meshes)
            bl = batches(out, case, steps, rows)
            copy = zo.map_with_path(lambda p, t: t.clone(), init(case))
            lm, pm = run_steps(step_fn, copy, bl)
            copy = zo.map_with_path(lambda p, t: t.clone(), init(case))
            lo, po = run_steps(api.make_train_step(cfg_of(case), lane), copy,
                               bl)
            res[f"{arch}_{lane_name}"] = {
                "losses": lm == lo,
                "params": all(torch.equal(a, zo._at(po, p))
                              for p, a in zo.leaves_with_path(pm))}
    dist.destroy_process_group()
    with open(os.path.join(out, "one_rank.json"), "w") as f:
        json.dump(res, f)
