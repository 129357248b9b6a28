"""The ranks of ``test_torch_dryrun.py``: spawned processes, so this
module imports torch and the port only (no JAX, no pytest).

``dryrun_rank`` joins a gloo group of 4 CPU ranks at a ``file://`` store
and runs one train step of each case of ``CASES`` on a 2x2 mesh over
that world, from the sharded init of seed 0 and the launcher's batch
rows, under a cost counter (``kernels/cost.py``); it writes the step's
collective records (kind, group ranks, output bytes, bytes moved) and
kernel launches to ``out``/rank<r>.json.
"""
import json
import os
import sys

import numpy as np
import torch

# name: (arch, strategy, global batch, seq): reduced f32 stacks on 2x2
# (data, model); Mixtral's 4 experts take the ep plan, and its fsdp case
# at batch 4 puts the rows over (data, model), so the MoE's dispatch
# all-to-all runs
CASES = {
    "tp": ("qwen3-4b", "tp", 2, 16),
    "fsdp": ("qwen3-4b", "fsdp", 4, 16),
    "serve": ("qwen3-4b", "serve", 2, 16),
    "moe_ep": ("mixtral-8x7b", "fsdp", 4, 16),
}
MESH = ((2, 2), ("data", "model"))


def cfg_of(arch):
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS[arch], dtype="float32")


def shape_of(batch, seq):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")


def lane_of():
    from repro_torch.configs import LaneConfig
    return LaneConfig(lane="elastic_zo", bp_tail_layers=1, zo_num_probes=1)


def record(r):
    return [r.kind, list(r.ranks), r.out_bytes, r.bytes_moved]


def dryrun_rank(rank, store, out):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.core import api
    from repro_torch.core.elastic import TrainState
    from repro_torch.core import keys
    from repro_torch.data.pipeline import lm_batch_fn, rank_rows
    from repro_torch.kernels import cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train.elastic_runtime import build_for_mesh
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    try:
        mesh = mesh_lib.make_mesh(*MESH)
        res = {}
        for name, (arch, strategy, B, S) in CASES.items():
            cfg, shape, lane = cfg_of(arch), shape_of(B, S), lane_of()
            model, step = build_for_mesh(cfg, shape, lane, mesh, strategy)
            run = model.run
            params = api.init(cfg, lane, seed=0, device="cpu", max_seq=S,
                              run=run)
            rows = rank_rows(shape, run.rules, run.coords)
            batch = {k: torch.from_numpy(v) for k, v in
                     lm_batch_fn(cfg, shape, seed=1, rows=rows)(0).items()}
            state = TrainState(params, 0, keys.key_data(0))
            with cost.counting() as counter:
                step(state, batch, np.ones(1, np.float32))
            res[name] = {"records": [record(r) for r in counter.collectives],
                         "launches": counter.launch_counts()}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
