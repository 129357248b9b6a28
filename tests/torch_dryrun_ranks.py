"""The ranks of ``test_torch_dryrun.py``: spawned processes, so this
module imports torch and the port only (no JAX, no pytest).

``dryrun_rank`` joins a gloo group of 4 CPU ranks at a ``file://`` store
and runs one train step of each case of ``CASES`` on a 2x2 mesh over
that world, from the sharded init of seed 0 and the launcher's batch
rows, then one serving step of each case of ``SERVE_CASES`` (a prefill
of the rank's rows, or a decode of one token a row against zero caches
at ``cache_len = seq - 1``, as the dry run runs it), each under a cost
counter (``kernels/cost.py``); it writes each step's collective records
(kind, group ranks, output bytes, bytes moved) and kernel launches to
``out``/rank<r>.json, with ``attend_combine``'s largest distance from
the whole attention when the keys are split over `data` and over
(`data`, `model`) (``combine_check``).
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
# name: (arch, strategy, global batch, seq, kind): serving steps of
# reduced f32 stacks on 2x2. The serve strategy's decode takes the seq
# plan (the cache's slots over `model`; Whisper's ck / cv too, through
# flash's log-sum-exp); a batch of 1 splits the slots over `data`
# (Mixtral's window of 16 a ring below the 18 slots); fsdp at 4 rows
# puts them over (data, model), so the MoE's dispatch all-to-all runs.
SERVE_CASES = {
    "prefill_tp": ("qwen3-4b", "tp", 2, 16, "prefill"),
    "prefill_whisper": ("whisper-small", "serve", 2, 16, "prefill"),
    "decode_serve": ("qwen3-4b", "serve", 2, 18, "decode"),
    "decode_context": ("mixtral-8x7b", "tp", 1, 18, "decode"),
    "decode_whisper": ("whisper-small", "serve", 2, 18, "decode"),
    "decode_moe_fsdp": ("mixtral-8x7b", "fsdp", 4, 18, "decode"),
}
MESH = ((2, 2), ("data", "model"))


def cfg_of(arch):
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS[arch], dtype="float32")


def shape_of(batch, seq, kind="train"):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("t", seq_len=seq, global_batch=batch, kind=kind)


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
        for name, (arch, strategy, B, S, kind) in SERVE_CASES.items():
            res[name] = serve_step(arch, strategy, B, S, kind, mesh)
        res["combine"] = combine_check(mesh)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def serve_step(arch, strategy, B, S, kind, mesh):
    """One prefill or decode step of a ``SERVE_CASES`` case on this rank,
    as ``launch/dryrun.py::analyze_serve`` runs it, on real tensors:
    its collective records and launches."""
    from repro_torch.core import api
    from repro_torch.kernels import cost
    from repro_torch.models.transformer import make_caches
    from repro_torch.sharding.collectives import rows_slice
    cfg, lane, shape = cfg_of(arch), lane_of(), shape_of(B, S, kind)
    run = api.mesh_run(cfg, shape, lane, mesh, strategy)
    params = api.init(cfg, lane, seed=0, device="cpu", max_seq=S, run=run)
    specs = api.input_specs(cfg, shape, lane)
    sh = api.batch_shardings(specs, run.rules)
    rng = np.random.default_rng(1)
    batch = {}
    for k, t in specs.items():
        if not t.dim():
            continue
        rows = rows_slice(t.shape[0], sh[k][0], run.coords, run.sizes)
        dims = (rows.stop - rows.start,) + tuple(t.shape[1:])
        batch[k] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, dims).astype(np.int32)
            if t.dtype == torch.int32 else
            rng.standard_normal(dims).astype(np.float32))
    with cost.counting() as counter:
        if kind == "prefill":
            api.prefill_step(params, cfg, batch["tokens"],
                             batch.get("frames"), batch.get("img"), run=run)
        else:
            caches = api.split_caches(make_caches(cfg, B, S, device="cpu",
                                                  run=run), cfg, lane)
            api.decode_step(params, cfg, batch["tokens"], caches, S - 1,
                            run=run)
    return {"records": [record(r) for r in counter.collectives],
            "launches": counter.launch_counts()}


def combine_check(mesh):
    """``attend_combine`` of the partial attentions over this rank's
    share of 12 keys, split over `data` (2 shares) and over (`data`,
    `model`) (4), against the whole softmax attention: the largest
    distance of each."""
    from repro_torch.models.layers import _attend_partial
    from repro_torch.sharding.collectives import attend_combine
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 2, 3, 16, generator=g)
    k = torch.randn(2, 12, 2, 16, generator=g) * 3
    v = torch.randn(2, 12, 2, 16, generator=g)
    mask = torch.ones(1, 1, 12, dtype=torch.bool)
    mask[..., 7] = False                           # a slot past cache_len
    s = torch.einsum("bskgh,btkh->bskgt", q, k) * 0.25
    s = s.masked_fill(~mask[:, :, None, None, :], -1e30)
    whole = torch.einsum("bskgt,btkh->bskgh", torch.softmax(s, -1), v)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    out = {}
    for label, n, i, groups in (
            ("data", 2, d, [mesh.get_group("data")]),
            ("data_model", 4, d * 2 + m,
             [mesh.get_group("data"), mesh.get_group("model")])):
        c = 12 // n
        sl = slice(i * c, (i + 1) * c)
        o, mx, l = _attend_partial(q, k[:, sl], v[:, sl], mask[..., sl],
                                   0.25)
        out[label] = float((attend_combine(o, mx, l, groups)
                            - whole).abs().max())
    return out
