"""The ranks of ``test_torch_mesh_serve.py``: spawned processes, so this
module imports torch and the port only (no JAX, no pytest).

``serve_rank`` joins a gloo group of 4 CPU ranks at a ``file://`` store
and runs every case of ``CASES`` in that one world (each mesh a
``DeviceMesh`` over it): the prefill of a prompt on the case's mesh
(``api.prefill_step(..., run=)``, the prefill shape's rules), the
caches re-laid for the decode shape's rules (``relay``: gathered, the
KV heads de-duplicated where the two plans differ, grown to the decode's
slots, and sharded again), then ``DECODE_STEPS`` decode steps of given
tokens (``api.decode_step(..., run=)``). Each rank writes its rows'
tokens to ``out``/<case>_rank<r>.json; rank 0 writes the global caches,
gathered from the shards, after the prefill and after the last step, to
``out``/<case>.npz.
"""
import json
import os
import sys

import numpy as np
import torch

DATA_MODEL = ("data", "model")
DECODE_STEPS = 2
# name: (arch, mesh shape, strategy, global batch, prompt tokens,
# config overrides). Reduced f32 stacks. At 1x4 the reduced KV 2 takes
# kv_dup 2 under the tp plan; 6 Q heads over 2 KV heads take the seq
# plan at 1x4; a global batch of 1 below the 2 `data` ranks splits the
# decode cache's slots over `data` (cache_seq_axes); Mixtral's window of
# 8 below the 16-token prompt makes a ring of 8 slots.
CASES = {
    "qwen3_tp_dup2": ("qwen3-4b", (1, 4), "tp", 2, 16, {}),
    "qwen3_serve": ("qwen3-4b", (2, 2), "serve", 2, 16, {}),
    "qwen3_cp_data": ("qwen3-4b", (2, 2), "tp", 1, 16, {}),
    "qwen3_seq": ("qwen3-4b", (1, 4), "tp", 2, 16,
                  {"num_heads": 6, "num_kv_heads": 2}),
    "mixtral_serve_ring": ("mixtral-8x7b", (2, 2), "serve", 2, 16,
                           {"sliding_window": 8}),
    "mixtral_cp_ring": ("mixtral-8x7b", (2, 2), "tp", 1, 16,
                        {"sliding_window": 8}),
    "mixtral_seq_ring": ("mixtral-8x7b", (1, 4), "tp", 2, 16,
                         {"sliding_window": 8, "num_heads": 6,
                          "num_kv_heads": 2}),
    "mixtral_fsdp": ("mixtral-8x7b", (2, 2), "fsdp", 4, 16, {}),
    "rwkv_tp": ("rwkv6-1.6b", (2, 2), "tp", 2, 16, {}),
    "jamba_serve": ("jamba-v0.1-52b", (2, 2), "serve", 2, 16, {}),
    "whisper_serve": ("whisper-small", (2, 2), "serve", 2, 16, {}),
    "llava_tp": ("llava-next-34b", (2, 2), "tp", 2, 16, {}),
}


def cfg_of(arch, overrides):
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS[arch], dtype="float32", **overrides)


def lane_of():
    from repro_torch.configs import LaneConfig
    return LaneConfig(lane="elastic_zo", bp_tail_layers=1, zo_num_probes=1)


def shapes_of(cfg, B, S):
    """(prefill shape, decode shape): the prefill's length counts the
    image tokens; the decode's holds DECODE_STEPS more."""
    from repro_torch.configs import ShapeConfig
    total = S + cfg.num_image_tokens
    return (ShapeConfig("p", seq_len=total, global_batch=B, kind="prefill"),
            ShapeConfig("d", seq_len=total + DECODE_STEPS, global_batch=B,
                        kind="decode"))


def inputs_of(cfg, B, S, seed=0):
    """numpy prompt tokens [B, S], decode tokens [B, DECODE_STEPS] and
    Whisper's frames / LLaVA's image embeddings, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "decode": rng.integers(0, cfg.vocab_size,
                                  (B, DECODE_STEPS)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        out["img"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def init_name(arch, overrides):
    return "init_" + arch + "".join(f"_{k}{v}" for k, v in
                                    sorted(overrides.items()))


def load_params(path, cfg, max_seq):
    """The init saved by the test (npz keyed by keystr) as a tree."""
    from repro_torch.core import api, zo
    z = np.load(path)
    template = api.abstract_params(cfg, lane_of(), max_seq=max_seq)
    return zo.map_with_path(
        lambda p, _t: torch.from_numpy(z[zo.keystr(p)].copy()), template)


def kv_dup(run):
    plan = run.rules.attn
    return plan.kv_dup if plan.kind == "tp" else 1


def gathered(run, caches, shape):
    """The global caches from every rank's shards (all ranks call it)."""
    from repro_torch.core import api
    from repro_torch.models.transformer import tree_map
    abstract = api.abstract_caches(run.rules.cfg, shape, lane_of(), run)
    descs = [run.cache_descs(abstract, r) for r in range(run.world)]
    return tree_map(lambda t, *ds: run.gather_shards(t, list(ds)), caches,
                    *descs)


def relay(whole, cfg, dup_from, dup_to, slots):
    """Global prefill caches re-laid for a decode: each KV leaf's heads
    from KV * ``dup_from`` to KV * ``dup_to`` (head j reads KV head j //
    dup), the self-attention's grown to ``slots`` (zeros past the
    prompt)."""
    import torch.nn.functional as F
    from repro_torch.sharding.params import map_with_names
    idx = [(j // dup_to) * dup_from for j in range(cfg.num_kv_heads * dup_to)]

    def fix(names, t):
        if names[-1] in ("k", "v", "ck", "cv"):
            t = t[..., idx, :]
        if names[-1] in ("k", "v") and t.shape[2] < slots:
            t = F.pad(t, (0, 0, 0, 0, 0, slots - t.shape[2]))
        return t.contiguous()
    return map_with_names(fix, whole)


def shard(run, whole, shape):
    """The rank's shards of global caches laid out for ``run``'s rules."""
    from repro_torch.core import api
    from repro_torch.models.transformer import tree_map
    from repro_torch.sharding.params import shard_leaf
    descs = run.cache_descs(api.abstract_caches(run.rules.cfg, shape,
                                                lane_of(), run))
    return tree_map(lambda t, d: shard_leaf(t, d).clone(), whole, descs)


def flat(caches):
    """{name: array} of a cache tree ({"zo", "bp"} of per-position
    dicts)."""
    out = {}
    for part, entries in caches.items():
        for j, e in enumerate(entries):
            for k, t in e.items():
                out[f"{part}/{j}/{k}"] = t.detach().numpy()
    return out


def run_case(name, mesh, params, out):
    """One case on this rank: prefill, re-lay, decode steps."""
    from repro_torch.core import api
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.models.transformer import tree_map
    from repro_torch.sharding.collectives import MeshRun
    from repro_torch.sharding.params import shard_leaf
    from repro_torch.sharding.rules import ShardingRules
    arch, _, strategy, B, S, overrides = CASES[name]
    cfg = cfg_of(arch, overrides)
    sp, sd = shapes_of(cfg, B, S)
    data = inputs_of(cfg, B, S)
    runs = {}
    for kind, shape in (("prefill", sp), ("decode", sd)):
        runs[kind] = MeshRun(mesh, ShardingRules(mesh, cfg, shape, strategy),
                             api.abstract_params(cfg, lane_of(),
                                                 max_seq=sd.seq_len))
    rp, rd = runs["prefill"], runs["decode"]
    rows = rank_rows(sp, rp.rules, rp.coords)
    extra = {k: torch.from_numpy(data[k][rows]) for k in ("frames", "img")
             if k in data}
    pp = tree_map(lambda t, d: shard_leaf(t, d).clone(), params, rp.descs)
    tok, caches = api.prefill_step(pp, cfg, torch.from_numpy(
        data["tokens"][rows]), run=rp, **extra)
    toks = {"prefill": [rows.start, rows.stop, tok[:, 0].tolist()]}
    whole = gathered(rp, caches, sp)
    prefill_caches = flat(whole)
    del pp, caches
    pd = tree_map(lambda t, d: shard_leaf(t, d).clone(), params, rd.descs)
    caches = shard(rd, relay(whole, cfg, kv_dup(rp), kv_dup(rd),
                             rd.decode_slots()), sd)
    rows_d = rank_rows(sd, rd.rules, rd.coords)
    for i in range(DECODE_STEPS):
        tok, caches = api.decode_step(
            pd, cfg, torch.from_numpy(data["decode"][rows_d, i:i + 1]),
            caches, sp.seq_len + i, run=rd)
        toks[f"decode{i}"] = [rows_d.start, rows_d.stop, tok[:, 0].tolist()]
    final = flat(gathered(rd, caches, sd))
    meta = {"tokens": toks, "plans": [rp.rules.attn.kind, rd.rules.attn.kind],
            "dup": [kv_dup(rp), kv_dup(rd)], "moe": rd.rules.moe,
            "cache_seq_axes": list(rd.rules.cache_seq_axes),
            "batch_axes": list(rd.batch_axes)}
    with open(os.path.join(out, f"{name}_rank{rp.rank}.json"), "w") as f:
        json.dump(meta, f)
    if rp.rank == 0:
        np.savez(os.path.join(out, f"{name}.npz"),
                 **{f"prefill:{k}": v for k, v in prefill_caches.items()},
                 **{f"decode:{k}": v for k, v in final.items()})


def serve_rank(rank, store, out):
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_ranks("gloo", "cpu", rank, 4, store)
    try:
        meshes = {}
        for name, (arch, shape, _, B, S, overrides) in CASES.items():
            if shape not in meshes:
                meshes[shape] = mesh_lib.make_mesh(shape, DATA_MODEL)
            cfg = cfg_of(arch, overrides)
            params = load_params(os.path.join(
                out, init_name(arch, overrides) + ".npz"), cfg,
                shapes_of(cfg, B, S)[1].seq_len)
            run_case(name, meshes[shape], params, out)
    finally:
        dist.destroy_process_group()

