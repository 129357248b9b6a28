"""Dry run: a step of every (arch x shape x mesh) cell on the production
mesh, without its ranks, counted as it runs.

The port's twin of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell on 512 forced CPU host devices and reads XLA's cost
and memory analyses and the post-SPMD HLO. Eager PyTorch has no
compiled program to read, so this is a cost model built from torch's own
means: this process joins a fake process group as rank 0 of the
production world (``launch/mesh.py::fake_world``: 16x16 ranks, or
2x16x16 with the `pod` axis), builds the rules, the ``MeshRun`` and rank
0's shards on ``meta`` tensors, and runs the step that ``launch/train.py
--mesh`` runs (``train/elastic_runtime.py::build_for_mesh``, the
engine's ``make_step`` of ``core/api.py::train_engine``) once, on rank
0's rows of the batch, under three counters:

  * ``OpCounter``: the FLOPs of each aten op by ``torch.utils.
    flop_counter``'s registry (the products), split by dtype, and the
    bytes each op reads and writes (views and allocations 0);
  * the cost counter (``kernels/cost.py``): each kernel launch with its
    FLOPs, bytes and bound, and each collective with its group and the
    bytes it moves a rank (``kernels/cost.py::bytes_moved``), summed
    by ``launch/comm_analysis.py``;
  * ``obs/memory.py::meta_footprint``: the storages' lifetimes.

Eager execution runs every layer, so the counts at full depth are exact:
the reference's depth-2 / depth-4 variants (``--no-depth-variants``,
``--update-depth``), which extrapolate XLA's once-counted scan bodies,
have nothing to correct here and are not ported. Rank 0 stands for
every rank: the ranks of a mesh run the same code on shards of one
shape (``tests/test_torch_dryrun.py`` holds the last rank's counts to
rank 0's). ``MeshRun``'s replica checks read values, which ``meta``
tensors have none of: the step's check of the coefficients gathers but
does not compare, and ``check_replicas`` is not called.

The prefill and decode cells run the serving steps the same way
(``analyze_serve``): rank 0's ``core/api.py::prefill_step`` on its rows
of the tokens (and of Whisper's frames and LLaVA's image embeddings), or
its ``decode_step`` of one token a row against its shards of the caches
(``MeshRun.cache_descs`` of ``api.abstract_caches``: the ``serve``
strategy's ``seq`` plan context-shards them over `model`, and
``long_500k``'s batch of 1 over `data`, the rules' ``cache_seq_axes``),
with the caches donated to ``meta_footprint`` as the reference donates
argument 2. A decode runs at ``cache_len = seq_len - 1`` (the record's
``cache_len``), so the whole cache is attended.

Every time written is a bound at the H100 SXM's published peaks (700 W;
``kernels/cost.py``), not a measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch

from ..configs import LaneConfig, cell_matrix, get_arch, get_shape
from ..core import api
from ..kernels import cost
from ..obs.memory import meta_footprint, tree_tensors
from .comm_analysis import collective_bytes, summarize
from .mesh import fake_world, make_production_mesh, production_shape

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# ops that allocate and write nothing
_NO_BYTES = ("empty", "new_empty", "empty_like", "empty_strided")


class OpCounter:
    """A dispatch mode that counts, over the aten ops of the code inside
    on device tensors: FLOPs by ``torch.utils.flop_counter.flop_registry``
    (keyed by the dtype of the op's first tensor input) and the bytes of
    every tensor input and output of an op (views, ``empty`` and CPU
    tensors 0). Collectives are not ops here: the cost counter has
    them."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if func.namespace != "aten":
                    return out
                packet = func._overloadpacket
                ins = [t for t in tree_tensors((args, kwargs))
                       if t.device.type != "cpu"]
                if packet in flop_registry:
                    dt = str(ins[0].dtype if ins else "unknown").replace(
                        "torch.", "")
                    counter.flops[dt] += flop_registry[packet](
                        *args, **kwargs, out_val=out)
                if func.is_view or packet.__name__ in _NO_BYTES:
                    return out
                outs = [t for t in tree_tensors(out)
                        if t.device.type != "cpu"]
                counter.bytes += sum(t.numel() * t.element_size()
                                     for t in ins + outs)
                return out
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def rank_inputs(cfg, shape, lane: LaneConfig, run=None):
    """(batch, probe_mask) of the rank's rows of ``shape``: meta tensors
    of each entry's local shape (``api.batch_shardings``' rows), and the
    host probe mask of a train shape (None for prefill and decode)."""
    from ..sharding.collectives import rows_slice
    specs = api.input_specs(cfg, shape, lane)
    pm = specs.pop("probe_mask", None)
    if run is None:
        return specs, pm
    sh = api.batch_shardings(specs, run.rules)
    out = {}
    for k, t in specs.items():
        if not t.dim():                          # decode's cache_len
            out[k] = t
            continue
        rows = rows_slice(t.shape[0], sh[k][0], run.coords, run.sizes)
        out[k] = torch.empty((rows.stop - rows.start,) + tuple(t.shape[1:]),
                             dtype=t.dtype, device="meta")
    return out, pm


def analyze_step(cfg, shape, lane: LaneConfig, mesh=None,
                 strategy: str = "tp") -> Dict:
    """One train step of ``cfg`` at ``shape`` on ``mesh`` (a mesh over
    the fake world this process is a rank of, or None for one device),
    run on ``meta`` tensors under the counters: the record's ``full``
    entry, plus ``"records"`` (the cost counter's collective records in
    call order) and ``"rules"`` (None without a mesh)."""
    from ..train.elastic_runtime import build_for_mesh
    from ..train.train_loop import init_state
    model, step = build_for_mesh(cfg, shape, lane, mesh, strategy)
    run = model.run
    params = api.init(cfg, lane, seed=0, device="meta",
                      max_seq=shape.seq_len, run=run)
    batch, pm = rank_inputs(cfg, shape, lane, run)
    state = init_state(params, 0)
    del params
    with cost.counting() as counter, OpCounter() as ops:
        mem = meta_footprint(step, state, batch, pm, donate_argnums=(0,))
    return _summary(counter, ops, mem, run)


def analyze_serve(cfg, shape, lane: LaneConfig, mesh=None,
                  strategy: str = "tp") -> Dict:
    """One serving step of ``cfg`` at a prefill or decode ``shape`` on
    ``mesh`` (as ``analyze_step``), on ``meta`` tensors under the three
    counters: rank 0's ``api.prefill_step`` of its rows of the inputs,
    or its ``api.decode_step`` of one token a row at ``cache_len =
    seq_len - 1`` against its shards of the caches
    (``make_caches(..., run=)``), donated. The same keys as
    ``analyze_step``, and ``"cache_len"`` for a decode."""
    from ..models.transformer import make_caches
    run = api.mesh_run(cfg, shape, lane, mesh, strategy)
    params = api.init(cfg, lane, seed=0, device="meta",
                      max_seq=shape.seq_len, run=run)
    batch, _ = rank_inputs(cfg, shape, lane, run)
    if shape.kind == "decode":
        cache_len = shape.seq_len - 1
        caches = api.split_caches(make_caches(
            cfg, shape.global_batch, shape.seq_len, device="meta", run=run),
            cfg, lane)
    with cost.counting() as counter, OpCounter() as ops:
        if shape.kind == "prefill":
            mem = meta_footprint(
                lambda p, b: api.prefill_step(
                    p, cfg, b["tokens"], b.get("frames"), b.get("img"),
                    run=run), params, batch)
        else:
            mem = meta_footprint(
                lambda p, t, c: api.decode_step(p, cfg, t, c, cache_len,
                                                run=run),
                params, batch["tokens"], caches, donate_argnums=(2,))
    out = _summary(counter, ops, mem, run)
    if shape.kind == "decode":
        out["cache_len"] = cache_len
    return out


def analyze(cfg, shape, lane: LaneConfig, mesh=None,
            strategy: str = "tp") -> Dict:
    """``analyze_step`` of a train shape, ``analyze_serve`` of a
    prefill or decode one."""
    fn = analyze_step if shape.kind == "train" else analyze_serve
    return fn(cfg, shape, lane, mesh, strategy)


def _summary(counter, ops, mem, run) -> Dict:
    """A step's record from its counters (``analyze_step``)."""
    total, coll = collective_bytes(counter.collectives)
    groups: Dict[tuple, Dict] = {}
    for o in coll:
        g = groups.setdefault((o.kind, o.ranks), {"count": 0, "bytes": 0.0})
        g["count"] += 1
        g["bytes"] += o.bytes_moved
    kernels: Dict[str, Dict] = {}
    for r in counter.launches:
        k = kernels.setdefault(r.name, {"launches": 0, "flops": 0.0,
                                        "bytes": 0.0, "bound_s": 0.0,
                                        "ops_bound_s": 0.0})
        k["launches"] += 1
        k["flops"] += r.cost.flops
        k["bytes"] += r.cost.bytes
        k["bound_s"] += r.cost.bound_s
        if r.cost.bound_by == "operations":
            k["ops_bound_s"] += r.cost.bound_s
    flops_by_dtype = dict(ops.flops)
    return {
        "flops": sum(flops_by_dtype.values()) + sum(
            k["flops"] for k in kernels.values()),
        "flops_by_dtype": flops_by_dtype,
        "bytes_accessed": ops.bytes + sum(k["bytes"]
                                          for k in kernels.values()),
        "memory": mem,
        "collective_bytes": total,
        "collectives": summarize(coll),
        "collective_groups": [{"kind": kind, "ranks": list(ranks), **v}
                              for (kind, ranks), v in groups.items()],
        "kernels": kernels,
        "records": counter.collectives,
        "rules": None if run is None else run.rules,
    }


def out_name(arch: str, shape_name: str, mesh_kind: str, strategy: str,
             fused: bool) -> str:
    suffix = "" if strategy == "tp" else f"+{strategy}"
    if fused:
        suffix += "+fused"
    return f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"


def run_cell(arch: str, shape_name: str, mesh_kind: str, lane: LaneConfig,
             out_dir: Path, force: bool = False, strategy: str = "tp"):
    """The record of one cell, written to ``out_dir`` (read back from
    there unless ``force``)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    out = out_dir / out_name(arch, shape_name, mesh_kind, strategy,
                             lane.fused_probes)
    if out.exists() and not force:
        return json.loads(out.read_text())
    t0 = time.perf_counter()
    dims, axes = production_shape(multi_pod=(mesh_kind == "multi"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "strategy": strategy, "mesh_shape": dict(zip(axes, dims)),
           "lane": lane.lane, "status": "ok"}
    try:
        world = 1
        for d in dims:
            world *= d
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
            full = analyze(cfg, shape, lane, mesh, strategy)
        rules = full.pop("rules")
        full.pop("records")
        if "cache_len" in full:
            rec["cache_len"] = full.pop("cache_len")
        rec["full"] = full
        rec["attn_plan"] = dataclasses.asdict(rules.attn)
        rec["moe_plan"] = rules.moe
        rec["cache_seq_axes"] = list(rules.cache_seq_axes)
    except Exception as e:  # noqa: BLE001 - record the failure, go on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
    rec["elapsed_s"] = round(time.perf_counter() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def _line(rec) -> str:
    full = rec["full"]
    by_kind = ", ".join(f"{k} {v['bytes']:.3e}"
                        for k, v in full["collectives"].items())
    return (f"flops/dev={full['flops']:.3e} bytes/dev="
            f"{full['bytes_accessed']:.3e} coll/dev="
            f"{full['collective_bytes']:.3e}B ({by_kind or 'none'}) "
            f"peak={full['memory']['peak_bytes']:.3e}B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--lane", default="elastic_zo")
    ap.add_argument("--strategy", default="tp",
                    choices=["tp", "fsdp", "serve"])
    ap.add_argument("--fused", action="store_true",
                    help="fused antithetic-pair forward")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    lane = LaneConfig(lane=args.lane, fused_probes=args.fused)
    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        for a, s, run, why in cell_matrix():
            if run:
                cells.append((a, s))
            else:
                print(f"SKIP {a} x {s}: {why}")
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    # small cells first for early signal
    def cell_cost(c):
        cfg, sh = get_arch(c[0]), get_shape(c[1])
        return cfg.param_count() * (sh.seq_len if sh.kind != "decode" else 1)
    cells.sort(key=cell_cost)

    failures = 0
    for a, s in cells:
        for mk in meshes:
            rec = run_cell(a, s, mk, lane, out_dir, force=args.force,
                           strategy=args.strategy)
            st = rec["status"]
            if st != "ok":
                failures += 1
                print(f"FAIL {a} x {s} x {mk}: {rec.get('error')}",
                      flush=True)
            else:
                print(f"OK   {a} x {s} x {mk}: {_line(rec)} "
                      f"({rec['elapsed_s']}s)", flush=True)
    print(f"\ndone; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
