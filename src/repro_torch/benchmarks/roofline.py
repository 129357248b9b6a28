"""Roofline over the dry-run records, at the H100's published peaks.

The port's twin of the root ``benchmarks/roofline.py``. Per (arch x
shape x mesh) cell of ``launch/dryrun.py`` (results/dryrun_torch/),
per device:
  compute term    = the aten ops' FLOPs by dtype over the card's peak
                    for that dtype, plus the kernels' operation-bound
                    time (``kernels/cost.py``);
  memory term     = bytes accessed (the aten ops' and the kernels') over
                    the card's memory rate;
  collective term = each collective's bytes over the link its group
                    crosses: NVLink within one 8-card host (ranks in
                    row-major order, ranks // 8 the host), else one
                    400 Gb/s NDR port a card, as in a DGX H100;
  MODEL_FLOPS     = the analytic ideal (the reference's formula), and
                    its ratio to the counted FLOPs.

Every term is a bound at published peaks, not a measurement. The
reference halves XLA:CPU's bytes and collective bytes (its bf16 payloads
carried as f32 in the compiled HLO); the port counts each tensor's real
dtype, so nothing is halved.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

from ..configs import LaneConfig, get_arch, get_shape
from ..core.api import tail_periods
from ..kernels import cost

# H100 SXM at 700 W: dense peaks of NVIDIA's H100 datasheet
# (kernels/cost.py), and the links of a DGX
# H100: NVLink 4 at 450 GB/s each way a card, one 400 Gb/s NDR
# InfiniBand port a card (50 GB/s)
PEAK_FLOPS = cost.PEAK_OPS_PER_S[torch.bfloat16]        # 989e12
HBM_BW = cost.HBM_BYTES_PER_S                            # 3.35e12
NVLINK_BW = 450e9
NDR_BW = 50e9
HOST_CARDS = 8
CARD_BYTES = 80e9            # an H100 SXM's device memory
RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops_per_device(arch: str, shape_name: str, n_devices: int,
                           lane: Optional[LaneConfig] = None) -> Dict[str, float]:
    """Analytic ideal FLOPs for one step, per device (formulas in §Roofline)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    lane = lane or LaneConfig()
    N = cfg.param_count(active_only=True)
    N_tot = cfg.param_count(active_only=False)
    S, B = shape.seq_len, shape.global_batch

    # attention context flops per token (QK^T + AV = 4 * ctx * H * Dh per layer)
    attn_layers = [i for i in range(cfg.num_layers)
                   if cfg.pattern[i % len(cfg.pattern)] == "attn"]
    ctx = {"train": S / 2, "prefill": S / 2, "decode": S}[shape.kind]
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    attn_per_tok = 4 * ctx * cfg.num_heads * cfg.head_dim * len(attn_layers)

    fwd_per_tok = 2 * N + attn_per_tok
    if shape.kind == "train":
        k = tail_periods(cfg, lane)
        f_tail = k / cfg.num_periods
        if lane.lane == "full_bp":
            mult = 3.0
        elif lane.lane == "full_zo":
            mult = 2.0 * lane.zo_num_probes
        else:
            mult = 2.0 * lane.zo_num_probes * (1.0 + f_tail)
        tokens = B * S
        total = mult * fwd_per_tok * tokens
        formula = (f"{mult:.2f} x (2N + attn) x {tokens} tok "
                   f"(N_act={N:.3e}, f_tail={f_tail:.3f})")
    elif shape.kind == "prefill":
        tokens = B * S
        total = fwd_per_tok * tokens
        formula = f"(2N + attn) x {tokens} tok"
    else:
        tokens = B * 1
        total = fwd_per_tok * tokens
        formula = f"(2N + attn(ctx={ctx:.0f})) x {tokens} tok"
    return {"total": total, "per_device": total / n_devices,
            "formula": formula, "params_active": N, "params_total": N_tot}


def link_of(ranks) -> str:
    """``nvlink`` where every rank of the group is on one 8-card host,
    else ``ndr``."""
    return "nvlink" if len({r // HOST_CARDS for r in ranks}) == 1 else "ndr"


def collective_seconds(groups) -> Dict[str, float]:
    """{link: seconds} of a record's ``collective_groups``."""
    out = {"nvlink": 0.0, "ndr": 0.0}
    for g in groups:
        link = link_of(g["ranks"])
        out[link] += g["bytes"] / (NVLINK_BW if link == "nvlink" else NDR_BW)
    return out


def compute_seconds(full: dict) -> float:
    """The aten FLOPs by dtype at the card's peak for each, plus the
    kernels' operation-bound time."""
    t = sum(f / cost.peak_ops(getattr(torch, dt, None))
            for dt, f in full["flops_by_dtype"].items())
    return t + sum(k["ops_bound_s"] for k in full["kernels"].values())


def load_cell(arch: str, shape: str, mesh: str,
              results: Path = RESULTS, strategy: str = "tp"
              ) -> Optional[dict]:
    from ..launch.dryrun import out_name
    f = results / out_name(arch, shape, mesh, strategy, False)
    if not f.exists():
        return None
    return json.loads(f.read_text())


def row_of(rec: dict, lane: Optional[LaneConfig] = None) -> dict:
    """The roofline row of one dry-run record (``status`` ok)."""
    arch, shape, mesh = rec["arch"], rec["shape"], rec["mesh"]
    n_dev = 1
    for v in rec["mesh_shape"].values():
        n_dev *= v
    full = rec["full"]
    flops = full["flops"]
    t_c = compute_seconds(full)
    t_m = full["bytes_accessed"] / HBM_BW
    links = collective_seconds(full.get("collective_groups", []))
    t_x = links["nvlink"] + links["ndr"]
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    lane = lane or LaneConfig(lane=rec.get("lane", "elastic_zo"))
    ideal = model_flops_per_device(arch, shape, n_dev, lane)
    # uncapped: the count holds only flop_registry's products and the
    # kernels' operations, so MODEL above it means a count is wrong
    util = ideal["per_device"] / max(flops, 1.0)
    # roofline fraction: ideal compute time over the achievable step time
    t_step = max(t_c, t_m, t_x)
    frac = (ideal["per_device"] / PEAK_FLOPS) / max(t_step, 1e-12)
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
        "devices": n_dev,
        "flops_dev": flops, "bytes_dev": full["bytes_accessed"],
        "coll_bytes_dev": full["collective_bytes"],
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "t_nvlink_s": links["nvlink"], "t_ndr_s": links["ndr"],
        "bottleneck": dom,
        "model_flops_dev": ideal["per_device"],
        "model_formula": ideal["formula"],
        "useful_flops_ratio": util,
        "roofline_fraction": frac,
        "peak_bytes_dev": full["memory"].get("peak_bytes"),
        "fits_card": (full["memory"].get("peak_bytes") or 0) <= CARD_BYTES,
        "temp_bytes_dev": full["memory"].get("temp_bytes"),
        "arg_bytes_dev": full["memory"].get("argument_bytes"),
        "collectives": full.get("collectives", {}),
        "attn_plan": rec.get("attn_plan"), "moe_plan": rec.get("moe_plan"),
        "units": "bounds at H100 SXM published peaks, 700 W",
    }


def roofline_row(arch: str, shape: str, mesh: str = "single",
                 lane: Optional[LaneConfig] = None,
                 results: Path = RESULTS, strategy: str = "tp") -> dict:
    rec = load_cell(arch, shape, mesh, results, strategy)
    if rec is None or rec.get("status") != "ok":
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": (rec or {}).get("error")
                or (rec or {}).get("reason") or "missing"}
    return row_of(rec, lane)


def full_table(mesh: str = "single", results: Path = RESULTS,
               strategy: str = "tp"):
    from ..configs import cell_matrix
    rows = []
    for a, s, run, why in cell_matrix():
        if not run:
            rows.append({"arch": a, "shape": s, "mesh": mesh,
                         "status": f"skipped: {why}"})
            continue
        rows.append(roofline_row(a, s, mesh, results=results,
                                 strategy=strategy))
    return rows


def format_table(rows) -> str:
    out = ["| arch | shape | bottleneck | t_comp | t_mem | t_coll | "
           "MODEL/counted | roofline |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — | "
                       f"{r['status'][:60]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | **{r['bottleneck']}** "
            f"| {r['t_compute_s']*1e3:.1f}ms | {r['t_memory_s']*1e3:.1f}ms "
            f"| {r['t_collective_s']*1e3:.1f}ms "
            f"| {r['useful_flops_ratio']*100:.0f}% "
            f"| {r['roofline_fraction']*100:.0f}% |")
    return "\n".join(out)


def format_detail(rows) -> str:
    """Each cell's per-device counts beside the three terms (the PERF.md
    tables; train, prefill and decode cells alike): FLOPs, bytes,
    collective bytes, peak bytes and whether they fit one card."""
    out = ["| arch | shape | mesh | FLOPs | bytes | coll. bytes | peak bytes "
           "| fits 80 GB | t_comp ms | t_mem ms | t_coll ms | bottleneck | "
           "MODEL/counted |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['flops_dev']:.4g} "
            f"| {r['bytes_dev']:.4g} | {r['coll_bytes_dev']:.4g} "
            f"| {r['peak_bytes_dev']:.4g} "
            f"| {'yes' if r['fits_card'] else 'no'} "
            f"| {r['t_compute_s'] * 1e3:.3g} "
            f"| {r['t_memory_s'] * 1e3:.3g} "
            f"| {r['t_collective_s'] * 1e3:.3g} "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.3f} |")
    return "\n".join(out)


def format_both(rows, other=None, other_name: str = "") -> str:
    """One line a cell with its single- and two-pod numbers side by side
    (a / b): FLOPs, bytes, collective bytes and peak bytes a device,
    whether the peak fits one card, and the bottleneck; with ``other``
    (the same cells' rows under another strategy, ``other_name``) its
    collective bytes, peak and bottleneck too."""
    def by_cell(rs):
        cells = {}
        for r in rs or ():
            if r.get("status") == "ok":
                cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
        return cells
    cells, alt = by_cell(rows), by_cell(other)
    head = ("| arch | shape | FLOPs | bytes | coll. bytes | peak bytes | "
            "fits 80 GB | bottleneck |")
    if other is not None:
        head += (f" {other_name}: coll. bytes | {other_name}: peak | "
                 f"{other_name}: bottleneck |")
    out = [head, "|" + "---|" * (head.count("|") - 1)]

    def pair(by, key, fmt="{:.3g}"):
        def one(v):
            return ("yes" if v else "no") if isinstance(v, bool) \
                else fmt.format(v)
        return " / ".join(one(by[m][key]) if m in by else "—"
                          for m in ("single", "multi"))
    for (arch, shape), by in cells.items():
        line = (f"| {arch} | {shape} | {pair(by, 'flops_dev')} "
                f"| {pair(by, 'bytes_dev')} | {pair(by, 'coll_bytes_dev')} "
                f"| {pair(by, 'peak_bytes_dev')} "
                f"| {pair(by, 'fits_card', '{}')} "
                f"| {pair(by, 'bottleneck', '{}')} |")
        if other is not None:
            o = alt.get((arch, shape), {})
            line += (f" {pair(o, 'coll_bytes_dev')} "
                     f"| {pair(o, 'peak_bytes_dev')} "
                     f"| {pair(o, 'bottleneck', '{}')} |")
        out.append(line)
    return "\n".join(out)


def main(argv=None):
    """``python -m repro_torch.benchmarks.roofline [--mesh ...] [--kind
    ...] [--strategy ...]``: the detailed table of the dry-run records
    of a strategy (every cell, or
    the train, prefill or decode cells; with ``--mesh both`` a line a
    cell, the two meshes side by side)."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--kind", choices=["train", "prefill", "decode"])
    ap.add_argument("--strategy", default="tp",
                    choices=["tp", "fsdp", "serve"])
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--beside", choices=["tp", "fsdp", "serve"],
                    help="with --mesh both: another strategy's collective "
                         "bytes, peak and bottleneck in the same lines")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    def table(strategy):
        return [r for m in meshes
                for r in full_table(m, Path(args.results), strategy)
                if args.kind is None
                or get_shape(r["shape"]).kind == args.kind]
    rows = table(args.strategy)
    print("# per device; bounds at H100 SXM published peaks, 700 W")
    if args.mesh != "both":
        print(format_detail(rows))
        return
    other = None if args.beside is None else table(args.beside)
    print(format_both(rows, other, args.beside or ""))


if __name__ == "__main__":
    main()
