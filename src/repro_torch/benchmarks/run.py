"""Benchmark runner: one section per paper table/figure, on the card.

``python -m repro_torch.benchmarks.run [--fast] [--section NAME]
[--device cpu] [--out PATH]``

The port of ``benchmarks/run.py``. Each section prints a human-readable
'#'-prefixed table and returns a flat metrics dict; the runner merges
them into ``BENCH_torch_paper.json`` at the repo root (never
``BENCH_paper.json``, the JAX package's) on the bench_util schema
({name, config, metrics}), with the flight recorder's spans and memory
ledger beside them. It runs on the card unless given ``--device cpu``;
on the CPU the sections ``signagree`` and ``memory`` make sense (the
measured memory rows are None there) and the others run at CPU speed.

The ``roofline`` section tabulates the dry run's records
(``launch/dryrun.py``, results/dryrun_torch/) by ``benchmarks/
roofline.py``, the port's twin of the reference's XLA/TPU cost model, at
the H100's published peaks, the train, prefill and decode cells of the
single-pod mesh and then of the two-pod one; it needs no card and
writes ``results/roofline_single_torch.json`` and
``results/roofline_multi_torch.json`` (never the reference's
``results/roofline_single.json``). A section that raises is recorded as
``<section>_error`` in the document, as the reference does, and makes the
run exit with 1.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

from .. import obs
from ..core.api import resolve_device
from .bench_util import write_bench

LANE_ORDER = ["full_zo", "zo_feat_cls2", "zo_feat_cls1", "full_bp"]


def section_accuracy(fast: bool, device) -> Dict:
    from . import paper_tables as pt
    metrics = {}
    steps = 150 if fast else 800
    t0 = time.perf_counter()
    res = pt.lenet_lanes(steps=steps, device=device)
    dt = (time.perf_counter() - t0) * 1e6 / steps
    print("# Table1(FP32 glyphs): " +
          " ".join(f"{k}={res[k].acc*100:.1f}%" for k in LANE_ORDER))
    metrics["table1_fp32_lenet_us_per_step"] = dt
    metrics.update({f"table1_fp32_lenet_acc_{k}": res[k].acc
                    for k in LANE_ORDER})
    metrics.update({f"table1_fp32_lenet_ms_per_step_{k}":
                    res[k].train_s * 1e3 / steps for k in LANE_ORDER})

    t0 = time.perf_counter()
    res8 = pt.lenet_int8_lanes(steps=steps, loss_mode="int", device=device)
    dt8 = (time.perf_counter() - t0) * 1e6 / steps
    print("# Table1(INT8* glyphs): " +
          " ".join(f"{k}={v.acc*100:.1f}%" for k, v in res8.items()))
    metrics["table1_int8star_lenet_us_per_step"] = dt8
    metrics.update({f"table1_int8star_lenet_acc_{k}": v.acc
                    for k, v in res8.items()})

    psteps = 100 if fast else 400
    t0 = time.perf_counter()
    resp = pt.pointnet_lanes(steps=psteps, device=device)
    dtp = (time.perf_counter() - t0) * 1e6 / psteps
    print("# Table1(PointNet clouds): " +
          " ".join(f"{k}={v.acc*100:.1f}%" for k, v in resp.items()))
    metrics["table1_pointnet_us_per_step"] = dtp
    metrics.update({f"table1_pointnet_acc_{k}": v.acc
                    for k, v in resp.items()})
    metrics.update({f"table1_pointnet_ms_per_step_{k}":
                    v.train_s * 1e3 / psteps for k, v in resp.items()})
    return metrics


def section_finetune(fast: bool, device) -> Dict:
    from . import paper_tables as pt
    metrics = {}
    steps = 100 if fast else 400
    # pretrain with BP on upright glyphs (paper: 1-100 epochs of BP)
    pre = pt.lenet_pretrained(steps, device=device)
    for deg in (30, 45):
        acc0 = pt.lenet_rotated_accuracy(pre, deg, device=device)
        t0 = time.perf_counter()
        res = pt.lenet_lanes(steps=steps, rotate=deg, init_params=pre,
                             zo_lr=5e-3, device=device)
        dt = (time.perf_counter() - t0) * 1e6 / steps
        print(f"# Table2(rot{deg}): before={acc0*100:.1f}% " +
              " ".join(f"{k}={v.acc*100:.1f}%" for k, v in res.items()))
        metrics[f"table2_rot{deg}_us_per_step"] = dt
        metrics[f"table2_rot{deg}_acc_before"] = acc0
        metrics.update({f"table2_rot{deg}_acc_{k}": v.acc
                        for k, v in res.items()})
    return metrics


# The structured reconciliation table section_memory builds for the
# document's "memory" section (write_bench merges it with the recorder's
# tagged-ledger snapshot). Module-level because sections return flat
# scalar metrics only.
MEMORY_DOC: dict = {}


def section_memory(_fast: bool, device) -> Dict:
    from . import paper_tables as pt
    metrics = {}
    for b in (32, 256):
        t = pt.lenet_memory_table(b)
        full_bp = t["full_bp"]["fp32_bytes"]
        fz = t["full_zo"]["fp32_bytes"]
        print(f"# Fig4/5 (LeNet B={b}): " + " ".join(
            f"{k}: fp32={v['fp32_bytes']/1e6:.2f}MB "
            f"int8={v['int8_bytes']/1e6:.2f}MB" for k, v in t.items()))
        metrics[f"memory_lenet_b{b}_bp_over_zo"] = full_bp / fz
        metrics[f"memory_lenet_b{b}_cls1_overhead_pct"] = \
            (t["zo_feat_cls1"]["fp32_bytes"] - fz) / fz * 100
        metrics[f"memory_lenet_b{b}_int8_saving"] = \
            fz / t["full_zo"]["int8_bytes"]
        metrics[f"memory_lenet_b{b}_int8_saving_reused"] = \
            fz / t["full_zo"]["int8_reused_bytes"]
    p = pt.pointnet_memory_table(32)
    print(f"# Fig6 (PointNet B=32): full_bp={p['full_bp']['fp32_bytes']/1e6:.1f}MB "
          f"full_zo={p['full_zo']['fp32_bytes']/1e6:.1f}MB "
          f"cls1={p['zo_feat_cls1']['fp32_bytes']/1e6:.1f}MB")
    metrics["memory_pointnet_b32_bp_over_zo"] = \
        p["full_bp"]["fp32_bytes"] / p["full_zo"]["fp32_bytes"]

    # ---- MEASURED: one warm step of each lane on the card ------------ #
    mb = 32
    analytic = pt.lenet_memory_table(mb)
    meas = pt.lenet_measured_memory(mb, device=device)
    meas8 = pt.lenet_int8_measured_memory(mb, device=device)
    MEMORY_DOC.clear()
    MEMORY_DOC.update({"model": "lenet5", "batch": mb,
                       "instrument": "core/engine.py::step_memory_analysis:"
                                     " a warm step, then one measured with "
                                     "torch.cuda.max_memory_allocated "
                                     "(params and batch + peak growth)",
                       "lanes": {}, "int8_lanes": {}})
    if meas is None:
        print("# Fig4/5 measured: not measured (no card: the CPU has no "
              "allocator peak to read)")
    for k in analytic:
        a = analytic[k]["fp32_bytes"]
        fp = meas[k] if meas is not None else None
        peak = fp["peak_bytes"] if fp is not None else None
        resid = peak - a if peak is not None else None
        metrics[f"memory_measured_lenet_b{mb}_{k}_peak_bytes"] = peak
        metrics[f"memory_resid_lenet_b{mb}_{k}_bytes"] = resid
        MEMORY_DOC["lanes"][k] = {**(fp or {"peak_bytes": None}),
                                  "analytic_bytes": a,
                                  "residual_bytes": resid}
    for k in ("full_zo", "zo_feat_cls2", "zo_feat_cls1"):
        a = analytic[k]["int8_reused_bytes"]
        fp = meas8[k] if meas8 is not None else None
        peak = fp["peak_bytes"] if fp is not None else None
        resid = peak - a if peak is not None else None
        metrics[f"memory_measured_int8_lenet_b{mb}_{k}_peak_bytes"] = peak
        metrics[f"memory_resid_int8_lenet_b{mb}_{k}_bytes"] = resid
        MEMORY_DOC["int8_lanes"][k] = {
            **(fp or {"peak_bytes": None}), "analytic_bytes": a,
            "analytic_noreuse_bytes": analytic[k]["int8_bytes"],
            "residual_bytes": resid}
    ratios = {"bp_over_zo": None, "cls1_overhead_pct": None,
              "int8_ratio": None}
    if meas is not None:
        fz = meas["full_zo"]["peak_bytes"]
        ratios["bp_over_zo"] = meas["full_bp"]["peak_bytes"] / fz
        ratios["cls1_overhead_pct"] = \
            (meas["zo_feat_cls1"]["peak_bytes"] - fz) / fz * 100
        ratios["int8_ratio"] = fz / meas8["full_zo"]["peak_bytes"]
        print(f"# Fig4/5 measured (LeNet B={mb}, card): " + " ".join(
            f"{k}={v['peak_bytes']/1e6:.3f}MB" for k, v in meas.items())
            + f"  bp_over_zo={ratios['bp_over_zo']:.3f}")
        print(f"# Fig4/5 measured (LeNet B={mb}, INT8*, card): " + " ".join(
            f"{k}={v['peak_bytes']/1e6:.3f}MB" for k, v in meas8.items()))
    for k, v in ratios.items():
        metrics[f"memory_measured_lenet_b{mb}_{k}"] = v
    return metrics


def section_steptime(fast: bool, device) -> Dict:
    from . import paper_tables as pt
    bd = pt.steptime_breakdown(iters=5 if fast else 20, device=device)
    where = "card, CUDA events" if device.type == "cuda" else "host clock"
    print(f"# Fig7 (step-time, {where}): " +
          " ".join(f"{k}={v:.1f}us" for k, v in bd.items()))
    metrics = dict(bd)
    fp32_total = bd["fp32_forward_us"] + bd["fp32_perturb_us"] \
        + bd["fp32_update_us"] + bd["fp32_bp_tail_us"]
    metrics["steptime_fp32_total_us"] = fp32_total
    metrics["steptime_fp32_fwd_share"] = bd["fp32_forward_us"] / fp32_total
    metrics["steptime_int8_fwdperturb_us"] = \
        bd["int8_forward_us"] + bd["int8_perturb_us"]
    return metrics


def section_signagree(_fast: bool, device) -> Dict:
    from . import paper_tables as pt
    t0 = time.perf_counter()
    rate, total = pt.sign_agreement(device=device)
    dt = (time.perf_counter() - t0) * 1e6 / max(total, 1)
    print(f"# §4.3 sign agreement: {rate*100:.1f}% over {total} trials "
          "(paper: ~95%)")
    return {"int_loss_sign_agreement": float(rate),
            "int_loss_sign_trials": int(total),
            "int_loss_sign_us_per_trial": dt}


def section_roofline(_fast: bool, _device) -> Dict:
    import json
    from pathlib import Path
    from . import roofline as rl
    metrics = {}
    for mesh, title in (("single", "single-pod 16x16"),
                        ("multi", "two-pod 2x16x16")):
        rows = rl.full_table(mesh)
        print(f"# Roofline ({title}, per-device; bounds at H100 SXM "
              "published peaks, 700 W):")
        print("\n".join("# " + line
                        for line in rl.format_table(rows).splitlines()))
        tag = "" if mesh == "single" else "multi_"
        for r in rows:
            if r.get("status") != "ok":
                continue
            key = f"roofline_{tag}{r['arch']}_{r['shape']}"
            metrics[f"{key}_us"] = max(r["t_compute_s"], r["t_memory_s"],
                                       r["t_collective_s"]) * 1e6
            metrics[f"{key}_fraction"] = r["roofline_fraction"]
            metrics[f"{key}_useful_flops_ratio"] = r["useful_flops_ratio"]
        out = Path(__file__).resolve().parents[3] / "results" / \
            f"roofline_{mesh}_torch.json"
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps(rows, indent=1, default=str))
    return metrics


SECTIONS = {
    "signagree": section_signagree,
    "memory": section_memory,
    "roofline": section_roofline,
    "steptime": section_steptime,
    "accuracy": section_accuracy,
    "finetune": section_finetune,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--section", choices=sorted(SECTIONS), action="append")
    ap.add_argument("--out", default="",
                    help="output path (default: BENCH_torch_paper.json at "
                         "the repo root)")
    ap.add_argument("--device", default="cuda")
    obs.add_observability_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    before = obs.get()
    obs.configure_from_args(args)
    if not obs.get().enabled:
        obs.install()      # the document always carries timings
    ran, failed = [], []
    metrics = {}
    rec = obs.get()
    try:
        for name, fn in SECTIONS.items():
            if args.section and name not in args.section:
                continue
            t0 = time.perf_counter()
            try:
                with rec.span(f"bench/{name}", track="main"):
                    metrics.update(fn(args.fast, device))
                ran.append(name)
            except Exception as e:  # noqa: BLE001
                print(f"# [{name}] ERROR {type(e).__name__}: {e}")
                metrics[f"{name}_error"] = f"{type(e).__name__}:{e}"
                failed.append(name)
            print(f"# [{name}] done in {time.perf_counter()-t0:.1f}s")
        obs.memory.sample(device if device.type == "cuda" else None)
        write_bench("torch_paper", {"fast": args.fast,
                                    "sections": ",".join(ran),
                                    "device": device.type},
                    metrics, out=args.out or None,
                    memory=MEMORY_DOC or None, device=device)
        obs.write_outputs(args)
    finally:
        # an in-process caller gets its own recorder back
        if before.enabled:
            obs.install(before)
        else:
            obs.uninstall()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
