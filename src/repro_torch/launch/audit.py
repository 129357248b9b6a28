"""Collective audit: the dry run's microscope.

The port's twin of ``repro/launch/audit.py``. Runs one (arch x shape x
strategy) cell as ``launch/dryrun.py`` does (a fake world of the
production mesh, rank 0's train step, prefill or decode step on
``meta`` tensors, counted) and prints
the top collectives by per-device bytes, each with its link and its time
there (``benchmarks/roofline.py``: bounds at the links' published rates,
not measurements), then FLOPs, bytes, temp and argument bytes, so each
change names the op it intends to kill before it is made.

  PYTHONPATH=src python -m repro_torch.launch.audit --arch mixtral-8x7b \\
      --shape train_4k --strategy tp [--top 15]
"""
from __future__ import annotations

import argparse
from math import prod

from ..configs import LaneConfig, get_arch, get_shape
from .comm_analysis import collective_bytes
from .dryrun import analyze
from .mesh import fake_world, make_production_mesh, production_shape


def audit(arch: str, shape_name: str, strategy: str = "tp", top: int = 15,
          multi_pod: bool = False, lane: str = "elastic_zo",
          fused: bool = False):
    from ..benchmarks.roofline import NDR_BW, NVLINK_BW, link_of
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    with fake_world(prod(production_shape(multi_pod)[0])):
        mesh = make_production_mesh(multi_pod=multi_pod)
        full = analyze(cfg, shape, LaneConfig(lane=lane, fused_probes=fused),
                       mesh, strategy)
    total, ops = collective_bytes(full["records"])
    ops.sort(key=lambda o: -o.bytes_moved)
    print(f"total per-device collective bytes: {total:.3e} "
          f"({total / NDR_BW * 1e3:.1f} ms @50GB/s)")
    for o in ops[:top]:
        link = link_of(o.ranks)
        bw = NVLINK_BW if link == "nvlink" else NDR_BW
        print(f"  {o.bytes_moved:10.3e}B  {o.kind:15s} group={o.group:4d} "
              f"{link:6s} {o.bytes_moved / bw * 1e3:8.3f} ms  ranks "
              f"{o.ranks[0]}..{o.ranks[-1]}")
    mem = full["memory"]
    print(f"flops/dev={full['flops']:.3e}  "
          f"bytes/dev={full['bytes_accessed']:.3e}  "
          f"temp={mem['temp_bytes'] / 1e9:.2f}GB  "
          f"args={mem['argument_bytes'] / 1e9:.2f}GB")
    return total, ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--strategy", default="tp")
    ap.add_argument("--lane", default="elastic_zo")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--fused", action="store_true")
    args = ap.parse_args(argv)
    audit(args.arch, args.shape, args.strategy, args.top, args.multi,
          args.lane, args.fused)


if __name__ == "__main__":
    main()
