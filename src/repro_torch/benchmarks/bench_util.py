"""Shared benchmark output contract.

The port of ``benchmarks/bench_util.py``. Every benchmark writes
``BENCH_<name>.json`` at the repo root with the schema ``{"name": ...,
"config": {...}, "metrics": {...}}``, metrics flat with scalar leaves
(or None where a number was not measured). The port's files are named
``BENCH_torch_*.json`` and never overwrite the JAX package's.

When the process has an armed flight recorder (``repro_torch.obs``),
the document also carries the recorder's snapshot: ``"timings"`` (span
totals + histograms), ``"counters"`` (counters + gauges) and
``"memory"`` (the tagged live-bytes ledger, merged with a
benchmark-supplied table such as run.py's measured-vs-analytic lanes).
A run on the card records the card's name and power limit in
``config["card"]``, as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, since a card set below its maximum
power runs slower under load. ``ulps`` is the distance the checks hold
an f32 or bf16 result to its reference by.
"""
from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from .. import obs

REPO_ROOT = Path(__file__).resolve().parents[3]


def card_name_and_power(device) -> str:
    """nvidia-smi's "name, power.limit" line of ``device``'s card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    index = torch.device(device).index
    return lines[index if index is not None else torch.cuda.current_device()]


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in ulps of the dtype (f32 or bf16) between two
    tensors of one dtype, in sign-magnitude order (+0 and -0 are one)."""
    bits, view = (16, torch.int16) if a.dtype == torch.bfloat16 \
        else (32, torch.int32)

    def order(t):
        i = t.detach().cpu().view(view).to(torch.int64) & ((1 << bits) - 1)
        mag = i & ((1 << (bits - 1)) - 1)
        return torch.where(i >> (bits - 1) == 1, -mag, mag)
    return int((order(a) - order(b)).abs().max()) if a.numel() else 0


def write_bench(name: str, config: dict, metrics: dict,
                out: str | None = None, memory: dict | None = None,
                device=None) -> Path:
    config = dict(config)
    if device is not None and torch.device(device).type == "cuda":
        config["card"] = card_name_and_power(device)
        config["torch"] = torch.__version__
        config["cuda"] = torch.version.cuda
    doc = {"name": name, "config": config, "metrics": metrics}
    rec = obs.get()
    if rec.enabled:
        snap = rec.snapshot()
        doc["timings"] = {"spans": snap["spans"],
                          "histograms": snap["histograms"]}
        doc["counters"] = {"counters": snap["counters"],
                           "gauges": snap["gauges"]}
        doc["memory"] = dict(memory or {})
        doc["memory"]["ledger"] = snap.get("memory", {})
    elif memory:
        doc["memory"] = dict(memory)
    path = Path(out) if out else REPO_ROOT / f"BENCH_{name}.json"
    path.write_text(json.dumps(doc, indent=2) + "\n")
    print(f"# wrote {path}")
    return path
