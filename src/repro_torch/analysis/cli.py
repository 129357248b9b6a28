"""``python -m repro_torch.analysis`` — run reprolint over the port.

Pure stdlib on purpose: it runs in a bare interpreter, with neither
torch nor a card (``chip_smoke.py`` runs it on the card's host).

Exit codes: 0 clean, 1 findings (including stale/bad suppressions),
2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .core import Report, run_analysis
from .project import find_repo_root
from .rules import ALL_RULES, META_RULES, rules_by_id


def _human_report(report: Report, verbose: bool) -> str:
    out: List[str] = []
    for f in report.findings:
        out.append(f"{f.location()}: [{f.rule}] {f.message}")
    if verbose and report.suppressed:
        out.append("")
        for f in report.suppressed:
            out.append(f"{f.location()}: [{f.rule}] suppressed")
    n, s = len(report.findings), len(report.suppressed)
    out.append(f"reprolint: {n} finding{'s' * (n != 1)}, "
               f"{s} suppressed, {len(report.rules)} rules")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint for the port: machine-check "
                    "src/repro_torch's determinism, CUDA kernel-contract "
                    "and observability invariants")
    parser.add_argument("--root", type=Path, default=None,
                        help="repo root (default: nearest pyproject.toml)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--report", type=Path, default=None, metavar="JSON",
                        help="write the machine-readable report here")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print suppressed findings")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in (*ALL_RULES, *META_RULES):
            print(f"{r.id:26s} {r.title}")
        return 0

    try:
        root = args.root or find_repo_root()
    except FileNotFoundError as e:
        print(f"reprolint: {e}", file=sys.stderr)
        return 2
    rules = ALL_RULES
    if args.rules:
        by_id = rules_by_id()
        unknown = [r for r in args.rules.split(",") if r not in by_id]
        if unknown:
            print(f"reprolint: unknown rule ids {unknown} "
                  "(try --list-rules)", file=sys.stderr)
            return 2
        rules = [by_id[r] for r in args.rules.split(",")]

    try:
        report = run_analysis(root, rules)
    except ValueError as e:            # malformed allowlist
        print(f"reprolint: {e}", file=sys.stderr)
        return 2

    if args.report:
        args.report.write_text(json.dumps(report.to_dict(), indent=2) + "\n",
                               encoding="utf-8")
    print(_human_report(report, args.verbose))
    return 0 if report.clean else 1
