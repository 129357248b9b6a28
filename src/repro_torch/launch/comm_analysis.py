"""Collective-byte accounting over a step's recorded collectives.

The port's twin of ``repro/launch/hlo_analysis.py``. There the
collectives come from parsing the post-SPMD HLO, with each while body's
trip count recovered and multiplied in; here there is no HLO, hence the
new name: ``sharding/collectives.py`` records each collective as the
step calls it into the active cost counter (``kernels/cost.py``), and
eager execution calls a collective once per execution, so every record
counts once: there are no trip counts. Each record carries the bytes it
moves a rank, by the reference's ring conventions
(``kernels/cost.py::bytes_moved``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple


@dataclass
class CollectiveOp:
    kind: str
    bytes_moved: float      # per device
    group: int
    ranks: tuple


def collective_bytes(records: Iterable) -> Tuple[float, List[CollectiveOp]]:
    """Total per-device collective bytes + op list, from a cost
    counter's collective records (``kernels/cost.py::Collective``)."""
    ops = [CollectiveOp(r.kind, r.bytes_moved, r.group, tuple(r.ranks))
           for r in records if r.group > 1]
    return sum(o.bytes_moved for o in ops), ops


def summarize(ops: List[CollectiveOp]) -> Dict[str, Dict[str, float]]:
    by_kind: Dict[str, Dict[str, float]] = {}
    for o in ops:
        d = by_kind.setdefault(o.kind, {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += o.bytes_moved
    return by_kind
