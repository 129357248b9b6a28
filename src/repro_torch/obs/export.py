"""Exporters: Chrome-trace/Perfetto JSON + metrics snapshot files.

A copy of ``repro/obs/export.py`` (the port imports nothing of the JAX
package).

``chrome_trace`` turns a Recorder's spans and events into the Trace
Event Format that chrome://tracing and https://ui.perfetto.dev load
directly: one fake process, one *thread per track* (named via ``M``
metadata events), ``X`` complete events for spans (``ts``/``dur`` in
microseconds), ``i`` instant events for the structured log.

``validate_chrome_trace`` is the schema gate the tests run on every
emitted trace and on round-trips: it must *reject* malformed
documents, not merely parse them — a trace that silently drops spans
would un-attribute exactly the costs this subsystem exists to pin.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

__all__ = ["chrome_trace", "write_chrome_trace", "write_metrics",
           "validate_chrome_trace", "load_chrome_trace"]

# Stable track order → stable tid assignment across runs, so diffs of
# two traces line up in the viewer. Unknown tracks append after.
_TRACK_ORDER = ("main", "engine", "train", "fleet", "serve")


def _tid_map(tracks: List[str]) -> Dict[str, int]:
    ordered = [t for t in _TRACK_ORDER if t in tracks]
    ordered += sorted(t for t in tracks if t not in _TRACK_ORDER)
    return {t: i + 1 for i, t in enumerate(ordered)}


def chrome_trace(rec) -> Dict[str, Any]:
    """Render a Recorder to a Chrome Trace Event Format document."""
    spans = list(rec.spans)
    events = list(rec.events)
    tracks = sorted({s["track"] for s in spans}
                    | {e["track"] for e in events})
    tids = _tid_map(tracks)
    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "repro_torch"}},
    ]
    for t, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                    "args": {"name": t}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": 1,
                    "tid": tid, "args": {"sort_index": tid}})
    for s in spans:
        ev = {"ph": "X", "name": s["name"], "cat": s["track"],
              "pid": 1, "tid": tids[s["track"]],
              "ts": s["ts"] / 1e3, "dur": s["dur"] / 1e3}
        if s.get("args"):
            ev["args"] = s["args"]
        out.append(ev)
    for e in events:
        ev = {"ph": "i", "name": e["name"], "cat": e["track"],
              "pid": 1, "tid": tids[e["track"]],
              "ts": e["ts"] / 1e3, "s": "t"}
        if e.get("fields"):
            ev["args"] = dict(e["fields"], level=e["level"])
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(rec, path) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(rec), f, indent=1)


def write_metrics(rec, path) -> None:
    with open(path, "w") as f:
        json.dump(rec.snapshot(), f, indent=2, sort_keys=True)


def validate_chrome_trace(doc: Any) -> List[Dict[str, Any]]:
    """Assert ``doc`` is a loadable Trace Event Format document.

    Returns the event list on success; raises ``ValueError`` naming the
    first offending event otherwise. Checks the subset Perfetto needs:
    the ``traceEvents`` envelope, per-event ``ph``/``name``/``pid``/
    ``tid``, numeric non-negative ``ts``, and numeric non-negative
    ``dur`` on every ``X`` event.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome trace: missing traceEvents envelope")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing {key!r}")
        ph = ev["ph"]
        if ph not in ("X", "M", "i", "B", "E", "C"):
            raise ValueError(f"traceEvents[{i}] unknown phase {ph!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"traceEvents[{i}] bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}] bad dur {dur!r}")
    return evs


def load_chrome_trace(path) -> List[Dict[str, Any]]:
    """Load + validate a trace file; returns its event list."""
    with open(path) as f:
        doc = json.load(f)
    return validate_chrome_trace(doc)
