"""The flight recorder: spans, metrics, events -- one process-wide canon.

A copy of ``repro/obs/recorder.py`` (the port imports nothing of the JAX
package). The paper's whole argument is a cost ledger (forwards traded
for backward memory, int8 traded for fp32 time); this module is the
instrument that ledger is kept with. Three primitives, one recorder:

  * **spans** -- nestable wall-clock intervals on named *tracks*
    (``engine``, ``train``, ``serve``), timed with
    ``time.perf_counter_ns`` (monotonic). Nesting depth is tracked per
    thread; the Chrome-trace exporter (obs/export.py) lays sibling spans
    out on their track. A span measures the host's clock: callers that
    want device time in it synchronise the device before it closes, and
    only when the recorder is armed.
  * **metrics** -- a typed registry: ``Counter`` (monotone accumulate),
    ``Gauge`` (last value wins), ``Histogram`` (count/sum/min/max plus
    power-of-two buckets for percentile estimates). Scalar,
    allocation-free on the observe path.
  * **events** -- a structured log: instant records with a name, a
    track, and scalar fields. Library progress lines route through
    ``obs.log`` (obs/__init__.py) so stdout is a *view* of the event
    log, not the log itself.

The default recorder is ``NullRecorder`` -- a no-op singleton whose
``span``/``counter``/``gauge``/``histogram`` return cached null objects,
so an uninstrumented process pays one attribute check per call site and
allocates nothing. Hot loops hoist ``rec = obs.get()`` and guard
device syncs with ``rec.enabled``.

Recording is **numerics-inert**: the recorder only wraps host-side
control flow and never touches a tensor's values, so an instrumented run
gives bitwise the same parameters and tokens as an uninstrumented one
(tests/test_torch_obs.py).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List

from .memory import MemoryLedger, NullMemoryLedger

__all__ = ["Counter", "Gauge", "Histogram", "Recorder", "NullRecorder",
           "monotonic", "perf_ns"]

perf_ns = time.perf_counter_ns


def monotonic() -> float:
    """The repo's one monotonic wall clock (seconds, float).

    Use for *durations*: ``time.time()`` deltas go negative under NTP
    clock steps. ``time.time()`` remains correct for wall-clock
    *stamps* (checkpoint manifests keep it).
    """
    return time.perf_counter()


# ------------------------------------------------------------------ #
# metrics
# ------------------------------------------------------------------ #


class Counter:
    """Monotone accumulator (int or float)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, v=1):
        self.value += v


class Gauge:
    """Last-value-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Scalar distribution: count/sum/min/max + power-of-two buckets.

    Buckets hold counts per ``ceil(log2(v))`` so percentiles are
    estimated to within a factor of two at any scale with O(1) memory —
    good enough for latency attribution, bounded for long-lived
    engines (unlike keeping samples).
    """

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[int, int] = {}

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        b = math.ceil(math.log2(v)) if v > 0 else -1074  # 0/neg underflow bin
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile sample."""
        if not self.count:
            return 0.0
        target = max(math.ceil(q * self.count), 1)
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= target:
                return float(2.0 ** b) if b > -1074 else 0.0
        return self.vmax

    def summary(self) -> Dict[str, Any]:
        """Self-contained snapshot row: moments, computed percentiles,
        AND the raw power-of-two buckets (keyed by the stringified
        exponent so the dict survives a JSON round-trip) — a BENCH file
        is diffable without access to the live Histogram."""
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                    "buckets": {}}
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "mean": self.total / self.count,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99),
                "buckets": {str(b): self.buckets[b]
                            for b in sorted(self.buckets)}}


# ------------------------------------------------------------------ #
# spans
# ------------------------------------------------------------------ #


class _Span:
    """One live span; re-use via ``with rec.span(...) as sp`` and read
    ``sp.dur_ns`` after exit (e.g. to feed a histogram)."""

    __slots__ = ("rec", "name", "track", "args", "t0", "depth", "dur_ns")

    def __init__(self, rec: "Recorder", name: str, track: str, args):
        self.rec = rec
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0
        self.depth = 0
        self.dur_ns = 0

    def __enter__(self):
        stack = self.rec._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = perf_ns()
        return self

    def __exit__(self, *exc):
        self.dur_ns = perf_ns() - self.t0
        self.rec._stack().pop()
        self.rec._finish(self)
        return False


class _NullSpan:
    """The shared no-op span: zero allocations on the disabled path."""

    __slots__ = ()
    dur_ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullMetric:
    """The shared no-op Counter/Gauge/Histogram."""

    __slots__ = ()
    value = 0
    count = 0

    def inc(self, v=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def summary(self):
        return {}


_NULL_SPAN = _NullSpan()
_NULL_METRIC = _NullMetric()


# ------------------------------------------------------------------ #
# recorders
# ------------------------------------------------------------------ #


class Recorder:
    """An armed flight recorder. Install via ``obs.install`` /
    ``obs.configure``; read back via ``snapshot()`` (metrics dict) and
    ``obs.export.chrome_trace`` (span/event timeline)."""

    enabled = True

    def __init__(self):
        self.t0_ns = perf_ns()
        self.spans: List[Dict[str, Any]] = []   # finished, completion order
        self.events: List[Dict[str, Any]] = []
        self.memory = MemoryLedger()            # tagged live-bytes registry
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ---- spans -------------------------------------------------------- #
    def span(self, name: str, track: str = "main", **args) -> _Span:
        return _Span(self, name, track, args or None)

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _finish(self, sp: _Span):
        rec = {"name": sp.name, "track": sp.track,
               "ts": sp.t0 - self.t0_ns, "dur": sp.dur_ns,
               "depth": sp.depth}
        if sp.args:
            rec["args"] = sp.args
        with self._lock:
            self.spans.append(rec)

    # ---- events ------------------------------------------------------- #
    def event(self, name: str, track: str = "main",
              level: str = "info", **fields):
        rec = {"name": name, "track": track, "level": level,
               "ts": perf_ns() - self.t0_ns}
        if fields:
            rec["fields"] = fields
        with self._lock:
            self.events.append(rec)

    # ---- metrics ------------------------------------------------------ #
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram())
        return h

    # ---- readback ----------------------------------------------------- #
    def span_totals(self) -> Dict[str, Dict[str, float]]:
        """Aggregate finished spans by name: count / total / mean ms."""
        agg: Dict[str, Dict[str, float]] = {}
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            a = agg.setdefault(s["name"], {"count": 0, "total_ms": 0.0})
            a["count"] += 1
            a["total_ms"] += s["dur"] / 1e6
        for a in agg.values():
            a["mean_ms"] = a["total_ms"] / a["count"]
        return agg

    def snapshot(self) -> Dict[str, Any]:
        """The metrics snapshot dict benchmarks merge into BENCH_*.json."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._hists.items())},
            "spans": self.span_totals(),
            "memory": self.memory.snapshot(),
        }

    def reset(self):
        """Drop all recorded data (keeps the registry identity)."""
        with self._lock:
            self.spans.clear()
            self.events.clear()
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self.t0_ns = perf_ns()
        self.memory.reset()


class NullRecorder:
    """The default: every primitive returns a cached no-op object.

    A disabled call site costs one method call and allocates nothing —
    hot loops additionally guard with ``rec.enabled`` so even the call
    disappears (and device syncs never run).
    """

    enabled = False
    spans: List[Dict[str, Any]] = []     # always empty; read-only views
    events: List[Dict[str, Any]] = []
    memory = NullMemoryLedger()          # shared no-op ledger

    def span(self, name, track="main", **args):
        return _NULL_SPAN

    def event(self, name, track="main", level="info", **fields):
        pass

    def counter(self, name):
        return _NULL_METRIC

    def gauge(self, name):
        return _NULL_METRIC

    def histogram(self, name):
        return _NULL_METRIC

    def span_totals(self):
        return {}

    def snapshot(self):
        return {}

    def reset(self):
        pass
