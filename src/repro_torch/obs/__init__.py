"""repro_torch.obs -- the flight recorder's public surface.

The port of ``repro/obs/__init__.py``. One process-wide recorder
(default: the no-op ``NullRecorder``), one structured-log front door,
and the CLI plumbing every launch script shares:

    from repro_torch import obs

    rec = obs.get()                     # hoist in hot loops
    with rec.span("train/step", track="train", step=s):
        ...
    rec.counter("serve.admissions").inc(n)
    obs.log("train", f"step {s} loss {loss:.4f}", step=s, loss=loss)

``obs.log`` is the quiet/verbose switch the progress lines route
through: it always lands in the event log when a recorder
is armed, and mirrors to stdout unless verbosity is "quiet" — so
library code never calls ``print`` directly, and CLIs/users decide
what reaches the terminal.

CLI integration (launch/train.py, launch/serve.py, benchmarks/run.py):

    obs.add_observability_args(parser)   # --trace/--metrics/--quiet
    obs.configure_from_args(args)        # installs a Recorder if needed
    ...run...
    obs.write_outputs(args)              # writes trace/metrics files
"""
from __future__ import annotations

from .recorder import (Counter, Gauge, Histogram, NullRecorder, Recorder,
                       monotonic, perf_ns)
from .memory import MemoryLedger, NullMemoryLedger
from . import export
from . import memory

__all__ = ["Counter", "Gauge", "Histogram", "NullRecorder", "Recorder",
           "MemoryLedger", "NullMemoryLedger",
           "monotonic", "perf_ns", "get", "install", "uninstall", "log",
           "set_verbosity", "get_verbosity", "add_observability_args",
           "configure_from_args", "write_outputs", "export", "memory"]

_NULL = NullRecorder()
_RECORDER = _NULL

# "verbose" preserves the historical CLI behavior (progress lines on
# stdout); "quiet" silences library progress output entirely. The
# event log is unaffected either way.
_VERBOSITY = "verbose"


def get():
    """The process-wide recorder (NullRecorder unless installed)."""
    return _RECORDER


def install(rec=None) -> Recorder:
    """Arm a recorder process-wide; returns it. ``install()`` makes a
    fresh one."""
    global _RECORDER
    if rec is None:
        rec = Recorder()
    _RECORDER = rec
    return rec


def uninstall():
    """Back to the no-op singleton (the numerics-inert tests flip this
    between instrumented and reference runs)."""
    global _RECORDER
    _RECORDER = _NULL


def set_verbosity(level: str):
    if level not in ("quiet", "verbose"):
        raise ValueError(f"verbosity must be quiet|verbose, got {level!r}")
    global _VERBOSITY
    _VERBOSITY = level


def get_verbosity() -> str:
    return _VERBOSITY


def log(channel: str, msg: str, level: str = "info", **fields):
    """Structured progress line: event-log record + optional stdout echo.

    The one sanctioned replacement for library ``print(f"[x] ...")``
    calls: recorded (with scalar fields) when a recorder is armed,
    printed as the familiar ``[channel] msg`` line unless quiet.
    """
    rec = _RECORDER
    if rec.enabled:
        rec.event(msg, track=channel, level=level, **fields)
    if _VERBOSITY != "quiet":
        print(f"[{channel}] {msg}", flush=True)


# ------------------------------------------------------------------ #
# CLI plumbing
# ------------------------------------------------------------------ #


def add_observability_args(parser):
    """Attach the shared --trace/--metrics/--memory/--quiet flags."""
    g = parser.add_argument_group("observability")
    g.add_argument("--trace", metavar="PATH", default=None,
                   help="write a Chrome-trace/Perfetto JSON here")
    g.add_argument("--metrics", metavar="PATH", default=None,
                   help="write the metrics snapshot JSON here")
    g.add_argument("--memory", metavar="PATH", default=None,
                   help="write the memory-ledger report JSON here "
                        "(tagged live/peak bytes + torch.cuda."
                        "memory_allocated reconciliation; arms the "
                        "recorder)")
    g.add_argument("--quiet", action="store_true",
                   help="suppress library progress lines on stdout")
    return parser


def configure_from_args(args):
    """Install a Recorder iff --trace/--metrics/--memory was passed;
    apply --quiet. Returns the active recorder either way."""
    if getattr(args, "quiet", False):
        set_verbosity("quiet")
    if getattr(args, "trace", None) or getattr(args, "metrics", None) \
            or getattr(args, "memory", None):
        return install()
    return get()


def write_outputs(args):
    """Flush --trace/--metrics/--memory files (no-op when absent)."""
    rec = get()
    if not rec.enabled:
        return
    trace = getattr(args, "trace", None)
    if trace:
        export.write_chrome_trace(rec, trace)
    metrics = getattr(args, "metrics", None)
    if metrics:
        export.write_metrics(rec, metrics)
    mem = getattr(args, "memory", None)
    if mem:
        memory.sample()          # final reconciliation before the dump
        import json
        with open(mem, "w") as f:
            json.dump(rec.memory.snapshot(), f, indent=1, sort_keys=True)
        log("obs", f"wrote memory ledger to {mem}")
