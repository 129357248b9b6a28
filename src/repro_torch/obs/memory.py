"""The measured memory ledger: tagged live-bytes + allocator reconciliation.

The port of ``repro/obs/memory.py`` onto torch. The paper's headline
claim is a *memory* tradeoff (ZO trains in nearly inference memory;
ElasticZO's BP tail adds 0.072-1.7%; INT8 cuts usage 1.46-1.60x); this is
the instrument that puts measurements beside the analytic tables
(Eqs. 2-4 / 13-15 in ``benchmarks/paper_tables.py``). Two layers:

  * **tagged registry** (``MemoryLedger``) -- each subsystem registers
    the buffers it owns under a dotted tag (``train.params``,
    ``train.batch``, ``serve.kv_pages``, ``serve.params``) with O(1)
    alloc/free accounting, per-tag and total high-water marks, and
    optional *keys* for double-free / leak detection. ``region(name)``
    brackets a code range and records its total-live high-water mark.
  * **sampling hook** (``sample``) -- reconciles the tagged total against
    ``torch.cuda.memory_allocated`` (and reports the byte counters of
    ``torch.cuda.memory_stats``), giving the **untagged residual**. A
    residual that grows is a subsystem allocating outside its tag.

Names: the reference's ``jax_live_bytes`` (a walk of
``jax.live_arrays()``) becomes ``torch_live_bytes`` here, in the sample
dict and in the ``memory.torch_live_bytes`` gauge; ``memory.tagged_bytes``
and ``memory.untagged_bytes`` keep the reference's names. On the CPU
there is no allocator to read, so ``torch_live_bytes`` and
``untagged_bytes`` are None and only the tagged gauge is set.

The reference's ``compiled_footprint`` reads XLA's buffer assignment of
a compiled step without running it. Eager PyTorch has no such plan, so
its counterpart, ``step_footprint``, runs the step: one warm step, then
one step measured with the caching allocator's peak, reported under the
reference's keys (``core/engine.py::step_memory_analysis`` calls it; the
paper harness puts it beside Eqs. 2-4 / 13-15).

Like every recorder primitive the ledger is numerics-inert: it reads
tensor metadata only (``numel``, ``element_size`` -- never a device
sync), and the NullRecorder carries a no-op ``NullMemoryLedger`` so
untagged processes pay one attribute check per call site.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, Optional

__all__ = ["MemoryLedger", "NullMemoryLedger", "tree_nbytes", "tree_tensors",
           "device_memory_stats", "sample", "step_footprint"]


def _leaves(tree):
    """The leaves of nested dicts, lists and tuples (a ``QTensor`` is a
    tuple of its data and exponent)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_tensors(tree):
    """The torch tensors of a nested structure, in walk order."""
    import torch
    return (t for t in _leaves(tree) if isinstance(t, torch.Tensor))


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors and arrays in a nested structure.

    A torch tensor counts ``numel * element_size``, a numpy array its
    ``nbytes``. Reads metadata only, so it is safe on the hot path. Other
    leaves (python scalars, None) contribute 0.
    """
    import numpy as np
    return (sum(t.numel() * t.element_size() for t in tree_tensors(tree))
            + sum(int(a.nbytes) for a in _leaves(tree)
                  if isinstance(a, np.ndarray)))


def _card(device=None):
    """The CUDA device to read, or None when no card is initialised (the
    ledger never initialises CUDA itself)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    return dev


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The byte-valued counters of ``torch.cuda.memory_stats``, or None
    without an initialised card."""
    import torch
    dev = _card(device)
    if dev is None:
        return None
    st = torch.cuda.memory_stats(dev)
    return {k: int(v) for k, v in st.items()
            if "bytes" in k and isinstance(v, (int, float))}


def step_footprint(step, state, batch, mask, device
                   ) -> Optional[Dict[str, int]]:
    """The device memory of one train step, measured on the card; None on
    the CPU, which has no allocator to read (as ``compiled_footprint``
    returns None where a backend has no memory analysis).

    ``step(state, batch, mask) -> (state, metrics)`` runs twice and
    consumes ``state`` (the ZO leaves are written in place). The first
    step is a warm-up: kernels built, and one-time workspaces allocated,
    such as the cuBLAS workspace of the autograd engine's thread at its
    first backward (32 MiB under ``CUBLAS_WORKSPACE_CONFIG=:4096:8``).
    Then ``reset_peak_memory_stats`` and the measured step. The keys are
    the reference's, read on the card as:

      * ``argument_bytes`` -- the step's inputs on the device: the
        state's params and the batch's device tensors;
      * ``output_bytes`` -- its outputs: the new params and the metrics;
      * ``alias_bytes`` -- outputs that are inputs' storage: the ZO
        leaves updated in place (XLA's donation credit);
      * ``temp_bytes`` -- the allocator's peak above what was allocated
        before the step, less the outputs it allocated: the
        intermediates live at the peak (activations, the perturbed
        copies, tail gradients);
      * ``peak_bytes`` -- argument + output + temp - alias: the inputs
        plus the step's peak growth, what the device must hold to run
        one step.
    """
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    state, _ = step(state, batch, mask)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    inputs = [t for t in tree_tensors((state.params, batch)) if t.is_cuda]
    arg = tree_nbytes(inputs)
    held = {t.data_ptr() for t in inputs}
    state, metrics = step(state, batch, mask)
    torch.cuda.synchronize(dev)
    growth = torch.cuda.max_memory_allocated(dev) - before
    outputs = [t for t in tree_tensors((state.params, metrics)) if t.is_cuda]
    out = tree_nbytes(outputs)
    alias = tree_nbytes([t for t in outputs if t.data_ptr() in held])
    temp = max(growth - (out - alias), 0)
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
            "alias_bytes": alias, "peak_bytes": arg + out + temp - alias}


class _Region:
    """An open total-live watermark bracket; ``with led.region("x"):``.

    Reads ``peak_bytes`` / ``floor_bytes`` after exit; the ledger also
    keeps a max-merged summary per region name in its snapshot.
    """

    __slots__ = ("ledger", "name", "floor_bytes", "peak_bytes")

    def __init__(self, ledger: "MemoryLedger", name: str):
        self.ledger = ledger
        self.name = name
        self.floor_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        led = self.ledger
        with led._lock:
            self.floor_bytes = self.peak_bytes = led.total_live
            led._open_regions.append(self)
        return self

    def __exit__(self, *exc):
        led = self.ledger
        with led._lock:
            led._open_regions.remove(self)
            r = led.regions.setdefault(
                self.name, {"count": 0, "peak_bytes": 0, "hwm_delta_bytes": 0})
            r["count"] += 1
            r["peak_bytes"] = max(r["peak_bytes"], self.peak_bytes)
            r["hwm_delta_bytes"] = max(r["hwm_delta_bytes"],
                                       self.peak_bytes - self.floor_bytes)
        return False


class _NullRegion:
    __slots__ = ()
    floor_bytes = 0
    peak_bytes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_REGION = _NullRegion()


class MemoryLedger:
    """Tagged live-bytes accounting with peaks, keys, and reconciliation.

    Two registration styles:

      * ``alloc(tag, nbytes, key=...)`` / ``free(tag, key=...)`` — paired
        lifetime tracking. A ``key`` (any hashable) arms double-alloc /
        double-free detection and lets ``free`` omit the size;
        ``leaks()`` lists whatever keyed allocations are still
        outstanding.
      * ``rebind(tag, nbytes, key)`` — idempotent registration for
        long-lived buffers that are *replaced*, not freed (params after
        an optimizer step): live bytes adjust by the delta.

    All mutation happens under one lock; reads used on hot paths
    (``total_live``) are plain attribute loads.
    """

    armed = True

    def __init__(self):
        self._lock = threading.Lock()
        self.live: Dict[str, int] = {}
        self.peak: Dict[str, int] = {}
        self.total_live = 0
        self.total_peak = 0
        self.n_allocs = 0
        self.n_frees = 0
        self.regions: Dict[str, Dict[str, int]] = {}
        self.last_sample: Optional[Dict[str, Any]] = None
        self._keyed: Dict[tuple, int] = {}
        self._open_regions: list = []

    # ---- registry ----------------------------------------------------- #
    def _bump(self, tag: str, delta: int):
        v = self.live.get(tag, 0) + delta
        self.live[tag] = v
        self.total_live += delta
        if v > self.peak.get(tag, 0):
            self.peak[tag] = v
        if self.total_live > self.total_peak:
            self.total_peak = self.total_live
        for r in self._open_regions:
            if self.total_live > r.peak_bytes:
                r.peak_bytes = self.total_live

    def alloc(self, tag: str, nbytes: int, key: Hashable = None) -> int:
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"alloc({tag!r}) with negative size {nbytes}")
        with self._lock:
            if key is not None:
                k = (tag, key)
                if k in self._keyed:
                    raise KeyError(f"double alloc of {tag}:{key!r}")
                self._keyed[k] = nbytes
            self._bump(tag, nbytes)
            self.n_allocs += 1
        return nbytes

    def free(self, tag: str, nbytes: Optional[int] = None,
             key: Hashable = None):
        with self._lock:
            if key is not None:
                k = (tag, key)
                if k not in self._keyed:
                    raise KeyError(
                        f"double free / unknown allocation {tag}:{key!r}")
                bound = self._keyed.pop(k)
                if nbytes is None:
                    nbytes = bound
                elif int(nbytes) != bound:
                    raise ValueError(
                        f"free({tag}:{key!r}) size {nbytes} != "
                        f"allocated {bound}")
            if nbytes is None:
                raise ValueError("free() needs nbytes or key")
            nbytes = int(nbytes)
            if nbytes > self.live.get(tag, 0):
                raise ValueError(
                    f"free({tag!r}) of {nbytes} bytes exceeds live "
                    f"{self.live.get(tag, 0)}")
            self._bump(tag, -nbytes)
            self.n_frees += 1

    def rebind(self, tag: str, nbytes: int, key: Hashable) -> int:
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"rebind({tag!r}) with negative size {nbytes}")
        with self._lock:
            k = (tag, key)
            old = self._keyed.get(k)
            if old is None:
                self.n_allocs += 1
                old = 0
            self._keyed[k] = nbytes
            self._bump(tag, nbytes - old)
        return nbytes

    def region(self, name: str) -> _Region:
        return _Region(self, name)

    def leaks(self) -> Dict[str, int]:
        """Outstanding keyed allocations as {"tag:key": nbytes}."""
        with self._lock:
            return {f"{tag}:{key}": nb
                    for (tag, key), nb in sorted(
                        self._keyed.items(), key=lambda kv: str(kv[0]))}

    # ---- reconciliation ----------------------------------------------- #
    def sample(self, device=None) -> Dict[str, Any]:
        """Reconcile tagged bytes against what the caching allocator holds.

        ``torch_live_bytes`` is ``torch.cuda.memory_allocated(device)``
        (``device`` defaults to the current card) and ``untagged_bytes``
        the residual: device memory no subsystem has claimed. It can be
        negative when a tag registers bytes that live on the host. Without
        an initialised card both are None: the CPU keeps no list of live
        tensors to walk, so nothing is reconciled there.
        """
        live = None
        dev = _card(device)
        if dev is not None:
            import torch
            live = int(torch.cuda.memory_allocated(dev))
        out: Dict[str, Any] = {
            "torch_live_bytes": live,
            "tagged_bytes": self.total_live,
            "untagged_bytes": None if live is None
            else live - self.total_live,
        }
        dstats = device_memory_stats(dev)
        if dstats is not None:
            out["device"] = dstats
        with self._lock:
            self.last_sample = out
        return out

    # ---- readback ----------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "live": dict(sorted(self.live.items())),
                "peak": dict(sorted(self.peak.items())),
                "total_live_bytes": self.total_live,
                "total_peak_bytes": self.total_peak,
                "n_allocs": self.n_allocs,
                "n_frees": self.n_frees,
                "n_outstanding": len(self._keyed),
                "regions": {k: dict(v)
                            for k, v in sorted(self.regions.items())},
                "sample": dict(self.last_sample) if self.last_sample else None,
            }

    def reset(self):
        with self._lock:
            self.live.clear()
            self.peak.clear()
            self.total_live = 0
            self.total_peak = 0
            self.n_allocs = 0
            self.n_frees = 0
            self.regions.clear()
            self.last_sample = None
            self._keyed.clear()
            self._open_regions.clear()


class NullMemoryLedger:
    """The no-op twin riding NullRecorder: every call disappears."""

    armed = False
    live: Dict[str, int] = {}
    peak: Dict[str, int] = {}
    total_live = 0
    total_peak = 0

    def alloc(self, tag, nbytes, key=None):
        return 0

    def free(self, tag, nbytes=None, key=None):
        pass

    def rebind(self, tag, nbytes, key):
        return 0

    def region(self, name):
        return _NULL_REGION

    def leaks(self):
        return {}

    def sample(self, device=None):
        return None

    def snapshot(self):
        return {}

    def reset(self):
        pass


def sample(device=None) -> Optional[Dict[str, Any]]:
    """Sample + reconcile via the installed recorder; sets the memory.*
    gauges (memory.tagged_bytes always; memory.torch_live_bytes and
    memory.untagged_bytes when a card was read). No-op (returns None)
    when no recorder is armed.
    """
    from . import get
    rec = get()
    led = rec.memory
    if not led.armed:
        return None
    s = led.sample(device)
    rec.gauge("memory.tagged_bytes").set(s["tagged_bytes"])
    if s["torch_live_bytes"] is not None:
        rec.gauge("memory.torch_live_bytes").set(s["torch_live_bytes"])
        rec.gauge("memory.untagged_bytes").set(s["untagged_bytes"])
    return s
