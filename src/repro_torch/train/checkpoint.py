"""Atomic, async, delta-capable checkpoints.

The port of ``repro/train/checkpoint.py``, on the same files:

  <dir>/step_<N>/
    manifest.json   - step, flat param keys, shapes, dtypes
    arrays.npz      - one entry per leaf ("0", "1", ... in key order)
    COMMIT          - written last; a checkpoint without it is ignored

Keys are the ``jax.tree_util.keystr`` paths of the leaves
(``['layer']['w']``, then ``.data`` / ``.exp`` for a ``QTensor``) in
JAX's leaf order (``core/zo.py::leaves_with_path``). npz cannot store
bfloat16: a bf16 leaf is saved as its uint16 bits with ``"bfloat16"`` in
the manifest, as the JAX package saves it. So a checkpoint written by
either package restores in the other. The label differs for periodic
checkpoints: the JAX train loop's step_<N> holds N + 1 steps, this
package's N (``train_loop.py``), so resuming the port's loop from a
periodic checkpoint of the JAX loop runs one step twice.

Delta mode (the fleet): ``save_delta`` writes ``ledger.bin``, a
seed-ledger slice, and a manifest with ``mode: "delta"`` and
``base_step``. Restoring it restores the full checkpoint at
``base_step`` and replays the slice through a ``replay_fn``
(``fleet/replay.py::make_replay_fn``).

Async: ``AsyncCheckpointer.save`` copies the leaves to host memory at
the call, then writes the files on a background thread.

Restores go onto a given device or the template leaves' devices, one
leaf at a time.

On a mesh (``run``, a ``sharding/collectives.py::MeshRun``, to save
with; ``shardings``, its ``descs``, to restore onto) a save gathers one
leaf at a time from every rank's shard and rank 0 writes today's files,
so a
checkpoint does not depend on the mesh that wrote it (and the JAX
package reads it); a restore reads each leaf and keeps the rank's slice,
so any mesh (or none) restores any checkpoint. ``AsyncCheckpointer``
gathers at the call, and rank 0 writes on its thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import zo
from ..core.int8 import QTensor


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array to save, logical dtype name) of one leaf: a host copy, so
    that an in-place update of the leaf after the call (the next step's
    ZO update) cannot reach a snapshot that a writer thread has yet to
    write."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_saved(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    """The tensor of an array read from a checkpoint (its own memory: no
    copy unless it is read-only)."""
    a = a if a.flags.writeable else a.copy()
    if dtype_str == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def flatten_with_keys(params) -> List[Tuple[str, Any]]:
    """(``jax.tree_util.keystr`` path, array) pairs in JAX's leaf order;
    a ``QTensor`` leaf gives two, its ``.data`` and its ``.exp``."""
    out = []
    for path, leaf in zo.leaves_with_path(params):
        key = zo.keystr(path)
        if isinstance(leaf, QTensor):
            out += [(key + ".data", leaf.data), (key + ".exp", leaf.exp)]
        else:
            out.append((key, leaf))
    return out


def _snapshot(params, run=None) -> Optional[Dict[str, Tuple[np.ndarray,
                                                               str]]]:
    """Host copies of every leaf by key. On a mesh (``run``) every rank
    takes part in gathering each global leaf in turn, and rank 0 alone
    gets the snapshot (the others None)."""
    if run is None:
        return {k: _host(v) for k, v in flatten_with_keys(params)}
    out = {}
    for path, leaf in zo.leaves_with_path(params):
        full = run.gather_leaf(path, leaf)
        if run.rank == 0:
            out[zo.keystr(path)] = _host(full)
        del full
    return out if run.rank == 0 else None


def _barrier(run):
    if run is not None:
        import torch.distributed as dist
        dist.barrier()


def _atomic_commit(ckpt_dir: str | Path, step: int, manifest: Dict,
                   write_payload) -> Path:
    """The tmp-dir / manifest / COMMIT / rename sequence: readers only
    ever see complete checkpoints (a leftover ``*.tmp`` dir, even one
    holding COMMIT, is ignored)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    write_payload(tmp)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if d.exists():
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def _array_manifest(step: int, arrays: Dict[str, Tuple[np.ndarray, str]],
                    extra: Optional[Dict]) -> Dict:
    return {
        "step": int(step),
        "mode": "full",
        "time": time.time(),            # wall-clock stamp of the manifest
        "keys": list(arrays.keys()),
        "shapes": [list(a.shape) for a, _ in arrays.values()],
        "dtypes": [dt for _, dt in arrays.values()],
        "extra": extra or {},
    }


def _write_arrays(tmp: Path, arrays: Dict[str, Tuple[np.ndarray, str]]):
    np.savez(tmp / "arrays.npz",
             **{str(i): a for i, (a, _) in enumerate(arrays.values())})


def save(ckpt_dir: str | Path, step: int, params, extra: Optional[Dict] = None,
         run=None):
    """Synchronous save with atomic commit. On a mesh (``run``, the
    ``MeshRun``) every rank calls it; rank 0 writes, and every rank
    returns once the checkpoint is committed. Returns its directory."""
    arrays = _snapshot(params, run)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if arrays is not None:
        d = _atomic_commit(ckpt_dir, step,
                           _array_manifest(step, arrays, extra),
                           lambda tmp: _write_arrays(tmp, arrays))
    _barrier(run)
    return d


def save_delta(ckpt_dir: str | Path, step: int, base_step: int,
               ledger_bytes: bytes, extra: Optional[Dict] = None):
    """Checkpoint step ``step`` as (base_step, ledger slice), no arrays.

    The slice covers commits [base_step, step), and a committed full
    checkpoint must exist at base_step in the same directory (a delta of
    a delta is not supported).
    """
    manifest = {"step": int(step), "mode": "delta",
                "base_step": int(base_step), "time": time.time(),
                "extra": extra or {}}
    led = obs.get().memory
    if led.armed:
        led.alloc("ckpt.delta", len(ledger_bytes))
    return _atomic_commit(ckpt_dir, step, manifest,
                          lambda tmp: (tmp / "ledger.bin")
                          .write_bytes(ledger_bytes))


class AsyncCheckpointer:
    """Snapshot on the call, write on a thread; one save in flight."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3, run=None):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.run = run
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, params, extra=None):
        """Snapshots now (on a mesh every rank takes part in the gather)
        and writes on a thread (rank 0)."""
        self.wait()
        snapshot = _snapshot(params, self.run)
        if snapshot is None:
            return
        led = obs.get().memory
        key = ("ckpt.pending", id(self), step)
        if led.armed:
            # the host snapshot is live until the writer thread is done
            led.alloc("ckpt.pending",
                      sum(a.nbytes for a, _ in snapshot.values()), key=key)

        def _write():
            try:
                _atomic_commit(self.dir, step,
                               _array_manifest(step, snapshot, extra),
                               lambda tmp: _write_arrays(tmp, snapshot))
                self._gc()
            finally:
                if led.armed:
                    led.free("ckpt.pending", key=key)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        """Joins the writer; on a mesh every rank returns once it is
        done."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.run)

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for old in steps[:-self.keep]:
            if (old / "COMMIT").exists():
                shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    # only renamed (complete) dirs count, not a step_<N>.tmp with COMMIT
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "COMMIT").exists() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, template, step: Optional[int] = None,
            replay_fn=None, device=None, shardings=None) -> Tuple[Any, int]:
    """Restore into ``template``'s tree structure with the saved dtypes,
    each leaf onto ``device`` when given, else onto its template leaf's
    device. Returns (params, step). A template of ``meta`` tensors (shapes
    only, ``core/api.py::abstract_params``) needs ``device``. The leaves
    are read one at a time, so the host holds one leaf at most.

    Delta checkpoints also need ``replay_fn(params, ledger_bytes,
    base_step, step) -> params``: the full checkpoint at the base is
    restored first, then the ledger slice is replayed on top.

    ``shardings``: a tree like ``template`` of this rank's
    ``sharding/params.py::ShardDesc``s (``MeshRun.descs``): each leaf is
    read whole and the rank's slice kept. The template's shapes are then
    the global ones (``core/api.py::abstract_params``) or the shards'.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest.get("mode", "full") == "delta":
        if replay_fn is None:
            raise ValueError(
                f"checkpoint at step {step} is a ledger delta (base "
                f"{manifest['base_step']}); pass replay_fn to restore it")
        base_step = int(manifest["base_step"])
        params, _ = restore(ckpt_dir, template, step=base_step,
                            device=device, shardings=shardings)
        params = replay_fn(params, (d / "ledger.bin").read_bytes(),
                           base_step, step)
        return params, int(manifest["step"])
    index = {k: i for i, k in enumerate(manifest["keys"])}
    missing = {k for k, _ in flatten_with_keys(template)} - set(index)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    with np.load(d / "arrays.npz") as z:
        def load(key, like, desc=None):
            i = index[key]
            t = _from_saved(z[str(i)], manifest["dtypes"][i])
            if desc is not None:
                from ..sharding.params import shard_leaf
                t = shard_leaf(t, desc)
            if not isinstance(like, torch.Tensor):
                return t
            dev = torch.device(device) if device is not None else like.device
            if dev.type == "meta":
                raise ValueError("a template of meta tensors needs a device "
                                 "to restore onto")
            return t.to(dev)

        def leaf(path, v):
            key = zo.keystr(path)
            if isinstance(v, QTensor):
                return QTensor(load(key + ".data", v.data),
                               load(key + ".exp", v.exp))
            return load(key, v, zo._at(shardings, path))
        return zo.map_with_path(leaf, template), int(manifest["step"])
