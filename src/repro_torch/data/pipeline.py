"""The host data pipeline: batches by step, put on the device ahead of use.

The port of ``repro/data/pipeline.py``. Batches are pure functions of the
step index (``data/synthetic.py``), so the pipeline carries no state but
the step: a restart at step k replays the same stream, and resume is a
function of the checkpointed step (``train/elastic_runtime.py``).

``Prefetcher`` makes the next batches on a worker thread while the card
runs the current step. The worker does host work only: it calls the
batch function, casts, and copies the arrays into pinned host buffers.
``get`` runs on the caller's thread: on a card it issues the host to
device copies without blocking on a side stream, makes the caller's
stream wait for them, and marks each tensor as used on the caller's
stream (``record_stream``), so that the caching allocator does not hand
its block to the side stream again before the step that reads it is
done. A failure in the worker is raised from ``get`` (the reference's
``get`` would block forever). The reference's ``shardings`` argument is
a ``device`` here; on a mesh each rank makes the same global batch (a
function of the step) and keeps its rows (``lm_batch_fn(..., rows=)``,
``rank_rows``).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.api import resolve_device
from . import synthetic

HostBatch = Dict[str, np.ndarray]


def rank_rows(shape: ShapeConfig, rules, coords) -> slice:
    """This rank's rows of the global batch (``core/api.py::
    batch_shardings``: over the rules' batch axes, every row for a batch
    those axes do not divide), at mesh ``coords``."""
    from ..core.api import batch_shardings
    from ..sharding.collectives import rows_slice
    B = shape.global_batch
    spec = batch_shardings({"tokens": (B, shape.seq_len)}, rules)["tokens"]
    return rows_slice(B, spec[0] if spec else None, coords, rules.sizes)


def lm_batch_fn(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                rows: Optional[slice] = None) -> Callable[[int], HostBatch]:
    """step -> host batch dict for the LM train step: ``tokens``,
    ``labels`` (int32 [B, S_tok]) and ``mask`` (f32), with f32 zero
    ``frames`` [B, encoder_seq, d] for an encoder and ``img`` [B,
    num_image_tokens, d] for image tokens; ``S_tok = seq_len -
    num_image_tokens``. ``rows``: keep these rows of the global batch (a
    rank's, ``rank_rows``), of every entry: ``frames`` and ``img``
    follow the tokens' rows in every strategy."""
    if rows is not None:
        whole = lm_batch_fn(cfg, shape, seed)
        return lambda step: {k: np.ascontiguousarray(v[rows])
                             for k, v in whole(step).items()}
    S_tok = shape.seq_len - (cfg.num_image_tokens or 0)

    def fn(step: int) -> HostBatch:
        x, y, m = synthetic.token_batch(shape.global_batch, S_tok,
                                        cfg.vocab_size, seed=seed, step=step)
        b: Dict[str, Any] = {"tokens": x, "labels": y, "mask": m}
        if cfg.encoder_layers:
            b["frames"] = np.zeros(
                (shape.global_batch, cfg.encoder_seq, cfg.d_model),
                np.float32)
        if cfg.num_image_tokens:
            b["img"] = np.zeros(
                (shape.global_batch, cfg.num_image_tokens, cfg.d_model),
                np.float32)
        return b
    return fn


def stub_dtypes(cfg: ModelConfig) -> Dict[str, torch.dtype]:
    """The ``dtypes`` that keep an LM batch's ``frames`` and ``img`` in
    the config's dtype, as ``core/api.py::stub_inputs`` makes them."""
    dt = getattr(torch, cfg.dtype)
    return {k: dt for k in ("frames", "img")}


def _host_tensor(v: np.ndarray, dt: Optional[torch.dtype]) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.to(dt) if dt is not None else t


def device_put_batch(batch: HostBatch, device=None,
                     dtypes: Optional[Dict[str, torch.dtype]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The host batch on ``device`` (the card unless the caller passes
    another), each array cast to its entry in ``dtypes`` first. A
    blocking copy."""
    dev = resolve_device(device)
    return {k: _host_tensor(v, (dtypes or {}).get(k)).to(dev)
            for k, v in batch.items()}


_ERROR = object()                # the worker's failure marker in the queue


class Prefetcher:
    """Host batches made ahead on a thread, handed over on ``device``.

    ``get() -> (step, batch on device)`` in step order from
    ``start_step``, on the card unless the caller passes another device;
    ``depth`` batches wait at most, each made once. Restarting at step k
    replays the same stream. ``close()`` stops and joins the worker (also
    on leaving a ``with`` block). On the CPU ``get`` is
    ``device_put_batch`` of the worker's batch.
    """

    def __init__(self, batch_fn: Callable[[int], HostBatch], start_step: int,
                 device=None, dtypes: Optional[Dict[str, torch.dtype]] = None,
                 depth: int = 2):
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.dtypes = dtypes or {}
        self._pin = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._pin else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker,
                                        args=(start_step,), daemon=True)
        self._thread.start()

    def _host(self, step: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in self.batch_fn(step).items():
            t = _host_tensor(v, self.dtypes.get(k))
            out[k] = t.pin_memory() if self._pin else t
        return out

    def _put(self, item):
        """Blocks until ``item`` is queued or the prefetcher is closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self, step: int):
        try:
            while not self._stop.is_set():
                self._put((step, self._host(step)))
                step += 1
        except Exception as e:      # handed to get(), raised there
            self._put((_ERROR, e))

    def get(self):
        if self._stop.is_set():
            raise RuntimeError("get() on a closed Prefetcher")
        if self._error is not None:
            raise RuntimeError("the prefetch worker failed") from self._error
        while True:
            try:
                step, host = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("the prefetch worker has stopped")
        if step is _ERROR:
            self._error = host
            raise RuntimeError("the prefetch worker failed") from host
        if not self._pin:
            return step, {k: t.to(self.device) for k, t in host.items()}
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            batch = {k: t.to(self.device, non_blocking=True)
                     for k, t in host.items()}
        consumer.wait_stream(self._stream)
        for t in batch.values():
            t.record_stream(consumer)
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
