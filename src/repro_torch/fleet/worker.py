"""Fleet worker: probe evaluation, record production, commit application.

The port of ``repro/fleet/worker.py``. A worker's step has two halves:

  * compute: its probe block's antithetic loss pairs on the step's batch
    and the BP-tail gradient at the perturbed points (fp32 lane: Alg. 1's
    avg_perturbed mode, the head perturbed through ``zo_perturb`` and its
    attention through ``flash_attention``; int8 lane: Alg. 2's integer
    forward pair through ``int8_perturb`` and ``int8_matmul``, and the
    NITI tail), on the update engine's own phases (``core/engine.py``);
  * protocol, on the host: publish the Record (fp32: the tail quantised
    with error feedback; int8: the tail update is int8 already), and on a
    commit apply the step through ``fleet/replay.py``.

``make_probe_fn`` / ``make_int8_probe_fn`` / ``make_quantize_fn`` build
one callable each that every worker and the single-process reference
share: the same ops on the same inputs give the same bits. The fp32
probe runs with deterministic algorithms (``core/api.py``), so no
backward of the tail sums with atomics in an order that varies between
participants; the int8 lane's arithmetic is integer and exact in any
order.

Error-feedback residuals (fp32 lane only) are crash-consistent by
protocol: a worker whose record is not in the commit resets its
residual, so a restarted worker with a zero residual is
indistinguishable from an unlucky one, and ledger replay needs no
residual state.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..configs.base import LaneConfig
from ..core import api, elastic, keys, prng, zo
from ..core.engine import Int8Engine, _value_and_grad
from ..core.int_loss import float_loss
from ..train import checkpoint as ckpt
from ..train.compress import compress_tree
from .commit_rule import committed_arrays
from .ledger import Commit, Ledger, Record
from .replay import (ReplaySchema, apply_committed, params_device,
                     probe_seeds, replay)


def _probe_seeds(base_seed, step: int, probe_ids, device) -> torch.Tensor:
    """int32 [m] on ``device``: seed_from_key(fold_in(fold_in(base,
    step), id)) for each global probe id."""
    key = keys.fold_in(np.asarray(base_seed, np.uint32), step)
    return zo.device_seeds(
        [prng.seed_from_key(keys.fold_in(key, int(i))) for i in probe_ids],
        device)


def make_probe_fn(loss_fn: Callable, lane: LaneConfig, partition_fn=None):
    """(params, batch, step, probe_ids, base_seed) -> (l_plus f32[m],
    l_minus f32[m], tail_grad_sum: an f32 tree shaped like the tail).

    probe_ids are global probe indices: the key schedule is
    fold_in(fold_in(base, step), probe_id), as in the reference and
    ``replay.probe_seeds``, so probe ownership can move between workers
    without changing the noise. The tail sum adds (g+ + g-) * 0.5 in f32
    probe by probe, starting from zeros.
    """
    if partition_fn is None:
        partition_fn = lambda p: elastic.partition(p, lane)  # noqa: E731
    if lane.bp_grad_mode != "avg_perturbed":
        raise ValueError(
            "fleet protocol ships Alg. 1 avg_perturbed tail grads, got "
            f"bp_grad_mode={lane.bp_grad_mode!r}")
    eps = lane.zo_eps

    def probe_eval(params, batch, step, probe_ids, base_seed):
        zo_part, bp_part = partition_fn(params)
        has_tail = bool(zo.leaves(bp_part))
        seeds = _probe_seeds(base_seed, step, probe_ids, params_device(zo_part))

        def tail_loss(bp, zo_pert):
            return loss_fn(elastic.merge(zo_pert, bp), batch)

        lps, lms = [], []
        tail_sum = [torch.zeros(x.shape, dtype=torch.float32,
                                device=x.device)
                    for x in zo.leaves(bp_part)]
        with api.deterministic():
            for j in range(len(probe_ids)):
                seed = seeds[j:j + 1]
                if has_tail:
                    zp = zo.perturb(zo_part, seed, eps)
                    lp, gp = _value_and_grad(tail_loss, bp_part, zp)
                    del zp                      # free +eps before -eps
                    zm = zo.perturb(zo_part, seed, -eps)
                    lm, gm = _value_and_grad(tail_loss, bp_part, zm)
                    del zm
                    tail_sum = [t + (a.to(torch.float32)
                                     + b.to(torch.float32)) * 0.5
                                for t, a, b in zip(tail_sum, gp, gm)]
                    del gp, gm
                else:
                    with torch.no_grad():
                        zp = zo.perturb(zo_part, seed, eps)
                        lp = loss_fn(elastic.merge(zp, bp_part), batch)
                        del zp
                        zm = zo.perturb(zo_part, seed, -eps)
                        lm = loss_fn(elastic.merge(zm, bp_part), batch)
                        del zm
                lps.append(lp)
                lms.append(lm)
        return torch.stack(lps), torch.stack(lms), \
            zo.rebuild(bp_part, tail_sum)

    return probe_eval


def make_int8_probe_fn(forward: Callable, lane: LaneConfig, partition_fn,
                       tail_fcs: List[Tuple[str, str]],
                       loss_mode: Optional[str] = None):
    """(params, batch, step, probe_ids, base_seed) -> (gs int32[m], tail
    payload {layer: int8 update} over every bp layer, loss f32[m]): the
    int8-lane twin of ``make_probe_fn`` on the engine's Alg. 2 phases.

    The payload is the saturating int8 combine of the worker's per-probe
    NITI updates, the record's wire value exactly (no error feedback).
    """
    engine = Int8Engine(lane, partition_fn, tail_fcs=tail_fcs,
                        loss_mode=loss_mode)

    def probe_eval(params, batch, step, probe_ids, base_seed):
        zo_part, bp_part = engine.partition(params)
        seeds = _probe_seeds(base_seed, step, probe_ids, batch["y"].device)
        gs, losses, upds_list = [], [], []
        for j in range(len(probe_ids)):
            g, logits_p, acts_p = engine.probe_pair(
                forward, zo_part, bp_part, batch, seeds[j:j + 1])
            gs.append(g)
            losses.append(float_loss(logits_p, batch["y"]))
            upds_list.append(engine.tail_updates(bp_part, acts_p, logits_p,
                                                 batch["y"]))
        combined = engine.combine_tail(upds_list)
        # full bp coverage (zeros for layers outside the tail FCs), so the
        # flat payload aligns with the schema's QTensor-leaf order
        payload = {name: combined[name] if name in combined else
                   torch.zeros(sub["w"].data.shape, dtype=torch.int8,
                               device=sub["w"].data.device)
                   for name, sub in bp_part.items()}
        return torch.stack(gs), payload, torch.stack(losses)

    return probe_eval


def make_quantize_fn():
    """Error-feedback int8 compression (``train/compress.py``)."""
    return compress_tree


def zero_residual(schema: ReplaySchema, device=None):
    if schema.numerics == "int8":
        return None          # int8 tail payloads are exact: no residual
    return zo.rebuild(
        schema.tail_template,
        [torch.zeros(s, dtype=torch.float32, device=device)
         for s in schema.tail_shapes])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def compute_record(params, residual, batch, step: int, worker: int,
                   schema: ReplaySchema, probe_fn, quantize_fn):
    """(Record, pending_residual): the one producer of wire records, used
    by live workers and the single-process reference alike, so a record's
    bytes are a function of (params, batch, step, worker, residual)."""
    m = schema.fleet.probes_per_worker
    ids = list(range(worker * m, (worker + 1) * m))
    seeds = probe_seeds(schema, step)[worker * m:(worker + 1) * m]
    if schema.numerics == "int8":
        gs, payload, losses = probe_fn(params, batch, step, ids,
                                       schema.base_seed)
        rec = Record(
            step=step, worker=worker, seeds=seeds,
            deltas=_host(gs).astype(np.int8),
            loss=float(np.float32(np.mean(_host(losses).astype(np.float32)))),
            tail_q=[_host(x).astype(np.int8).reshape(-1)
                    for x in zo.leaves(payload)],
            numerics="int8")
        return rec, None
    lp, lm, tail = probe_fn(params, batch, step, ids, schema.base_seed)
    lp = _host(lp).astype(np.float32)
    lm = _host(lm).astype(np.float32)
    q_tree, s_tree, new_res = quantize_fn(tail, residual)
    scales = zo.leaves(s_tree)
    rec = Record(
        step=step, worker=worker,
        seeds=seeds,
        deltas=lp - lm,
        loss=float(np.float32(np.mean(np.float32(0.5) * (lp + lm)))),
        tail_q=[_host(x).reshape(-1) for x in zo.leaves(q_tree)],
        tail_scales=_host(torch.stack(scales)).astype(np.float32)
        if scales else np.zeros((0,), np.float32))
    return rec, new_res


class Worker:
    """One simulated edge device. Owns params, an EF residual (fp32
    lane) and its probe block; everything else arrives over the (chaos)
    transport."""

    def __init__(self, worker_id: int, params, schema: ReplaySchema,
                 probe_fn, quantize_fn=None, ckpt_dir: Optional[str] = None):
        self.id = worker_id
        self.schema = schema
        self.params = params
        self.device = params_device(params)
        self.residual = zero_residual(schema, self.device)
        self.probe_fn = probe_fn
        self.quantize_fn = quantize_fn
        self.ckpt_dir = ckpt_dir
        self.step = 0
        self.alive = True
        self.catchup_bytes = 0
        self._pending_residual = None
        self._tag_params()

    def _tag_params(self):
        """Re-register this device's parameter copy with the memory
        ledger (rebind: idempotent; a crash rebinds to 0, a restart
        back)."""
        led = obs.get().memory
        if led.armed:
            led.rebind("fleet.worker.params",
                       obs.memory.tree_nbytes(self.params),
                       key=("worker", id(self)))

    # ---- live path ----------------------------------------------------- #
    def compute_record(self, step: int, batch) -> Record:
        if not (self.alive and step == self.step):
            raise RuntimeError(
                f"worker {self.id}: compute_record(step={step}) but "
                f"alive={self.alive}, own step={self.step}")
        rec, self._pending_residual = compute_record(
            self.params, self.residual, batch, step, self.id, self.schema,
            self.probe_fn, self.quantize_fn)
        return rec

    def apply_commit(self, step: int, commit: Commit, records,
                     new_params=None):
        """Advance to the committed params. ``new_params`` short-circuits
        the derivation when the caller already holds the canon for this
        commit (a gossip peer's closer applied it once already); the
        residual and checkpoint protocol runs either way."""
        if not (self.alive and step == self.step):
            raise RuntimeError(
                f"worker {self.id}: apply_commit(step={step}) but "
                f"alive={self.alive}, own step={self.step}")
        if new_params is None:
            cstep = committed_arrays(commit, records, self.schema)
            new_params = apply_committed(self.params, step, cstep,
                                         self.schema)
        self.params = new_params
        accepted = bool(commit.accepted >> self.id & 1)
        self.residual = (self._pending_residual if accepted
                         else zero_residual(self.schema, self.device))
        self._pending_residual = None
        self.step = step + 1
        every = self.schema.fleet.local_ckpt_every
        if self.ckpt_dir and every and self.step % every == 0:
            ckpt.save(self.ckpt_dir, self.step, self.params)

    # ---- failure / recovery -------------------------------------------- #
    def crash(self):
        """Lose all volatile state (params, residual, pending record)."""
        self.alive = False
        self.params = None
        self.residual = None
        self._pending_residual = None
        self._tag_params()

    def restart(self, donor, now_step: int):
        """Catch up to ``now_step`` by ledger replay, not checkpoint copy.

        ``donor`` is any canon keeper with ``template()``,
        ``nearest_snapshot()`` and a ``ledger``: the star coordinator or a
        surviving GossipPeer. The base is the worker's own local
        checkpoint if it has one, else the donor's nearest snapshot; the
        [base, now) ledger slice then replays in one fused pass. The
        residual restarts at zero. Returns (base_step, slice_bytes) so
        leaderless peers can adopt the same slice into their closing
        state.
        """
        base_step, base_params = None, None
        if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
            base_params, base_step = ckpt.restore(self.ckpt_dir,
                                                  donor.template())
        # a gossip donor that itself rejoined holds the ledger only from
        # its own replay base; a local checkpoint older than that would
        # replay across a gap, so take the donor's snapshot instead
        since = getattr(donor, "ledger_since", 0)
        if base_step is None or base_step > now_step or base_step < since:
            base_step, base_params = donor.nearest_snapshot(now_step)
        slice_bytes = donor.ledger.slice_bytes(base_step, now_step)
        self.catchup_bytes += len(slice_bytes)
        self.params = replay(base_params, Ledger.from_bytes(slice_bytes),
                             self.schema, base_step, now_step)
        self.residual = zero_residual(self.schema, self.device)
        self.step = now_step
        self.alive = True
        self._tag_params()
        return base_step, slice_bytes
