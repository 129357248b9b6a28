"""Single-process reference of the fleet semantics, for train_loop.run.

The port of ``repro/fleet/reference.py``. A W-worker chaos run must
reproduce a single-process run bit for bit, in both lanes and with
Byzantine workers in the loop. This module is that single process: one
step function that computes every worker's probe block (fp32: each
worker's tail quantised with its own error-feedback residual; int8:
exact NITI payloads, no residual), applies the same deterministic
record tampering (``fleet/adversary.py``), routes the result through the
same Byzantine-robust gate (``fleet/robust.py``) the coordinator runs,
and applies the same engine-routed replay update, with the very
callables the fleet workers use (``worker.make_probe_fn`` /
``make_int8_probe_fn`` / ``make_quantize_fn``).

Two driving modes, selected by the schema:

  * filter-free (fleet.robust is None and no byzantine specs): the
    probe_mask fed by ``LoopConfig.mask_fn`` is the realised commit mask
    of a fleet run;
  * Byzantine (a robust config or byzantine specs): the probe_mask is the
    realised candidate mask (``FleetResult.arrival_masks``); the
    reference re-derives validation, quarantine and the filter itself
    through the commit-rule pipeline (``fleet/commit_rule.py``) and its
    own RobustGate, and must land on the same Commit (v2) and parameter
    stream, whichever topology produced the masks.

Worker-local state (the fp32 EF residuals) rides inside ``state.params``
as ``{"model": ..., "residual": [one tail tree per worker]}``, so a
restart is a function of the checkpointed state. The int8 lane has no
residual; the slot holds Nones. A Byzantine worker's residual follows
the honest pending residual: tampering is wire-only, as in the fleet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import LaneConfig
from ..core.elastic import TrainState
from .adversary import Adversary, build_adversaries
from .commit_rule import close_candidates, committed_arrays, step_loss
from .ledger import Commit
from .replay import (ReplaySchema, apply_committed, params_device,
                     probe_seeds)
from .robust import RobustGate
from .worker import (compute_record, make_probe_fn, make_quantize_fn,
                     zero_residual)


def reference_state(params, schema: ReplaySchema, seed) -> TrainState:
    """Initial TrainState with per-worker EF residuals alongside the model."""
    device = params_device(params)
    residual = [zero_residual(schema, device)
                for _ in range(schema.fleet.num_workers)]
    return TrainState({"model": params, "residual": residual}, 0,
                      np.asarray(seed, np.uint32))


def make_reference_step(loss_fn: Callable, schema: ReplaySchema,
                        probe_fn=None, quantize_fn=None,
                        adversaries: Optional[Dict[int, Adversary]] = None):
    """(state, batch, probe_mask) -> (state, metrics), fleet semantics.

    probe_mask fp32[n_probes] is block-constant per worker; pass the
    realized masks of a fleet run via LoopConfig.mask_fn to reproduce it
    (arrival_masks for Byzantine runs, masks otherwise), or a drop-rate
    stream to simulate one. For the int8 lane pass the shared
    ``probe_fn`` built by worker.make_int8_probe_fn (there is no
    loss_fn-derived default). ``adversaries`` defaults to the schema's
    own byzantine specs — pass {} to force the honest reference.
    """
    lane: LaneConfig = schema.lane
    fleet = schema.fleet
    W, m = fleet.num_workers, fleet.probes_per_worker
    if probe_fn is None:
        if schema.numerics != "fp32":
            raise ValueError(
                "int8 reference needs the shared make_int8_probe_fn "
                "callable")
        probe_fn = make_probe_fn(loss_fn, lane, schema.partition_fn)
    if quantize_fn is None and schema.numerics == "fp32":
        quantize_fn = make_quantize_fn()
    if adversaries is None:
        adversaries = build_adversaries(fleet)
    byzantine_path = bool(adversaries) or fleet.robust is not None
    gate = RobustGate(schema) if byzantine_path else None

    def step(state: TrainState, batch, probe_mask):
        t = int(state.step)
        model = state.params["model"]
        residuals = state.params["residual"]
        mask = np.asarray(probe_mask, np.float32)
        if mask.shape != (W * m,):
            raise ValueError(f"probe_mask shape {mask.shape} != "
                             f"({W * m},) for {W} workers x {m} probes")

        records, pendings = {}, {}
        for w in range(W):
            rec, pending = compute_record(model, residuals[w], batch, t, w,
                                          schema, probe_fn, quantize_fn)
            if w in adversaries:
                rec = adversaries[w].tamper(rec, t)
            records[w] = rec
            pendings[w] = pending

        if byzantine_path:
            # probe_mask = realized CANDIDATE mask (on-time | late-
            # admitted): close exactly like any leaderless closer — the
            # verbatim commit_rule pipeline (validation -> quarantine ->
            # filter), which over an all-on-time candidate set is the
            # coordinator's final gate verdict
            candidates = {w: records[w] for w in range(W) if mask[w * m] > 0}
            outcome = close_candidates(gate, t, candidates)
            gate.advance(t, outcome)
            commit = outcome.commit
        else:
            accepted_bits = 0
            for w in range(W):
                if mask[w * m] > 0:
                    accepted_bits |= 1 << w
            commit = Commit(t, accepted_bits)

        device = params_device(model)
        new_residuals = []
        for w in range(W):
            if commit.accepted >> w & 1:
                new_residuals.append(pendings[w])
            else:
                new_residuals.append(zero_residual(schema, device))
        cstep = committed_arrays(commit, records, schema)
        new_model = apply_committed(model, t, cstep, schema)
        # the canonical loss observation — a no-op step carries the
        # previous loss, exactly like every closer's loss_history
        loss = step_loss(cstep, schema, step.prev_loss)
        step.prev_loss = loss
        if schema.numerics == "int8":
            g = np.abs(np.asarray(cstep.deltas, np.float32))
        else:
            g = np.abs(np.asarray(cstep.deltas, np.float32)) \
                / np.float32(2.0 * lane.zo_eps)
        metrics = {"loss": torch.tensor(loss, dtype=torch.float32),
                   "zo_g": torch.tensor(float(np.sum(g)) / (W * m),
                                        dtype=torch.float32)}
        step.commits.append(commit)
        return TrainState({"model": new_model, "residual": new_residuals},
                          state.step + 1, state.seed), metrics

    step.commits = []     # derived Commit stream, for test cross-checks
    step.prev_loss = None  # carried across steps by step_loss
    return step


__all__ = ["make_reference_step", "reference_state", "probe_seeds"]
