"""THE step-closing rule: one pure pipeline, every participant.

PR 2-4 made a committed step a pure function of ``(records, accepted
mask)``; this module makes the *closing* of a step a pure function of
``(gate state, arrivals)`` so that no particular node has to own it.
The pipeline — deadline gate -> never-empty fallback pick -> validation/
quarantine/robust filter -> admit-late-on-empty-gate -> Commit — is
invoked verbatim by:

  * the star coordinator (fleet/coordinator.py),
  * every leaderless gossip peer (fleet/gossip.py) — all peers of a
    connected component see the same arrival multiset after epidemic
    exchange, so they derive the **bit-identical** Commit v2 without a
    round of consensus,
  * the single-process reference (fleet/reference.py), which replays a
    realized candidate mask as synthetic on-time arrivals,
  * cold ledger replay (fleet/replay.py), through ``committed_arrays``
    — the one commit -> post-filter arrays + tail-eligibility
    derivation, cross-checked against the commit's carried filter bits.

Determinism rules (docs/fleet.md, "Leaderless commits"):

  * deadline gating judges a record by its **origin fate** — the
    publication fate ``ChaosTransport.fate(step, worker)``, a pure
    function of the chaos seed — never by the path it took to reach a
    given peer, so every holder of a record agrees on its timeliness;
  * when nobody makes the deadline, the fallback picks the earliest
    delivery (or, if the transport dropped everything, the earliest
    *retry* — reported to the caller so the redelivery is accounted,
    never phantom-committed); ties on delay break toward the
    **highest worker id** — the leaderless tiebreak;
  * the gate-empty path admits late deliveries one at a time in the
    same (delay, highest-id) order until a sound record commits, or
    commits empty (an exact parameter no-op).

Everything here is host-side scalar math over wire records — no jax, no
model state — so closing a step is exactly as cheap for a gossip peer
as it was for the coordinator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ledger import Commit, Record
from .transport import Fate

# ------------------------------------------------------------------ #
# commit -> post-filter arrays + tail eligibility (consumer side)
# ------------------------------------------------------------------ #


@dataclass(frozen=True)
class CommittedStep:
    """One committed step, fully derived: post-filter wire arrays plus
    the tail-eligible worker set. ``tail_ws`` is the satellite fix for
    the PR 4 all-or-nothing rule: a worker whose *loss-consistency*
    channel passed keeps its BP-tail contribution even when individual
    ZO probes were band-rejected — only a lying loss (which poisons the
    whole record) or non-acceptance drops the tail."""
    commit: Commit
    records: Dict[int, Record]
    seeds: np.ndarray            # uint64[n], 0 where masked
    deltas: np.ndarray           # fp32 loss-diffs | int8 signs, 0 masked
    mask: np.ndarray             # f32[n] post-filter probe mask
    tail_ws: Tuple[int, ...]     # sorted workers whose tail enters the update


def raw_arrays(commit: Commit, records: Dict[int, Record], schema):
    """Pre-filter (seeds, deltas, mask) straight off the commit bitmask.
    Masked probes carry seed 0 / delta 0 — their coefficient is exactly
    zero, so the seed value never reaches the parameters."""
    n, m = schema.n_probes, schema.fleet.probes_per_worker
    seeds = np.zeros((n,), np.uint64)
    deltas = np.zeros(
        (n,), np.int8 if schema.numerics == "int8" else np.float32)
    mask = np.zeros((n,), np.float32)
    for w in commit.workers(schema.fleet.num_workers):
        rec = records[w]
        sl = slice(w * m, (w + 1) * m)
        seeds[sl] = rec.seeds
        deltas[sl] = rec.deltas
        mask[sl] = 1.0
    return seeds, deltas, mask


def committed_arrays(commit: Commit, records: Dict[int, Record],
                     schema) -> CommittedStep:
    """The ONE commit -> update-inputs derivation (coordinator, workers,
    gossip peers, the reference, and cold ledger replay all route
    through here, via replay.step_arrays or directly).

    v1 / filter-free commits pass through untouched; tail eligibility is
    the accepted set (probe blocks are all-or-nothing). For v2 commits
    the filter verdict is *recomputed* from (records, accepted mask) —
    the pure function — and cross-checked against the commit's carried
    bitmask; a mismatch means a corrupt or forged ledger and raises
    ValueError. A v2 ledger without the RobustConfig that produced it
    also raises: the wire bits alone cannot distinguish mask from clip
    semantics, and silently guessing would diverge from the canon (the
    config is out-of-band enrollment schema, like the tail leaf layout).
    """
    from . import robust
    seeds, deltas, mask = raw_arrays(commit, records, schema)
    accepted = commit.workers(schema.fleet.num_workers)
    if commit.filtered is None:
        return CommittedStep(commit, records, seeds, deltas, mask,
                             tuple(sorted(w for w in accepted
                                          if w in records)))
    m = schema.fleet.probes_per_worker
    cfg = schema.fleet.robust
    if cfg is None:
        raise ValueError(
            f"commit {commit.step} is robust-filtered (v2) but the "
            "schema carries no RobustConfig — replaying it without the "
            "filter semantics that produced it would diverge")
    losses = robust.record_losses(records, commit.accepted,
                                  schema.fleet.num_workers)
    decision = robust.filter_decision(deltas, losses, mask, m, cfg,
                                      schema.numerics)
    if not np.array_equal(decision.inband, commit.inband(schema.n_probes)):
        raise ValueError(
            f"commit {commit.step}: carried filter mask does not match "
            "the deterministic recomputation — corrupt or forged ledger")
    seeds, deltas, mask = robust.apply_decision(seeds, deltas, mask,
                                                decision, cfg, m)
    # tail eligibility: loss-consistency IS the tail channel's check —
    # a band-rejected ZO probe masks only itself, the worker's sound
    # first-order signal stays in the update
    tail_ws = tuple(sorted(w for w in accepted if w in records
                           and not decision.loss_reject >> w & 1))
    return CommittedStep(commit, records, seeds, deltas, mask, tail_ws)


# ------------------------------------------------------------------ #
# arrivals -> Commit (producer side): the leaderless close pipeline
# ------------------------------------------------------------------ #


@dataclass(frozen=True)
class CloseOutcome:
    """Everything a closing participant needs to record one step.
    ``outliers`` feeds ``RobustGate.advance`` (quarantine verdicts);
    ``retried`` is a record the transport never delivered that the
    never-empty fallback pulled back — the caller must account it as a
    redelivery (``ChaosTransport.redeliver``), the satellite fix for
    phantom commits that bypassed transport accounting."""
    commit: Commit
    records: Dict[int, Record]          # accepted: these enter the ledger
    ontime_bits: int                    # pre-gate: made the deadline
    late_admit_bits: int                # pulled in past the deadline
    rejected: Tuple[Tuple[int, str], ...]
    outliers: int                       # worker bits, feeds the tracker
    retried: Optional[Record]
    events: Tuple[str, ...]

    @property
    def candidate_bits(self) -> int:
        """The realized candidate set (on-time | late-admitted) — what
        drives the single-process reference re-derivation."""
        return self.ontime_bits | self.late_admit_bits


def _pick_order(rf) -> Tuple[int, int]:
    """Deterministic pick/admit order: earliest delay first, ties broken
    toward the HIGHEST worker id (the leaderless tiebreak — every peer
    lands on the same record without a coordinator to ask)."""
    rec, fate = rf
    return (fate.delay, -rec.worker)


def close_step(gate, step: int,
               arrivals: List[Tuple[Record, Fate]]) -> CloseOutcome:
    """Deadline-gate the arrivals, filter, commit — the pure pipeline.

    ``gate`` is a RobustGate; its quarantine tracker state is read, not
    advanced (call ``gate.advance(step, outcome)`` exactly once with the
    returned outcome). Pure given (gate state, arrivals): closing the
    same arrivals against the same gate state yields the byte-identical
    Commit on every participant.
    """
    if not arrivals:
        raise ValueError(f"close_step({step}): no arrivals")
    deadline = gate.schema.fleet.deadline
    events: List[str] = []
    retried: Optional[Record] = None
    on_time = [(r, f) for r, f in arrivals if f.arrived_by(deadline)]
    ontime_bits = 0
    for r, _ in on_time:
        ontime_bits |= 1 << r.worker
    late_admit_bits = 0
    if not on_time:
        # nobody made the deadline: wait for the earliest delivery (or,
        # if the transport dropped everything, the earliest retry) — a
        # step is never empty for lack of patience.
        pool = [(r, f) for r, f in arrivals if f.delivered] or arrivals
        pick = min(pool, key=_pick_order)
        if not pick[1].delivered:
            retried = pick[0]     # caller accounts the redelivery bytes
        on_time = [pick]
        late_admit_bits |= 1 << pick[0].worker
        events.append(f"step {step}: empty deadline, waited for "
                      f"worker {pick[0].worker}"
                      + (" (redelivery)" if retried is not None else ""))
    # late arrivals the gate may pull in if it rejects everything,
    # earliest-delivery first (deterministic)
    on_time_ids = {id(r) for r, _ in on_time}
    late = sorted(((r, f) for r, f in arrivals
                   if id(r) not in on_time_ids and f.delivered),
                  key=_pick_order)
    candidates = {rec.worker: rec for rec, _ in on_time}
    result = gate.evaluate(step, candidates)
    while result.commit.accepted == 0 and late:
        rec, _ = late.pop(0)
        if rec.worker in candidates:
            continue
        candidates[rec.worker] = rec
        late_admit_bits |= 1 << rec.worker
        events.append(f"step {step}: gate empty, admitted late "
                      f"worker {rec.worker}")
        result = gate.evaluate(step, candidates)
    for w, reason in result.rejected:
        events.append(f"step {step}: rejected worker {w} ({reason})")
    if result.commit.accepted == 0:
        events.append(f"step {step}: no sound record survived the gate "
                      "— empty commit (no-op step)")
    return CloseOutcome(result.commit, result.records,
                        ontime_bits, late_admit_bits & ~ontime_bits,
                        tuple(result.rejected), result.outliers, retried,
                        tuple(events))


def close_candidates(gate, step: int,
                     candidates: Dict[int, Record]) -> CloseOutcome:
    """Close a step from a realized candidate set (no fates): how the
    single-process reference replays a fleet's candidate masks through
    the identical pipeline. Equivalent to ``close_step`` with every
    candidate on time — the final gate verdict over a candidate set does
    not depend on the admission order that produced it."""
    return close_step(gate, step, [(rec, Fate(True, 0))
                                   for _, rec in sorted(candidates.items())])


def step_loss(cstep: CommittedStep, schema,
              prev_loss: Optional[float]) -> float:
    """The canonical per-step training-loss observation: accepted
    records' reported losses, weighted by surviving probe count. A no-op
    step (everything rejected/filtered) has no observation — it carries
    the previous loss instead of recording a fictitious 0.0."""
    m = schema.fleet.probes_per_worker
    mask, records = cstep.mask, cstep.records
    if mask.sum() > 0:
        return sum(records[w].loss * float(mask[w * m:(w + 1) * m].sum())
                   for w in records) / float(mask.sum())
    return prev_loss if prev_loss is not None else float("nan")
