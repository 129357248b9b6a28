"""Fleet coordinator: gather records, close steps, keep the canon.

The port of ``repro/fleet/coordinator.py``. Snapshots are host copies
of the parameters (``host_copy``), as the reference keeps numpy copies;
``nearest_snapshot`` puts one back on the parameters' device.

Since PR 5 the coordinator owns nothing protocol-critical: the whole
deadline-gate -> never-empty fallback -> Byzantine-robust gate ->
admit-late -> Commit pipeline lives in fleet/commit_rule.py as a pure
function of (gate state, arrivals), and this class merely invokes it —
exactly as every leaderless gossip peer (fleet/gossip.py), the
single-process reference (fleet/reference.py), and cold ledger replay
do. The star topology is now just the degenerate deployment where one
node happens to close every step; losing that node is survivable by
running ``--topology gossip`` instead (docs/fleet.md).

What the coordinator still keeps, per step:

  * the canonical parameter stream (applying exactly the same
    replay-module update as everyone else),
  * the append-only ledger that late joiners slice instead of copying
    checkpoints, and periodic host snapshots as replay bases,
  * the realized arrival bookkeeping, SPLIT by admission path (the PR 5
    arrival-mask fix): ``ontime_history`` holds the pre-gate bits of
    records that made the deadline, ``late_admit_history`` the workers
    pulled in past it (never-empty fallback + gate-empty admissions).
    Their union — ``candidate_history`` — is what drives the reference
    re-derivation; conflating the two under one "on-time" name is what
    used to mislabel late admissions on gate-empty steps.

Validation **rejects, never asserts**: a record with a diverged seed
schedule, a stale step field, or the wrong numerics tag is dropped (and
counted toward quarantine) instead of killing the fleet. A step where
*no* sound record exists commits empty — an exact parameter no-op —
rather than accepting garbage. When the never-empty fallback has to
retry a record the transport dropped, the retry is accounted
(``ChaosTransport.redeliver``) — commits never contain phantom bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import obs
from ..core import zo
from ..core.int8 import QTensor
from . import commit_rule
from .ledger import Commit, Ledger, Record
from .replay import ReplaySchema, apply_committed, params_device
from .robust import RobustGate
from .transport import ChaosTransport, Fate


def _moved(params, device, copy: bool = False):
    """``params`` with every tensor, a ``QTensor``'s two included, on
    ``device``."""
    def to(t):
        return t.detach().to(device, copy=copy)
    return zo.map_with_path(
        lambda _p, x: QTensor(to(x.data), to(x.exp))
        if isinstance(x, QTensor) else to(x), params)


def host_copy(params):
    """A copy of every tensor of ``params`` in host memory."""
    return _moved(params, "cpu", copy=True)


class Coordinator:
    def __init__(self, params, schema: ReplaySchema,
                 keep_snapshots: int = 2,
                 transport: Optional[ChaosTransport] = None,
                 at_step: int = 0):
        self.schema = schema
        self.params = params
        self.transport = transport
        self.ledger = Ledger()
        self.device = params_device(params)
        self.snapshots: Dict[int, object] = {at_step: host_copy(params)}
        self.keep_snapshots = max(keep_snapshots, 1)
        self.step = at_step
        self.loss_history: List[Tuple[int, float]] = []
        self.events: List[str] = []
        self.gate = RobustGate(schema)
        self.ontime_history: List[int] = []      # pre-gate on-time bits/step
        self.late_admit_history: List[int] = []  # admitted past the deadline
        self.n_rejected = 0                      # validation rejections
        self.n_filtered = 0                      # filter-masked probes
        # the most recent CloseOutcome — leaderless callers account its
        # ``retried`` record once per step (this closer has no transport)
        self.last_outcome: Optional[commit_rule.CloseOutcome] = None

    @property
    def candidate_history(self) -> List[int]:
        """Realized candidate bits per step (on-time | late-admitted) —
        the mask stream the single-process reference re-gates from."""
        return [o | l for o, l in zip(self.ontime_history,
                                      self.late_admit_history)]

    # ---- step protocol ------------------------------------------------- #
    def close_step(self, step: int,
                   arrivals: List[Tuple[Record, Fate]]) -> Tuple[Commit, Dict[int, Record]]:
        """Close one step via the shared pure pipeline, advance the canon."""
        if step != self.step or not arrivals:
            raise ValueError(f"close_step({step}) out of order "
                             f"(coordinator at {self.step})")
        outcome = commit_rule.close_step(self.gate, step, arrivals)
        self.last_outcome = outcome
        if outcome.retried is not None and self.transport is not None:
            self.transport.redeliver(outcome.retried)
        self.gate.advance(step, outcome)
        self.record_outcome(step, outcome)
        commit, records = outcome.commit, outcome.records
        cstep = commit_rule.committed_arrays(commit, records, self.schema)
        self.account_filtered(cstep)
        self.params = apply_committed(self.params, step, cstep, self.schema)
        prev = self.loss_history[-1][1] if self.loss_history else None
        self.loss_history.append(
            (step, commit_rule.step_loss(cstep, self.schema, prev)))
        self.step = step + 1
        self.maybe_snapshot()
        return commit, records

    # ---- bookkeeping shared with gossip peers --------------------------- #
    def record_outcome(self, step: int, outcome: commit_rule.CloseOutcome):
        """Histories, events, rejection counters, ledger appends."""
        rec_obs = obs.get()
        self.ontime_history.append(outcome.ontime_bits)
        self.late_admit_history.append(outcome.late_admit_bits)
        self.events.extend(outcome.events)
        for w, reason in outcome.rejected:
            self.n_rejected += reason != "quarantined"
            rec_obs.counter(f"fleet.rejected.{reason}").inc()
        for s, w, kind in self.gate.quarantine_events():
            tag = f"step {s}: worker {w} quarantine {kind}"
            if tag not in self.events:
                self.events.append(tag)
                rec_obs.event(f"quarantine_{kind}", track="fleet",
                              step=s, worker=w)
        for w in sorted(outcome.records):
            self.ledger.append_record(outcome.records[w])
        self.ledger.append_commit(outcome.commit)

    def account_filtered(self, cstep: commit_rule.CommittedStep):
        m = self.schema.fleet.probes_per_worker
        n = int(sum(
            m - cstep.mask[w * m:(w + 1) * m].sum()
            for w in cstep.commit.workers(self.schema.fleet.num_workers)))
        self.n_filtered += n
        if n:
            obs.get().counter("fleet.filtered_probes").inc(n)

    def maybe_snapshot(self):
        if self.schema.fleet.snapshot_every and \
                self.step % self.schema.fleet.snapshot_every == 0:
            self.snapshots[self.step] = host_copy(self.params)
            # restarts only ever need a recent base (now >= latest
            # snapshot); don't hold every historical parameter image
            for s in sorted(self.snapshots)[:-self.keep_snapshots]:
                del self.snapshots[s]

    # ---- catch-up service ---------------------------------------------- #
    def template(self):
        """Pytree template for checkpoint restores (structure only)."""
        return self.params

    def nearest_snapshot(self, step: int):
        """(base_step, host params) — newest snapshot at or before `step`.

        Raises ValueError (not an unhelpful ``max() of empty sequence``)
        when every snapshot at or before `step` has been pruned — the
        caller asked to restore into the past of the retention window.
        """
        held = [s for s in self.snapshots if s <= step]
        if not held:
            raise ValueError(
                f"no snapshot at or before step {step}: retained "
                f"{sorted(self.snapshots)} (keep_snapshots="
                f"{self.keep_snapshots}); replay cannot run backwards")
        base = max(held)
        return base, _moved(self.snapshots[base], self.device)
