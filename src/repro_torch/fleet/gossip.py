"""Leaderless fleet: epidemic record exchange, coordinator-free commits.

The port of ``repro/fleet/gossip.py``; snapshots and traces are host
copies of the parameters.

The star topology's single point of failure is the coordinator — not
because it owns any special math (a commit is a pure function of
(records, accepted mask), PR 2-4), but because only it was *allowed* to
close a step. This module cashes that purity in: ZO seed-ledger records
are 9-12 B/probe, so flooding every record to every peer costs almost
nothing, and once all peers of a connected component hold the same
record multiset, each closes the step independently through the SAME
pure pipeline (fleet/commit_rule.py) the coordinator uses — same
deadline gating on origin fates, same RobustGate, same
highest-worker-id tiebreak — and derives the **bit-identical** Commit
v2 without a round of consensus. The fleet survives any minority of
node losses, including the node that would have been the coordinator.

Determinism contract (docs/fleet.md, "Leaderless commits"):

  * a record's admissibility is judged by its **origin fate**
    (``ChaosTransport.fate`` — did the publication enter the mesh, how
    late), never by the gossip path it took to reach a peer;
  * epidemic spread (``rounds`` push rounds at ``fanout``, then an
    anti-entropy ring sweep to quiescence) only decides *availability*,
    and quiescence makes availability identical across a component;
  * a network partition splits the fleet along a deterministic schedule
    (GossipConfig.partitions). The side with the strict majority of
    workers (tie: the side holding the highest worker id) keeps
    committing; minority peers stall — params intact — and reconcile at
    heal by replaying the quorum's ledger slice from their own stalled
    step, plus a tiny closing-state transfer (quarantine window,
    realized histories) that rides the same catch-up channel.

Every peer is a full participant: Worker (probe compute, residual
protocol) + the same canon-keeping closer the star coordinator runs
(ledger, snapshots, loss history), so any surviving peer can serve as a
catch-up donor for crashed or partitioned peers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..configs.fleet import GossipConfig
from .adversary import build_adversaries
from .coordinator import Coordinator, host_copy
from .ledger import Ledger, Record
from .replay import ReplaySchema, replay
from .robust import RobustGate
from .transport import ChaosTransport, Fate
from .worker import Worker, zero_residual

_SEL_SALT = 0x600D  # domain-separates peer selection from link fates


def quorum_side(group_bits: int, num_workers: int) -> int:
    """The committing side of a partition: strict majority of worker
    ids; a tie breaks toward the side holding the highest worker id —
    the same leaderless tiebreak the commit rule uses, so every peer
    (and the reference, and a replayer) derives it without talking."""
    full = (1 << num_workers) - 1
    a, b = group_bits & full, full & ~group_bits
    ca, cb = bin(a).count("1"), bin(b).count("1")
    if ca != cb:
        return a if ca > cb else b
    return a if a >> (num_workers - 1) & 1 else b


def clone_gate(gate: RobustGate, schema) -> RobustGate:
    """A state-copy of a gate for closing-state transfer at catch-up.
    Copies the quarantine tracker's host scalars (window history, active
    timers, event log) — never the schema's engine."""
    g = RobustGate(schema)
    if gate.tracker is not None and g.tracker is not None:
        g.tracker.hist = {w: list(h) for w, h in gate.tracker.hist.items()}
        g.tracker.until = dict(gate.tracker.until)
        g.tracker.events = list(gate.tracker.events)
    return g


class GossipPeer(Worker):
    """One leaderless participant: a Worker that also closes steps.

    ``closer`` is literally a Coordinator — the canon-keeping half
    (gate, append-only ledger, snapshots, loss/arrival histories) is
    identical machinery; what changed in PR 5 is that the close pipeline
    it invokes became a pure function every peer can run. The peer's
    params and its closer's params are the same object: ``close_step``
    applies the canonical update once, ``apply_commit`` then only runs
    the worker-side residual/checkpoint protocol.
    """

    def __init__(self, worker_id: int, params, schema: ReplaySchema,
                 probe_fn, quantize_fn=None, ckpt_dir: Optional[str] = None,
                 keep_snapshots: int = 2):
        super().__init__(worker_id, params, schema, probe_fn, quantize_fn,
                         ckpt_dir)
        self.keep_snapshots = keep_snapshots
        self.closer = Coordinator(params, schema, keep_snapshots)
        self.ledger_since = 0      # first step this peer's ledger covers

    # ---- donor surface (duck-typed like the star coordinator) ---------- #
    @property
    def ledger(self) -> Ledger:
        return self.closer.ledger

    def template(self):
        return self.closer.template()

    def nearest_snapshot(self, step: int):
        return self.closer.nearest_snapshot(step)

    # ---- leaderless step ------------------------------------------------ #
    def close_and_apply(self, step: int,
                        arrivals: List[Tuple[Record, Fate]]):
        """Close one step via the shared pure pipeline and advance."""
        commit, records = self.closer.close_step(step, arrivals)
        self.apply_commit(step, commit, records,
                          new_params=self.closer.params)
        return commit, records

    # ---- failure / recovery --------------------------------------------- #
    def crash(self):
        super().crash()
        self.closer = None

    def restart(self, donor: "GossipPeer", now_step: int):
        """Rejoin from a surviving peer: params by fused ledger replay
        (Worker.restart), closing state by transfer — the quarantine
        verdict window and realized histories are host scalars that ride
        the same catch-up channel (commits carry each step's *active*
        quarantine set, but not the sliding window that feeds future
        entries)."""
        base_step, slice_bytes = super().restart(donor, now_step)
        closer = Coordinator(self.params, self.schema, self.keep_snapshots,
                             at_step=now_step)
        self._adopt_closing_state(closer, donor, slice_bytes)
        self.closer = closer
        self.ledger_since = base_step

    def reconcile(self, donor: "GossipPeer", now_step: int):
        """Heal after a partition stall: the minority peer kept its
        params at its stalled step, so it replays the quorum's ledger
        slice [self.step, now) from its OWN params — no snapshot needed
        — and re-syncs closing state from the donor."""
        if now_step <= self.step:
            return
        slice_bytes = donor.ledger.slice_bytes(self.step, now_step)
        self.catchup_bytes += len(slice_bytes)
        led = Ledger.from_bytes(slice_bytes)
        self.params = replay(self.params, led, self.schema, self.step,
                             now_step)
        self.residual = zero_residual(self.schema, self.device)
        self._pending_residual = None
        closer = self.closer
        _adopt_slice(closer, led)
        closer.params = self.params
        closer.step = now_step
        closer.snapshots = {now_step: host_copy(self.params)}
        self._copy_histories(closer, donor)
        self.step = now_step

    def _adopt_closing_state(self, closer: Coordinator, donor: "GossipPeer",
                             slice_bytes: bytes):
        _adopt_slice(closer, Ledger.from_bytes(slice_bytes))
        self._copy_histories(closer, donor)

    def _copy_histories(self, closer: Coordinator, donor: "GossipPeer"):
        closer.gate = clone_gate(donor.closer.gate, self.schema)
        closer.loss_history = list(donor.closer.loss_history)
        closer.ontime_history = list(donor.closer.ontime_history)
        closer.late_admit_history = list(donor.closer.late_admit_history)
        closer.n_rejected = donor.closer.n_rejected
        closer.n_filtered = donor.closer.n_filtered


def _adopt_slice(closer: Coordinator, led: Ledger):
    """Append a caught-up ledger slice into a closer's own ledger — the
    one adoption path shared by crash-restart and partition-reconcile."""
    for t in sorted(led.commits):
        for w in sorted(led.records.get(t, {})):
            closer.ledger.append_record(led.records[t][w])
        closer.ledger.append_commit(led.commits[t])


# ------------------------------------------------------------------ #
# epidemic exchange (deterministic; availability only)
# ------------------------------------------------------------------ #


def exchange(transport: ChaosTransport, gcfg: GossipConfig, step: int,
             ids: List[int], arrivals: List[Tuple[Record, Fate]]):
    """Spread this step's delivered records across the component.

    ``rounds`` synchronous push rounds: every peer sends the records it
    held at round start to ``fanout`` deterministically-chosen peers
    over lossy links (bytes accounted per record copy; exchanges are
    digest-coordinated, so only records the destination lacks travel).
    Then an anti-entropy ring sweep runs to quiescence — after it, every
    peer of the component holds exactly the delivered-record set, which
    is what makes the leaderless close bit-identical. Records whose
    origin fate dropped never entered the mesh (the author's copy is
    stranded behind its dead uplink, mirroring the star uplink loss).
    """
    recs = {rec.worker: rec for rec, fate in arrivals if fate.delivered}
    ids = sorted(ids)
    if not recs or len(ids) < 2:
        return
    rec_obs = obs.get()
    have: Dict[int, set] = {p: {p} & set(recs) for p in ids}
    with rec_obs.span("gossip/push_rounds", track="fleet", step=step):
        for rnd in range(gcfg.rounds):
            snap = {p: frozenset(have[p]) for p in ids}
            for src in ids:
                others = [d for d in ids if d != src]
                rng = np.random.default_rng(np.random.SeedSequence(
                    (transport.cfg.chaos_seed, step, rnd, src, _SEL_SALT)))
                picks = rng.choice(others,
                                   size=min(gcfg.fanout, len(others)),
                                   replace=False)
                for dst in (int(d) for d in picks):
                    novel = sorted(snap[src] - have[dst])
                    if not novel:
                        continue      # digest round-trip, nothing to move
                    if not transport.peer_fate(step, src, dst,
                                               rnd).delivered:
                        transport.n_gossip_dropped += len(novel)
                        rec_obs.counter(
                            "fleet.wire.n_gossip_dropped").inc(len(novel))
                        continue
                    for w in novel:
                        transport.gossip_hop(recs[w])
                        have[dst].add(w)
    # anti-entropy: lossless ring sweeps until the component is quiescent
    target = set(recs)
    with rec_obs.span("gossip/anti_entropy", track="fleet", step=step):
        while any(have[p] != target for p in ids):
            for i, src in enumerate(ids):
                dst = ids[(i + 1) % len(ids)]
                for w in sorted(have[src] - have[dst]):
                    transport.gossip_hop(recs[w])
                    have[dst].add(w)


# ------------------------------------------------------------------ #
# the leaderless simulation loop
# ------------------------------------------------------------------ #


def _pick_donor(peers: List[GossipPeer], quorum: int, step: int,
                exclude: int = -1) -> Optional[GossipPeer]:
    """Deterministic donor choice for catch-up: an alive, caught-up,
    quorum-side peer — full-ledger peers first, then highest id (the
    leaderless tiebreak again)."""
    cands = [p for p in peers
             if p.alive and p.id != exclude and quorum >> p.id & 1
             and p.step == step]
    if not cands:
        return None
    return max(cands, key=lambda p: (p.ledger_since == 0, p.id))


def run_gossip_fleet(schema: ReplaySchema, loss_fn: Callable, params,
                     batch_fn: Callable[[int], Any], steps: int,
                     trace: bool = False,
                     worker_ckpt_dirs: Optional[List] = None,
                     log_every: int = 0, probe_fn=None):
    """Leaderless twin of simulation.run_fleet (same FleetResult)."""
    from .simulation import (FleetResult, _bits_to_mask, crash_schedule,
                             history_masks, resolve_probe_fns)
    fleet_cfg = schema.fleet
    W = fleet_cfg.num_workers
    full = (1 << W) - 1
    gcfg = fleet_cfg.gossip or GossipConfig()
    probe_fn, quantize_fn = resolve_probe_fns(schema, loss_fn, probe_fn)
    transport = ChaosTransport(fleet_cfg)
    dirs = worker_ckpt_dirs or [None] * W
    peers = [GossipPeer(w, params, schema, probe_fn, quantize_fn, dirs[w])
             for w in range(W)]
    adversaries = build_adversaries(fleet_cfg)
    crash_at, restart_at = crash_schedule(fleet_cfg)

    fleet_events: List[str] = []
    masks, param_trace = [], []
    n_catchups = n_reconciles = 0
    partition_prev: Optional[int] = None
    pending_restarts: List[int] = []
    rec_obs = obs.get()
    t0 = obs.monotonic()
    for step in range(steps):
        group = gcfg.active_partition(step)
        quorum = quorum_side(group, W) if group is not None else full
        if group != partition_prev:   # also logs back-to-back windows
            if partition_prev is not None:
                fleet_events.append(f"step {step}: partition healed")
                rec_obs.event("partition_heal", track="fleet", step=step)
            if group is not None:
                fleet_events.append(
                    f"step {step}: partition begins (quorum "
                    f"{bin(quorum)}, minority stalls)")
                rec_obs.event("partition_begin", track="fleet", step=step,
                              quorum=quorum)
        partition_prev = group

        # rejoins — deferred while the rejoiner is cut off from a donor
        pending_restarts += restart_at.get(step, [])
        still_pending = []
        for w in pending_restarts:
            donor = _pick_donor(peers, quorum, step, exclude=w) \
                if quorum >> w & 1 else None
            if donor is None:
                still_pending.append(w)      # retry next step (partition)
                continue
            peers[w].restart(donor, step)
            n_catchups += 1
            fleet_events.append(f"step {step}: peer {w} rejoined via "
                                f"ledger replay from peer {donor.id}")
        pending_restarts = still_pending
        # heal-reconcile: stalled minority peers back on the quorum side
        for p in peers:
            if p.alive and p.step < step and quorum >> p.id & 1:
                donor = _pick_donor(peers, quorum, step, exclude=p.id)
                if donor is None:
                    raise ValueError(
                        f"step {step}: no donor to reconcile peer {p.id}")
                with rec_obs.span("gossip/reconcile", track="fleet",
                                  step=step, peer=p.id):
                    p.reconcile(donor, step)
                n_reconciles += 1
                fleet_events.append(f"step {step}: peer {p.id} reconciled "
                                    "after partition (from peer "
                                    f"{donor.id})")
                rec_obs.event("reconcile", track="fleet", step=step,
                              peer=p.id, donor=donor.id)
        for w, until in crash_at.get(step, []):
            peers[w].crash()
            fleet_events.append(f"step {step}: peer {w} crashed "
                                f"(down until {until})")

        batch = batch_fn(step)
        active = [p for p in peers
                  if p.alive and p.step == step and quorum >> p.id & 1]
        if not active:
            raise ValueError(
                f"step {step}: crash/partition schedule left the quorum "
                "component empty")
        with rec_obs.span("gossip/step", track="fleet", step=step), \
                rec_obs.memory.region("gossip/step"):
            arrivals = []
            with rec_obs.span("gossip/probe", track="fleet", step=step):
                for p in active:
                    rec = p.compute_record(step, batch)
                    if p.id in adversaries:
                        rec = adversaries[p.id].tamper(rec, step)
                    fate = transport.fate(step, p.id)
                    transport.send(rec, fate)
                    arrivals.append((rec, fate))
            with rec_obs.span("gossip/exchange", track="fleet", step=step):
                exchange(transport, gcfg, step, [p.id for p in active],
                         arrivals)

            # every peer closes independently — and must land on the same
            # bytes
            wire = commit = records = None
            with rec_obs.span("gossip/commit", track="fleet", step=step):
                for p in active:
                    c, r = p.close_and_apply(step, arrivals)
                    b = c.to_bytes()
                    if wire is None:
                        wire, commit, records = b, c, r
                    elif b != wire:
                        raise RuntimeError(
                            f"leaderless commit diverged at step {step}: "
                            f"peer {p.id} closed {b!r} vs {wire!r} — the "
                            "commit rule is not the pure function it "
                            "must be")
            # explicit retry accounting, once per step (not per peer): the
            # never-empty fallback can pull back a record the transport
            # dropped — the redelivery is real bytes even when the gate
            # then rejects the record (identical to the star
            # coordinator's books)
            retried = active[0].closer.last_outcome.retried
            if retried is not None:
                transport.redeliver(retried)
            masks.append(_bits_to_mask(commit.accepted, schema))
            if trace:
                param_trace.append(host_copy(active[-1].params))
        if log_every and (step % log_every == 0 or step == steps - 1):
            s, loss = active[-1].closer.loss_history[-1]
            n_acc = bin(commit.accepted).count("1")
            obs.log("gossip",
                    f"step {s:5d} loss {loss:.4f} accepted "
                    f"{n_acc}/{W} (peers closing: {len(active)})",
                    step=s, loss=loss, accepted=n_acc,
                    closing=len(active))

    # a run that ends mid-partition heals at the end: stalled minority
    # peers reconcile so every surviving peer lands on the canon
    for p in peers:
        if p.alive and p.step < steps:
            donor = _pick_donor(peers, full, steps, exclude=p.id)
            if donor is not None:
                p.reconcile(donor, steps)
                n_reconciles += 1
                fleet_events.append(f"end: peer {p.id} reconciled after "
                                    "run-final heal")

    survivors = [p for p in peers if p.alive and p.step == steps]
    if not survivors:
        raise ValueError("no surviving peer completed the run")
    canon = max(survivors, key=lambda p: (p.ledger_since == 0, p.id))
    if rec_obs.enabled:
        obs.memory.sample()      # end-of-run tagged vs the allocator
    canon.closer.events = fleet_events + canon.closer.events
    quarantine_events = canon.closer.gate.quarantine_events()
    led = canon.closer.ledger
    stats = {
        "topology": "gossip",
        "steps": steps,
        "workers": W,
        "wall_s": obs.monotonic() - t0,
        "bytes_uplink": transport.bytes_sent,
        "bytes_broadcast": 0,            # nobody broadcasts: peers gossip
        "bytes_gossip": transport.bytes_gossip,
        "bytes_catchup": sum(p.catchup_bytes for p in peers),
        "ledger_bytes_zo": led.bytes_zo,
        "ledger_bytes_tail": led.bytes_tail,
        "n_dropped": transport.n_dropped,
        "n_straggled": transport.n_straggled,
        "n_redelivered": transport.n_redelivered,
        "n_gossip_dropped": transport.n_gossip_dropped,
        "n_catchups": n_catchups,
        "n_reconciles": n_reconciles,
        "n_rejected": canon.closer.n_rejected,
        "n_filtered_probes": canon.closer.n_filtered,
        "n_quarantines": sum(1 for *_, kind in quarantine_events
                             if kind == "enter"),
    }
    hist = history_masks(canon.closer, schema)
    return FleetResult(canon.closer, list(peers), schema, masks,
                       param_trace, stats, hist["arrival"], hist["ontime"])
