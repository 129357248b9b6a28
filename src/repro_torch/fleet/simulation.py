"""Deterministic fleet simulation: N workers, chaos transport, one canon.

The port of ``repro/fleet/simulation.py``: the same loop, spans
(``fleet/step``, ``fleet/probe``, ``fleet/commit``, ``fleet/apply``) and
``fleet.wire.*`` counters, through ``repro_torch.obs``. A traced run
keeps host copies of the canon after each step.

Drives synchronous training rounds over an in-process fleet along a
``topology`` axis (FleetConfig.topology):

  * ``"star"`` — one coordinator deadline-gathers, closes every step via
    the shared commit rule (fleet/commit_rule.py), and broadcasts.
  * ``"gossip"`` — no coordinator: peers exchange records epidemically
    (fleet/gossip.py) and every peer closes each step independently via
    the SAME commit rule, deriving the bit-identical Commit v2. The
    chaos matrix (dropout, stragglers, crash-rejoin, adversaries) plus
    peer death and temporary network partitions with deterministic
    heal-and-reconcile all apply.

All randomness (transport fates, crash schedule, gossip peer selection)
is seeded, so a run is a reproducible fixture: tests replay the realized
probe masks through the single-process reference and assert the
parameter streams are bit-identical.

Per star step: alive workers compute records -> Byzantine workers tamper
their wire copy (fleet/adversary.py, deterministic) -> chaos transport
delivers (or not, or late) -> coordinator gates (validation, quarantine,
robust filter) and commits -> commit+records broadcast -> every
participant applies the canonical update. Crashed workers rejoin by
ledger replay (fleet/worker.py restart), never by copying the full
model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import obs
from ..configs.base import LaneConfig
from ..configs.fleet import FleetConfig
from .adversary import build_adversaries
from .coordinator import Coordinator, host_copy
from .ledger import Ledger
from .replay import ReplaySchema, make_schema
from .transport import ChaosTransport
from .worker import Worker, make_probe_fn, make_quantize_fn


@dataclass
class FleetResult:
    # the canon-keeping view: the Coordinator in star topology, the
    # highest-id surviving peer's closer in gossip (all surviving peers
    # are bit-identical — that is the leaderless acceptance bar)
    coordinator: Coordinator
    workers: List[Worker]
    schema: ReplaySchema
    masks: List[np.ndarray]            # realized per-step COMMIT probe masks
    param_trace: List[Any]             # canon after each step (host copies)
    stats: Dict[str, Any] = field(default_factory=dict)
    # realized per-step CANDIDATE probe masks (pre-gate: on-time arrivals
    # plus late admissions) — what drives the Byzantine reference, which
    # then re-derives validation/quarantine/filter itself
    arrival_masks: List[np.ndarray] = field(default_factory=list)
    # realized per-step ON-TIME probe masks (deadline survivors only;
    # arrival_masks minus the late-admitted workers). Split from
    # arrival_masks by the PR 5 conflation fix — gate-empty steps admit
    # late records, which are candidates but were never on time.
    ontime_masks: List[np.ndarray] = field(default_factory=list)

    @property
    def peers(self) -> Optional[List[Any]]:
        """The GossipPeers of a leaderless run (alias of ``workers`` —
        every gossip participant is a full worker); None for star."""
        return self.workers if self.stats.get("topology") == "gossip" \
            else None

    @property
    def ledger(self) -> Ledger:
        return self.coordinator.ledger

    @property
    def params(self):
        return self.coordinator.params


def _bits_to_mask(bits: int, schema: ReplaySchema) -> np.ndarray:
    m = schema.fleet.probes_per_worker
    out = np.zeros((schema.n_probes,), np.float32)
    for w in range(schema.fleet.num_workers):
        if bits >> w & 1:
            out[w * m:(w + 1) * m] = 1.0
    return out


def history_masks(closer: Coordinator,
                  schema: ReplaySchema) -> Dict[str, List[np.ndarray]]:
    """Expand a closer's realized bit histories into probe-mask streams."""
    return {
        "arrival": [_bits_to_mask(b, schema)
                    for b in closer.candidate_history],
        "ontime": [_bits_to_mask(b, schema)
                   for b in closer.ontime_history],
    }


def resolve_probe_fns(schema: ReplaySchema, loss_fn, probe_fn):
    """(probe_fn, quantize_fn) for a lane — shared by both topologies."""
    if probe_fn is None:
        if schema.numerics != "fp32":
            raise ValueError(
                "int8 fleets need a make_int8_probe_fn-built probe_fn")
        probe_fn = make_probe_fn(loss_fn, schema.lane, schema.partition_fn)
    quantize_fn = make_quantize_fn() if schema.numerics == "fp32" else None
    return probe_fn, quantize_fn


def crash_schedule(fleet_cfg: FleetConfig):
    crash_at: Dict[int, List[tuple]] = {}
    restart_at: Dict[int, List[int]] = {}
    for w, cs, down in fleet_cfg.crashes:
        crash_at.setdefault(cs, []).append((w, cs + down))
        restart_at.setdefault(cs + down, []).append(w)
    return crash_at, restart_at


def run_fleet(loss_fn: Callable, params, lane: LaneConfig,
              fleet_cfg: FleetConfig, batch_fn: Callable[[int], Any],
              steps: int, base_seed, partition_fn=None,
              trace: bool = False, worker_ckpt_dirs: Optional[List] = None,
              log_every: int = 0, probe_fn=None) -> FleetResult:
    """Train `steps` rounds on a simulated fleet; return the full state.

    batch_fn(step) must be a pure function of the step index (the repo's
    data contract, docs/design.md §9) — it is what lets every worker see
    the same batch without a data channel.

    For the int8 lane (lane.lane == "elastic_zo_int8") pass ``probe_fn``
    built by worker.make_int8_probe_fn (it binds the integer forward and
    the tail-FC layout); ``loss_fn`` is then unused and may be None.

    ``fleet_cfg.topology == "gossip"`` runs the leaderless protocol
    instead (fleet/gossip.py) — same signature, same FleetResult, no
    coordinator anywhere in the loop.
    """
    schema = make_schema(params, lane, fleet_cfg, base_seed, partition_fn)
    if fleet_cfg.topology == "gossip":
        from .gossip import run_gossip_fleet
        return run_gossip_fleet(schema, loss_fn, params, batch_fn, steps,
                                trace=trace,
                                worker_ckpt_dirs=worker_ckpt_dirs,
                                log_every=log_every, probe_fn=probe_fn)
    probe_fn, quantize_fn = resolve_probe_fns(schema, loss_fn, probe_fn)
    transport = ChaosTransport(fleet_cfg)
    coordinator = Coordinator(params, schema, transport=transport)
    dirs = worker_ckpt_dirs or [None] * fleet_cfg.num_workers
    workers = [Worker(w, params, schema, probe_fn, quantize_fn, dirs[w])
               for w in range(fleet_cfg.num_workers)]
    rec_obs = obs.get()
    if rec_obs.enabled:
        rec_obs.memory.rebind("fleet.canon.params",
                              obs.memory.tree_nbytes(coordinator.params),
                              key=("canon", id(coordinator)))

    adversaries = build_adversaries(fleet_cfg)
    crash_at, restart_at = crash_schedule(fleet_cfg)

    masks, param_trace = [], []
    bytes_broadcast = 0
    n_catchups = 0
    t0 = obs.monotonic()
    for step in range(steps):
        with rec_obs.span("fleet/step", track="fleet", step=step), \
                rec_obs.memory.region("fleet/step"):
            for w in restart_at.get(step, []):
                workers[w].restart(coordinator, step)
                n_catchups += 1
                coordinator.events.append(f"step {step}: worker {w} rejoined "
                                          "via ledger replay")
                rec_obs.event("worker_rejoin", track="fleet", step=step,
                              worker=w)
            for w, until in crash_at.get(step, []):
                workers[w].crash()
                coordinator.events.append(f"step {step}: worker {w} crashed "
                                          f"(down until {until})")
                rec_obs.event("worker_crash", track="fleet", step=step,
                              worker=w, until=until)
            batch = batch_fn(step)
            arrivals = []
            with rec_obs.span("fleet/probe", track="fleet", step=step):
                for worker in workers:
                    if not worker.alive:
                        continue
                    rec = worker.compute_record(step, batch)
                    if worker.id in adversaries:
                        # wire-only tampering: the worker's local state
                        # (params, EF residual) stays honest, like a
                        # compromised uplink
                        rec = adversaries[worker.id].tamper(rec, step)
                    fate = transport.fate(step, worker.id)
                    transport.send(rec, fate)
                    arrivals.append((rec, fate))
            if not arrivals:
                raise ValueError("crash schedule left the fleet empty")
            with rec_obs.span("fleet/commit", track="fleet", step=step):
                commit, records = coordinator.close_step(step, arrivals)
            step_bytes = commit.nbytes + sum(r.nbytes
                                             for r in records.values())
            bytes_broadcast += step_bytes
            rec_obs.counter("fleet.wire.broadcast_bytes").inc(step_bytes)
            masks.append(_bits_to_mask(commit.accepted, schema))
            with rec_obs.span("fleet/apply", track="fleet", step=step):
                for worker in workers:
                    if worker.alive:
                        worker.apply_commit(step, commit, records)
            if trace:
                param_trace.append(host_copy(coordinator.params))
        if log_every and (step % log_every == 0 or step == steps - 1):
            s, loss = coordinator.loss_history[-1]
            n_acc = bin(commit.accepted).count("1")
            obs.log("fleet",
                    f"step {s:5d} loss {loss:.4f} "
                    f"accepted {n_acc}/{fleet_cfg.num_workers}",
                    step=s, loss=loss, accepted=n_acc)

    if rec_obs.enabled:
        obs.memory.sample()      # end-of-run tagged vs the allocator
    led = coordinator.ledger
    quarantine_events = coordinator.gate.quarantine_events()
    stats = {
        "topology": "star",
        "steps": steps,
        "workers": fleet_cfg.num_workers,
        "wall_s": obs.monotonic() - t0,
        "bytes_uplink": transport.bytes_sent,
        "bytes_broadcast": bytes_broadcast,
        "bytes_gossip": 0,
        "bytes_catchup": sum(w.catchup_bytes for w in workers),
        "ledger_bytes_zo": led.bytes_zo,
        "ledger_bytes_tail": led.bytes_tail,
        "n_dropped": transport.n_dropped,
        "n_straggled": transport.n_straggled,
        "n_redelivered": transport.n_redelivered,
        "n_catchups": n_catchups,
        "n_rejected": coordinator.n_rejected,
        "n_filtered_probes": coordinator.n_filtered,
        "n_quarantines": sum(1 for *_, kind in quarantine_events
                             if kind == "enter"),
    }
    hist = history_masks(coordinator, schema)
    return FleetResult(coordinator, workers, schema, masks, param_trace,
                       stats, hist["arrival"], hist["ontime"])
