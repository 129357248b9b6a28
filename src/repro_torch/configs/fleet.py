"""Fleet configuration: simulated edge-device swarm topology and chaos.

A fleet is W workers that jointly own the step's antithetic SPSA probes
(probe-parallel data distribution, docs/fleet.md): worker w evaluates the
contiguous probe block [w*m, (w+1)*m) on the step-deterministic batch and
publishes one ledger record. The chaos knobs drive the deterministic
in-process transport (fleet/transport.py) so dropout/straggler/crash
scenarios are reproducible test fixtures, not flaky integration tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class RobustConfig:
    """Byzantine-robust commit filtering knobs (fleet/robust.py).

    The filter is a pure function of (records, accepted mask): every
    participant — coordinator, workers, the single-process reference, and
    a ledger replay — derives the bit-identical post-filter probe mask
    (docs/fleet.md, Byzantine section). All scalar math runs host-side in
    strict numpy float32, like ``engine.host_coeffs``.
    """
    # -- per-probe scalar band (fp32 lane): median-of-means center,
    #    clip/mask at k * MAD, iterated to a fixpoint (idempotence) --
    mode: str = "mask"            # "mask": reject out-of-band probes;
    #                               "clip": clip their loss-diffs to the band
    k_mad: float = 6.0            # band half-width in MADs
    scale_floor: float = 1e-6     # MAD floor: band never collapses to zero
    # median-of-means group count; 0 (default) = one group per value,
    # i.e. the plain median — maximal 50% breakdown point. A sorted-chunk
    # MoM with g groups tolerates only < g/2 colluders (a clique of k can
    # own up to k chunks), so lower this below the probe count only for
    # heavy-tailed loss-diffs at scale, knowingly trading breakdown point
    # for variance reduction.
    mom_groups: int = 0
    # -- per-record loss consistency (both lanes; the int8 "majority"
    #    channel: the fleet median is the consensus) --
    loss_k_mad: float = 8.0
    loss_floor: float = 5e-2      # absolute MAD floor for the loss band
    # -- quarantine state machine: persistent outliers are excluded --
    window: int = 4               # sliding window (steps) of outlier verdicts
    quarantine_after: int = 3     # verdicts within the window that trigger it
    quarantine_steps: int = 4     # exclusion length; 0 = permanent

    def __post_init__(self):
        if self.mode not in ("mask", "clip"):
            raise ValueError(f"robust mode {self.mode!r} not in mask|clip")
        if self.window < 1 or self.quarantine_after < 1:
            raise ValueError("quarantine window/threshold must be >= 1")
        if self.quarantine_after > self.window:
            raise ValueError("quarantine_after cannot exceed window")
        if self.k_mad <= 0 or self.loss_k_mad <= 0 or self.mom_groups < 0:
            raise ValueError("filter bands must be positive")


@dataclass(frozen=True)
class GossipConfig:
    """Leaderless topology knobs (fleet/gossip.py).

    Epidemic record exchange: each step, every active peer pushes the
    step-records it holds to ``fanout`` deterministically-chosen peers,
    ``rounds`` times; an anti-entropy ring sweep then runs the connected
    component to quiescence, so every peer of a component closes the
    step from the identical candidate multiset (what makes the
    leaderless commit bit-identical without consensus). Exchanges are
    digest-coordinated: a link carries only records the destination
    lacks (O(1) digest bytes are not modeled).

    ``partitions`` is a deterministic network-split schedule: triples
    ``(lo_step, hi_step, group_bitmask)`` — during steps [lo, hi) the
    fleet splits into the group and its complement; no record crosses.
    The side holding the strict majority of workers (tie: the side
    containing the highest worker id — the same leaderless tiebreak the
    commit rule uses) keeps committing; the minority stalls and
    reconciles by ledger replay at heal (docs/fleet.md, "Leaderless
    commits"). Windows must not overlap.
    """
    fanout: int = 2
    rounds: int = 2
    partitions: Tuple[Tuple[int, int, int], ...] = field(default=())

    def __post_init__(self):
        if self.fanout < 1 or self.rounds < 1:
            raise ValueError("gossip fanout and rounds must be >= 1")
        spans = []
        for lo, hi, group in self.partitions:
            if lo < 0 or hi <= lo:
                raise ValueError(f"partition window [{lo}, {hi}) is empty")
            if group <= 0:
                raise ValueError("partition group bitmask must be nonzero")
            spans.append((lo, hi))
        for (lo, hi), (lo2, hi2) in zip(sorted(spans), sorted(spans)[1:]):
            if lo2 < hi:
                raise ValueError("partition windows must not overlap")

    def active_partition(self, step: int) -> Optional[int]:
        """The group bitmask of the partition covering `step`, if any."""
        for lo, hi, group in self.partitions:
            if lo <= step < hi:
                return group
        return None


@dataclass(frozen=True)
class ByzantineSpec:
    """One simulated attacker: worker `worker` runs `attack` with
    strength `amp` (0.0 = the attack's lane-dependent default). Attack
    models live in fleet/adversary.py; tampering is a deterministic
    function of the honest record stream, so Byzantine chaos runs are
    reproducible fixtures like every other failure mode."""
    worker: int
    attack: str
    amp: float = 0.0


@dataclass(frozen=True)
class FleetConfig:
    num_workers: int = 8
    probes_per_worker: int = 1
    # -- transport chaos (deterministic in chaos_seed) --
    dropout: float = 0.0          # P(record lost on the worker->coord link)
    max_delay: int = 0            # record delivery delay, uniform [0, max]
    deadline: int = 0             # ticks the coordinator waits per step;
    #                               delivered-but-later records are
    #                               stragglers and get probe-masked
    chaos_seed: int = 0
    # -- catch-up / persistence --
    snapshot_every: int = 10      # coordinator keeps a full param snapshot
    #                               every N steps as a replay base
    local_ckpt_every: int = 0     # workers checkpoint locally (0 = off)
    # -- crash schedule: (worker_id, crash_step, down_steps) triples --
    crashes: Tuple[Tuple[int, int, int], ...] = field(default=())
    # -- Byzantine machinery: attackers (simulated, fleet/adversary.py)
    #    and the robust commit filter (fleet/robust.py; None = filter-free,
    #    exactly the pre-robust protocol) --
    byzantine: Tuple[ByzantineSpec, ...] = field(default=())
    robust: Optional[RobustConfig] = None
    # -- topology: "star" (coordinator closes every step) or "gossip"
    #    (leaderless: epidemic record exchange, every peer closes each
    #    step via the same deterministic commit rule) --
    topology: str = "star"
    gossip: Optional[GossipConfig] = None

    @property
    def n_probes(self) -> int:
        """Total probes per step across the fleet."""
        return self.num_workers * self.probes_per_worker

    def probe_block(self, worker: int):
        m = self.probes_per_worker
        return range(worker * m, (worker + 1) * m)

    def __post_init__(self):
        # raises, not asserts: topology/chaos validation must survive -O
        # (the Byzantine suites run once under PYTHONOPTIMIZE=1)
        if not 1 <= self.num_workers <= 32:
            raise ValueError("commit bitmask is u32: 1 <= num_workers <= 32")
        if not 1 <= self.probes_per_worker <= 255:
            raise ValueError("record probe count is u8")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")
        seen = set()
        for spec in self.byzantine:
            if not 0 <= spec.worker < self.num_workers:
                raise ValueError(f"byzantine worker {spec.worker} out of "
                                 f"range for {self.num_workers} workers")
            if spec.worker in seen:
                raise ValueError(f"worker {spec.worker} has two byzantine "
                                 "specs")
            seen.add(spec.worker)
        if len(seen) == self.num_workers and self.num_workers > 1:
            raise ValueError("at least one worker must stay honest")
        if self.topology not in ("star", "gossip"):
            raise ValueError(f"topology {self.topology!r} not in "
                             "star|gossip")
        if self.gossip is not None and self.topology != "gossip":
            raise ValueError("GossipConfig given but topology is "
                             f"{self.topology!r}")
        full = (1 << self.num_workers) - 1
        for lo, hi, group in (self.gossip.partitions
                              if self.gossip else ()):
            if group & ~full or group == full:
                raise ValueError(
                    f"partition group {group:#x} must name a proper "
                    f"nonempty subset of the {self.num_workers} workers")
        if self.robust is not None and self.n_probes > 255 * 8:
            # commit v2 stores the per-probe filter bitmask behind a u8
            # byte count: fail at construction, not mid-run serialization
            raise ValueError(
                f"robust filtering supports at most {255 * 8} probes "
                "(commit v2 filter-mask length is u8 bytes); got "
                f"{self.n_probes}")
