"""Deterministic lossy/latency-injecting in-process transport.

Every message fate — delivered?, delay ticks — is a pure function of
the chaos seed, so a fleet run with dropouts and stragglers is exactly
reproducible: rerunning the simulation, the single-process reference
(fleet/reference.py), and a post-hoc replay all see the same probe
masks. This is chaos testing as a deterministic fixture, the same
philosophy as the step-indexed synthetic data (docs/design.md §9).

Two fate families share the machinery:

  * ``fate(step, worker)`` — the record's **origin fate**: did the
    worker's publication make it into the protocol at all, and how
    late. In the star topology this is the worker->coordinator uplink;
    in the gossip topology it is the first hop into the epidemic mesh.
    Either way it is what the deadline gate judges (docs/fleet.md,
    "Leaderless commits"): a record's timeliness must not depend on the
    path it took to reach a given peer, or peers would disagree.
  * ``peer_fate(step, src, dst, rnd)`` — one gossip link's fate in
    exchange round ``rnd``. Lossy links slow epidemic spread (the
    anti-entropy sweep still converges the component); they never
    change a record's origin fate.

Physical mapping: "dropped" = the publication never entered the mesh;
"straggler" = it arrived after the per-step deadline. Both end up
probe-masked in the commit. ``redeliver`` accounts the never-empty
fallback's explicit retry of a dropped record — a commit must never
contain bytes the transport doesn't know about (the PR 5 phantom-commit
fix).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import obs
from ..configs.fleet import FleetConfig

_P2P_SALT = 0x9067  # domain-separates peer links from origin fates


@dataclass(frozen=True)
class Fate:
    delivered: bool
    delay: int

    def arrived_by(self, deadline: int) -> bool:
        return self.delivered and self.delay <= deadline


class ChaosTransport:
    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.bytes_sent = 0           # publications + redeliveries
        self.bytes_gossip = 0         # epidemic record copies (p2p hops)
        self.n_dropped = 0
        self.n_straggled = 0
        self.n_redelivered = 0        # dropped records retried by the
        #                               never-empty fallback
        self.n_gossip_dropped = 0     # record copies lost to failed p2p
        #                               links (spread-only; counted only
        #                               when the link had copies to move)

    def fate(self, step: int, worker: int) -> Fate:
        """The (delivered, delay) origin fate of worker's step record."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self.cfg.chaos_seed, step, worker)))
        delivered = bool(rng.uniform() >= self.cfg.dropout)
        delay = int(rng.integers(0, self.cfg.max_delay + 1)) \
            if self.cfg.max_delay else 0
        return Fate(delivered, delay)

    def peer_fate(self, step: int, src: int, dst: int, rnd: int) -> Fate:
        """One gossip link's fate (pure in the chaos seed). Links share
        the origin dropout probability; delay is irrelevant for spread
        (deadline gating judges origin fates only) and is always 0."""
        rng = np.random.default_rng(np.random.SeedSequence(
            (self.cfg.chaos_seed, step, src, dst, rnd, _P2P_SALT)))
        return Fate(bool(rng.uniform() >= self.cfg.dropout), 0)

    def send(self, record, fate: Fate) -> bool:
        """Account a record publication; True if it entered the mesh."""
        rec = obs.get()
        if not fate.delivered:
            self.n_dropped += 1
            rec.counter("fleet.wire.n_dropped").inc()
            return False
        self.bytes_sent += record.nbytes
        rec.counter("fleet.wire.uplink_bytes").inc(record.nbytes)
        if rec.enabled:
            self._account_split(rec, record)
        if fate.delay > self.cfg.deadline:
            self.n_straggled += 1
            rec.counter("fleet.wire.n_straggled").inc()
        return True

    def redeliver(self, record):
        """Account the never-empty fallback's explicit retry of a record
        the transport originally dropped. The retry rides the same
        uplink, so its bytes land in ``bytes_sent`` — the steps where
        the network was worst are exactly the ones whose accounting used
        to be wrong."""
        self.bytes_sent += record.nbytes
        self.n_redelivered += 1
        rec = obs.get()
        rec.counter("fleet.wire.uplink_bytes").inc(record.nbytes)
        rec.counter("fleet.wire.n_redelivered").inc()
        if rec.enabled:
            self._account_split(rec, record)

    @staticmethod
    def _account_split(rec, record):
        """Split one uplink publication into its ZO and tail halves —
        per worker for the tail, because that is where the asymmetry
        lives: ~12 B/probe of ZO scalars vs the KBs of int8 tail payload
        (the ROADMAP's 'tail bytes are invisible' item)."""
        rec.counter("fleet.wire.zo_bytes").inc(record.zo_nbytes)
        rec.counter("fleet.wire.tail_bytes").inc(record.tail_nbytes)
        rec.counter(
            f"fleet.wire.tail_bytes.w{record.worker:02d}").inc(
            record.tail_nbytes)

    def gossip_hop(self, record):
        """Account one delivered epidemic copy of `record` over a p2p
        link. Failed links are accounted by the caller per suppressed
        record copy (``n_gossip_dropped``) — the link fate is decided
        before any copy is attempted (fleet/gossip.py exchange)."""
        self.bytes_gossip += record.nbytes
        obs.get().counter("fleet.wire.gossip_bytes").inc(record.nbytes)
