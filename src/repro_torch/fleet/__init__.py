"""repro_torch.fleet -- seed-ledger distributed ZO training.

The port of ``repro/fleet`` (docs/fleet.md), with the same public
surface and the same wire format: a ledger written by either package
decodes and replays in the other.

ElasticZO collapses the ZO half of a training step to (probe seed,
projected-grad scalar) pairs; this subsystem turns that into a wire
protocol. Workers publish per-step ledger records; a step is closed by
ONE pure pipeline (fleet/commit_rule.py) — run by a star coordinator,
or by every peer independently in the leaderless gossip topology
(fleet/gossip.py: epidemic record exchange, deterministic
coordinator-free commits, partition heal-and-reconcile) — and every
participant (closer, worker, late joiner replaying the ledger, and the
single-process reference) runs the identical canonical update, so the
whole fleet stays bit-exact.

Public surface: FleetConfig / RobustConfig / GossipConfig /
ByzantineSpec (configs/fleet.py), Ledger / Record / Commit,
ChaosTransport, Worker, Coordinator, GossipPeer, run_fleet,
make_reference_step, ReplaySchema / replay / make_replay_fn,
Adversary / build_adversaries (fleet/adversary.py), the commit-rule
primitives close_step / close_candidates / committed_arrays
(fleet/commit_rule.py), and the robust-filter primitives RobustGate /
filter_decision / QuarantineTracker (fleet/robust.py).
"""
from ..configs.fleet import (ByzantineSpec, FleetConfig, GossipConfig,
                             RobustConfig)
from .adversary import Adversary, build_adversaries, parse_byzantine
from .commit_rule import (CloseOutcome, CommittedStep, close_candidates,
                          close_step, committed_arrays, step_loss)
from .coordinator import Coordinator
from .gossip import GossipPeer, quorum_side, run_gossip_fleet
from .ledger import Commit, Ledger, Record
from .reference import make_reference_step, reference_state
from .replay import (ReplaySchema, apply_committed, ledger_step_arrays,
                     make_replay_fn, make_schema, probe_seeds, replay,
                     step_arrays, step_coeffs)
from .robust import (FilterDecision, QuarantineTracker, RobustGate,
                     filter_decision)
from .simulation import FleetResult, run_fleet
from .transport import ChaosTransport
from .worker import Worker, make_int8_probe_fn, make_probe_fn

__all__ = ["FleetConfig", "RobustConfig", "GossipConfig", "ByzantineSpec",
           "Ledger", "Record", "Commit", "ChaosTransport", "Worker",
           "Coordinator", "GossipPeer", "quorum_side", "run_gossip_fleet",
           "run_fleet", "FleetResult", "Adversary", "build_adversaries",
           "parse_byzantine", "RobustGate", "FilterDecision",
           "QuarantineTracker", "filter_decision",
           "CloseOutcome", "CommittedStep", "close_step",
           "close_candidates", "committed_arrays", "step_loss",
           "make_probe_fn", "make_int8_probe_fn", "make_reference_step",
           "reference_state", "ReplaySchema", "make_schema",
           "apply_committed", "replay", "make_replay_fn",
           "ledger_step_arrays", "step_arrays", "step_coeffs",
           "probe_seeds"]
