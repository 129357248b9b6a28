"""Seeded Byzantine attack models: deterministic record tampering.

Chaos philosophy as everywhere in this repo (docs/design.md §9): an
adversary is a *fixture*, not a fuzzer. Tampering is a deterministic
function of the honest record stream, so the fleet simulation and the
single-process reference (fleet/reference.py) construct byte-identical
tampered records from byte-identical honest ones — which is what lets a
Byzantine chaos run be replayed bit-exactly and asserted against.

Attack models (``ByzantineSpec.attack``), per lane. ``amp`` scales the
attack; 0.0 selects the lane default listed here:

  inflate       fp32: loss-diffs x amp (1e3). int8: the ternary sign is
                replaced by +/-amp (64) — out of the representable
                ternary range, which is the *strongest* scalar attack
                the 1-byte wire admits.
  sign_flip     loss-diffs -> -amp * delta (fp32 32; int8 3). A unit
                flip on the int8 lane is inside the honest envelope
                (|g| <= 1, influence-bounded by ternary clipping), so
                the effective attack flips *and* amplifies; the filter
                catches the amplification, ternary clipping bounds
                whatever would sneak under it.
  freeload      reports zeroed scalars, a zeroed tail payload, and a
                constant fabricated loss (= amp, default 0.0) without
                computing anything. Individually unremarkable scalars —
                only the loss-consistency channel catches it.
  collude       reports the constant loss-diff amp (fp32 1.0; int8 16)
                — give several workers the same spec and they vote as a
                clique trying to drag the center; median-of-means holds
                as long as the clique is a minority.
  seed_lie      shifts the probe seeds by int(amp) (1): a seed-schedule
                divergence. Caught by validation (fleet/robust.py),
                never by statistics — and must *reject*, not crash the
                coordinator (the PR 4 regression).
  stale_replay  re-sends its own record from int(amp) (2) steps ago
                (a replay attack); the step field betrays it.

Tampering happens on the wire copy only: the Byzantine worker's local
state (params, EF residual) stays honest, mirroring a compromised
network stack or a malicious participant that still wants to track the
canon.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Sequence

import numpy as np

from ..configs.fleet import ByzantineSpec, FleetConfig
from .ledger import Record

ATTACKS = ("inflate", "sign_flip", "freeload", "collude", "seed_lie",
           "stale_replay")

_DEFAULT_AMP = {
    ("inflate", "fp32"): 1e3,      ("inflate", "int8"): 64.0,
    ("sign_flip", "fp32"): 32.0,   ("sign_flip", "int8"): 3.0,
    ("freeload", "fp32"): 0.0,     ("freeload", "int8"): 0.0,
    ("collude", "fp32"): 1.0,      ("collude", "int8"): 16.0,
    ("seed_lie", "fp32"): 1.0,     ("seed_lie", "int8"): 1.0,
    ("stale_replay", "fp32"): 2.0, ("stale_replay", "int8"): 2.0,
}


def _zero_like(arrs: Sequence[np.ndarray]) -> List[np.ndarray]:
    return [np.zeros_like(a) for a in arrs]


class Adversary:
    """One worker's deterministic tamper function. Construct one per
    Byzantine worker (both in the fleet simulation and in the
    reference); feed it every honest record in step order.

    ``down`` is the worker's crash-schedule step set: the fleet never
    calls tamper while the worker is down, but the single-process
    reference computes every worker every step — skipping the stash on
    down steps keeps the two adversary instances byte-identical, which
    the bit-exactness contract requires."""

    def __init__(self, spec: ByzantineSpec, down=frozenset()):
        if spec.attack not in ATTACKS:
            raise ValueError(f"unknown attack {spec.attack!r}; "
                             f"available: {ATTACKS}")
        self.spec = spec
        self.down = frozenset(down)
        self._stash: Dict[int, Record] = {}    # honest records, by step

    def amp(self, numerics: str) -> float:
        if self.spec.amp:
            return float(self.spec.amp)
        return _DEFAULT_AMP[(self.spec.attack, numerics)]

    def tamper(self, rec: Record, step: int) -> Record:
        """Honest record -> wire record. Pure given the honest stream."""
        if step in self.down:
            return rec            # reference-side call while crashed:
        #                           no stash, no tampering (never sent)
        a = self.spec.attack
        amp = self.amp(rec.numerics)
        self._stash[step] = rec
        if a == "stale_replay":
            target = max(step - int(amp), 0)
            # a crash gap may have swallowed the target step: replay the
            # newest record this worker actually produced on-or-before it
            # (there is none only right after a from-step-0 crash, in
            # which case the current honest record goes out)
            have = [s for s in self._stash if s <= target]
            return self._stash[max(have)] if have else rec
        if a == "seed_lie":
            seeds = np.asarray(rec.seeds, np.uint64) + np.uint64(int(amp))
            return replace(rec, seeds=seeds)
        if a == "inflate":
            if rec.numerics == "int8":
                g = np.asarray(rec.deltas, np.int32)
                sgn = np.where(g == 0, 1, np.sign(g))
                deltas = np.clip(sgn * int(amp), -127, 127).astype(np.int8)
            else:
                deltas = (np.asarray(rec.deltas, np.float32)
                          * np.float32(amp))
            return replace(rec, deltas=deltas)
        if a == "sign_flip":
            if rec.numerics == "int8":
                g = np.asarray(rec.deltas, np.int32)
                deltas = np.clip(-g * int(amp), -127, 127).astype(np.int8)
            else:
                deltas = (np.asarray(rec.deltas, np.float32)
                          * np.float32(-amp))
            return replace(rec, deltas=deltas)
        if a == "collude":
            if rec.numerics == "int8":
                deltas = np.full_like(np.asarray(rec.deltas, np.int8),
                                      np.clip(int(amp), -127, 127))
            else:
                deltas = np.full_like(np.asarray(rec.deltas, np.float32),
                                      np.float32(amp))
            return replace(rec, deltas=deltas)
        if a == "freeload":
            return replace(
                rec, deltas=np.zeros_like(rec.deltas),
                loss=float(np.float32(amp)),
                tail_q=_zero_like(rec.tail_q),
                tail_scales=np.zeros_like(rec.tail_scales))
        raise AssertionError(a)   # unreachable: checked in __init__


def build_adversaries(cfg: FleetConfig) -> Dict[int, Adversary]:
    """worker id -> Adversary, from the fleet config's byzantine specs
    (crash-schedule-aware, so fleet and reference instances agree)."""
    out = {}
    for spec in cfg.byzantine:
        down = set()
        for w, cs, d in cfg.crashes:
            if w == spec.worker:
                down.update(range(cs, cs + d))
        out[spec.worker] = Adversary(spec, down)
    return out


def parse_byzantine(arg: str) -> tuple:
    """CLI spec parser: 'w:attack[:amp],...' -> ByzantineSpec tuple.

    e.g. ``--byzantine 3:sign_flip,5:inflate:100`` — worker 3 flips
    signs at the lane-default amplitude, worker 5 inflates x100.
    """
    specs = []
    for part in arg.split(","):
        if not part:
            continue
        bits = part.split(":")
        if len(bits) not in (2, 3):
            raise ValueError(f"byzantine entry {part!r} must be "
                             "worker:attack[:amp]")
        amp = float(bits[2]) if len(bits) == 3 else 0.0
        specs.append(ByzantineSpec(int(bits[0]), bits[1], amp))
    return tuple(specs)
