"""Byzantine-robust commit filtering: deterministic scalar filters,
worker quarantine, and the gate shared by every participant.

The seed ledger makes robustness cheap: a worker's entire ZO
contribution is a per-probe scalar, so robust aggregation is scalar
statistics, not tensor math. The design constraint inherited from the
rest of the fleet (docs/fleet.md) is **bit-exact reproducibility**: the
filter verdict must be a *pure function of (records, accepted mask)* so
the coordinator, every worker, the single-process reference, and a
ledger replay all derive the identical post-filter probe mask. Hence:

  * all scalar math runs host-side in strict numpy float32 (the same
    discipline as ``engine.host_coeffs``);
  * the verdict is iterated to a **fixpoint** (removing an outlier
    shifts the median/MAD, which may expose another), which makes the
    filter idempotent by construction — re-filtering filtered arrays is
    a no-op, a property tests/test_fleet_robust.py pins with hypothesis;
  * quarantine decisions ride in the commit (ledger.Commit v2), so a
    replayed ledger reproduces quarantine entry/exit without needing the
    coordinator's sliding-window state.

Filter channels, per lane:

  fp32   per-probe loss-diff **magnitudes**: median-of-means center +
         k·MAD band over |Δ|. Honest antithetic loss-diffs are
         sign-symmetric (each probe direction is random), so a signed
         band would straddle a bimodal distribution and flag one sign
         cluster as outliers; magnitude is the actual attack surface —
         a probe's influence on the update scales with |Δ| (and the
         sign is unfalsifiable without recomputing the loss; an
         in-band flip is influence-bounded, like int8's ternary bound).
         ``mode="mask"`` rejects probes with |Δ| above the band (the
         commit's filter bitmask); ``mode="clip"`` clips the loss-diff
         to ±hi instead, preserving its sign.
  int8   the wire scalar is a ternary sign: the band degenerates to the
         sign-consistency check |g| <= 1 (any stronger scalar attack is
         out of the representable range; an in-range flip is influence-
         bounded by ternary clipping itself — the paper's sign
         compression doubles as a Byzantine defense).
  both   per-record loss consistency (the int8 lane's "majority"
         channel): every worker evaluates the same batch at eps-sized
         perturbations of the same params, so honest reported losses
         cluster tightly around the fleet median; a record outside
         loss_k_mad · MAD (with an absolute floor) has all its probes
         rejected — this is what catches freeloaders whose scalars are
         individually unremarkable.

Validation (seed schedule, step field, numerics tag, probe count,
finiteness) is always on — independent of ``RobustConfig`` — and
**rejects instead of asserting**: a lying worker must not be able to
kill the fleet, including under ``python -O``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs.fleet import RobustConfig
from .ledger import Commit, Record, pack_bits

# ------------------------------------------------------------------ #
# robust scalar statistics (strict fp32 host math)
# ------------------------------------------------------------------ #


def mom_center(vals: np.ndarray, groups: int) -> np.float32:
    """Median-of-means: sort, split into `groups` contiguous chunks,
    median of the chunk means. Sorting first makes the estimate a pure
    function of the value *multiset* (worker-order invariant).

    ``groups=0`` (the default) means one group per value — the plain
    median, with its maximal 50% breakdown point. With g < n the
    estimator trades breakdown for variance reduction: a clique of k
    colluders can own up to k sorted chunks, so it only tolerates
    k < g/2 (see RobustConfig.mom_groups)."""
    vals = np.sort(np.asarray(vals, np.float32))
    g = vals.size if groups == 0 else max(1, min(int(groups), vals.size))
    if g == vals.size:
        return np.float32(np.median(vals))
    means = np.asarray([np.float32(np.mean(c)) for c in
                        np.array_split(vals, g)], np.float32)
    return np.float32(np.median(means))


def mad_scale(vals: np.ndarray, center: np.float32) -> np.float32:
    """Median absolute deviation from `center`."""
    vals = np.asarray(vals, np.float32)
    return np.float32(np.median(np.abs(vals - np.float32(center))))


# ------------------------------------------------------------------ #
# the filter verdict — a pure function of (records, accepted mask)
# ------------------------------------------------------------------ #


@dataclass(frozen=True)
class FilterDecision:
    """One step's verdict. ``inband[i]`` is False only for accepted
    probes the filter rejected (non-accepted probes are in-band by
    convention, so the commit bitmask is well-defined over all n)."""
    inband: np.ndarray          # bool[n]
    outliers: int               # worker bits: >=1 rejected probe or loss
    loss_reject: int            # worker bits rejected by the loss channel
    lo: np.float32              # scalar band used for mode="clip"
    hi: np.float32


def record_losses(records: Dict[int, Record], accepted: int,
                  num_workers: int) -> np.ndarray:
    """f32[W] of accepted workers' reported losses (NaN where absent)."""
    out = np.full((num_workers,), np.nan, np.float32)
    for w in range(num_workers):
        if accepted >> w & 1 and w in records:
            out[w] = np.float32(records[w].loss)
    return out


def filter_decision(deltas: np.ndarray, losses: np.ndarray,
                    mask: np.ndarray, m: int, cfg: RobustConfig,
                    numerics: str) -> FilterDecision:
    """THE filter: (per-probe scalars, per-worker losses, accepted probe
    mask) -> FilterDecision. Pure, strict-fp32, iterated to a joint
    fixpoint of the loss and scalar channels (=> idempotent)."""
    mask = np.asarray(mask, np.float32) > 0
    n = mask.size
    W = n // m
    losses = np.asarray(losses, np.float32)
    cand = mask.copy()               # probes still under consideration
    loss_reject = 0
    lo, hi = np.float32(0), np.float32(0)
    if numerics == "int8":
        # sign-consistency: the wire scalar must be a ternary sign
        lo, hi = np.float32(-1), np.float32(1)
        cand &= np.abs(np.asarray(deltas, np.int64)) <= 1
    d32 = np.asarray(deltas, np.float32)

    for _ in range(n + W + 1):       # both channels only ever shrink
        changed = False
        # -- loss channel (worker-level) --
        active = np.asarray([cand[w * m:(w + 1) * m].any()
                             for w in range(W)])
        finite = np.isfinite(losses)
        lvals = losses[active & finite]
        if lvals.size:
            c = np.float32(np.median(lvals))
            s = mad_scale(lvals, c)
            band = np.float32(cfg.loss_k_mad) * np.maximum(
                s, np.float32(cfg.loss_floor))
            for w in range(W):
                if not active[w] or loss_reject >> w & 1:
                    continue
                bad = (not finite[w]) or \
                    np.float32(abs(losses[w] - c)) > band
                if bad:
                    loss_reject |= 1 << w
                    cand[w * m:(w + 1) * m] = False
                    changed = True
        elif active.any():
            # every active record reported a non-finite loss: reject all
            for w in range(W):
                if active[w] and not loss_reject >> w & 1:
                    loss_reject |= 1 << w
                    cand[w * m:(w + 1) * m] = False
                    changed = True
        # -- scalar channel (per-probe |loss-diff|, fp32 lane only) --
        if numerics != "int8":
            mags = np.abs(d32)
            vals = mags[cand]
            if vals.size:
                c = mom_center(vals, cfg.mom_groups)
                s = mad_scale(vals, c)
                band = np.float32(c) + np.float32(cfg.k_mad) * np.maximum(
                    s, np.float32(cfg.scale_floor))
                lo, hi = np.float32(-band), np.float32(band)
                new = cand & (mags <= hi)
                if not np.array_equal(new, cand):
                    cand = new
                    changed = True
        if not changed:
            break

    inband = cand | ~mask            # no verdict on non-accepted probes
    outliers = loss_reject
    for w in range(W):
        blk = slice(w * m, (w + 1) * m)
        if mask[blk].any() and not inband[blk].all():
            outliers |= 1 << w
    return FilterDecision(inband, outliers, loss_reject, lo, hi)


def apply_decision(seeds: np.ndarray, deltas: np.ndarray,
                   mask: np.ndarray, decision: FilterDecision,
                   cfg: RobustConfig, m: int):
    """(seeds, deltas, mask) -> post-filter arrays, per cfg.mode.

    mask mode: rejected probes get mask 0 / delta 0 (the renormalizing
    `valid` shrinks with them). clip mode: band outliers keep their mask
    but their scalar is clipped to [lo, hi]; loss-rejected workers are
    masked in both modes (a lying loss poisons the whole record)."""
    mask = np.asarray(mask, np.float32).copy()
    deltas = np.array(deltas, copy=True)
    inband = decision.inband
    if cfg.mode == "clip":
        lr = np.zeros(mask.shape, bool)
        W = mask.size // m
        for w in range(W):
            if decision.loss_reject >> w & 1:
                lr[w * m:(w + 1) * m] = True
        clipped = (~inband) & (mask > 0) & ~lr
        if deltas.dtype == np.int8:
            deltas[clipped] = np.clip(deltas[clipped], -1, 1)
        else:
            deltas[clipped] = np.clip(
                np.asarray(deltas[clipped], np.float32),
                decision.lo, decision.hi)
        mask[lr] = 0.0
        deltas[lr] = 0
    else:
        out = ~inband
        mask[out] = 0.0
        deltas[out] = 0
    return seeds, deltas, mask


# ------------------------------------------------------------------ #
# record validation (always on; never an assert)
# ------------------------------------------------------------------ #


def validate_record(rec: Record, worker: int, step: int, schema,
                    expect_seeds: np.ndarray) -> Optional[str]:
    """Rejection reason for a malformed/lying record, or None if sound."""
    m = schema.fleet.probes_per_worker
    if rec.worker != worker:
        return f"claims worker {rec.worker}"
    if rec.step != step:
        return f"stale/foreign step {rec.step}"
    if rec.numerics != schema.numerics:
        return f"numerics {rec.numerics!r} (lane runs {schema.numerics!r})"
    if len(rec.seeds) != m or len(rec.deltas) != m:
        return f"probe count {len(rec.seeds)} (schema says {m})"
    if not np.array_equal(np.asarray(rec.seeds, np.uint64),
                          expect_seeds[worker * m:(worker + 1) * m]):
        return "seed schedule diverged"
    if not np.isfinite(np.float32(rec.loss)):
        return "non-finite loss"
    if schema.numerics == "fp32" and \
            not np.all(np.isfinite(np.asarray(rec.deltas, np.float32))):
        return "non-finite loss-diff"
    return None


# ------------------------------------------------------------------ #
# quarantine state machine
# ------------------------------------------------------------------ #


class QuarantineTracker:
    """Sliding-window persistence: a worker with `quarantine_after`
    outlier verdicts within the last `window` steps is excluded from
    commits for `quarantine_steps` steps (0 = permanently). Decisions at
    step t take effect at t+1 (step t's commit is already gated), are
    made in worker-id order, and never quarantine the last active
    worker. The per-step quarantine set rides in Commit v2, so ledger
    replay reproduces entry/exit without this object's state."""

    def __init__(self, cfg: RobustConfig, num_workers: int):
        self.cfg = cfg
        self.W = num_workers
        self.hist: Dict[int, List[int]] = {w: [] for w in range(num_workers)}
        self.until: Dict[int, int] = {}      # worker -> exclusive end step
        self.events: List[Tuple[int, int, str]] = []   # (step, worker, kind)

    def active_bits(self, step: int) -> int:
        bits = 0
        for w, until in self.until.items():
            if until < 0 or step < until:
                bits |= 1 << w
        return bits

    def observe(self, step: int, outlier_bits: int):
        # expire finished quarantines first (exit logged at release step)
        for w in sorted(self.until):
            if 0 <= self.until[w] <= step:
                del self.until[w]
                self.events.append((step, w, "exit"))
        active = self.active_bits(step)
        cfg = self.cfg
        for w in range(self.W):
            if active >> w & 1:
                continue                     # timer runs; no new verdicts
            if outlier_bits >> w & 1:
                self.hist[w].append(step)
            self.hist[w] = [s for s in self.hist[w]
                            if s > step - cfg.window]
            if len(self.hist[w]) >= cfg.quarantine_after:
                if bin(self.active_bits(step)).count("1") >= self.W - 1:
                    continue                 # never quarantine everyone
                self.until[w] = -1 if cfg.quarantine_steps == 0 \
                    else step + 1 + cfg.quarantine_steps
                self.hist[w] = []
                self.events.append((step + 1, w, "enter"))


# ------------------------------------------------------------------ #
# the gate: validation + quarantine + filter -> Commit (v1 or v2)
# ------------------------------------------------------------------ #


@dataclass
class GateResult:
    commit: Commit
    records: Dict[int, Record]           # accepted: these enter the ledger
    rejected: List[Tuple[int, str]]      # (worker, reason)
    outliers: int                        # worker bits, feeds the tracker
    decision: Optional[FilterDecision]


class RobustGate:
    """The accept/filter pipeline shared verbatim — via
    fleet/commit_rule.py — by the star coordinator, every leaderless
    gossip peer, and the single-process reference (fleet/reference.py),
    so all of them derive the same Commit from the same candidate
    records. ``evaluate`` is pure given the tracker state; ``advance``
    consumes one step's verdicts (call it exactly once per step, with
    the final GateResult or commit_rule.CloseOutcome — anything carrying
    ``outliers`` bits)."""

    def __init__(self, schema):
        self.schema = schema
        self.cfg: Optional[RobustConfig] = schema.fleet.robust
        self.tracker = QuarantineTracker(self.cfg, schema.fleet.num_workers) \
            if self.cfg is not None else None

    def evaluate(self, step: int, on_time: Dict[int, Record]) -> GateResult:
        from .commit_rule import raw_arrays            # import cycle guard
        from .replay import probe_seeds
        schema = self.schema
        W = schema.fleet.num_workers
        m = schema.fleet.probes_per_worker
        expect = probe_seeds(schema, step)
        quarantined = self.tracker.active_bits(step) if self.tracker else 0
        rejected: List[Tuple[int, str]] = []
        outliers = 0
        valid: Dict[int, Record] = {}
        for w in sorted(on_time):
            if not 0 <= w < W:
                rejected.append((w, "worker id out of range"))
                continue
            if quarantined >> w & 1:
                rejected.append((w, "quarantined"))
                continue
            reason = validate_record(on_time[w], w, step, schema, expect)
            if reason is not None:
                rejected.append((w, reason))
                outliers |= 1 << w
                continue
            valid[w] = on_time[w]
        accepted = 0
        for w in valid:
            accepted |= 1 << w
        decision = None
        filtered = None
        if self.cfg is not None:
            pre = Commit(step, accepted)
            _, deltas, mask = raw_arrays(pre, valid, schema)
            losses = record_losses(valid, accepted, W)
            decision = filter_decision(deltas, losses, mask, m, self.cfg,
                                       schema.numerics)
            outliers |= decision.outliers
            filtered = pack_bits(decision.inband)
        commit = Commit(step, accepted, quarantined=quarantined,
                        filtered=filtered)
        return GateResult(commit, valid, rejected, outliers, decision)

    def advance(self, step: int, result: GateResult):
        if self.tracker is not None:
            self.tracker.observe(step, result.outliers)

    def quarantine_events(self) -> List[Tuple[int, int, str]]:
        return list(self.tracker.events) if self.tracker else []
