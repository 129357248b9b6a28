"""Canonical ledger semantics: (commit, records) -> parameter update.

The port of ``repro/fleet/replay.py``. Everything that holds model
parameters (the coordinator, every worker, a late joiner catching up,
the delta-checkpoint restore and the single-process reference,
``fleet/reference.py``) applies ledger steps through these functions.
The arithmetic lives in the update engine (``core/engine.py``); this
module decodes wire bytes and routes them there.

Per committed step, with n = fleet probes and mask in {0,1}^n from the
commit bitmask:

  fp32  ZO    theta <- cast(theta_f32 - sum_i coeff_i * z(seed_i))
              coeff_i = eta(step) * clip(delta_i / 2eps) * mask_i / valid
        tail  p <- cast(p_f32 - eta_tail(step) * sum_w dequant(payload_w)
                                                  / valid)
  int8  ZO    theta <- clamp(theta - sum_i psr(g_i * z(seed_i), shift))
        tail  w <- clamp(w - sum_w payload_w)   (int32-exact sum)

valid = max(sum mask, 1). A catch-up over S steps hands all S x n
records to ``engine.apply_zo_records`` at once: one ``zo_fused_replay``
launch a ZO leaf (fp32) or one ``zo_fused_replay_int8`` launch for all
int8 leaves, each a read and a write of the parameters however far
behind the worker is. The tail replays step by step; the two halves
touch disjoint leaves.

Probe seeds are derived on the host with the numpy threefry twin
(``core/keys.py``), bitwise ``jax.random.fold_in``, and the scalar
coefficients in strict numpy float32 (``engine.host_coeffs``), so every
participant derives the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..configs.base import LaneConfig
from ..configs.fleet import FleetConfig
from ..core import elastic, keys, prng, zo
from ..core.engine import engine_for
from ..core.int8 import QTensor
from .commit_rule import CommittedStep, committed_arrays
from .ledger import Commit, Ledger, Record


@dataclass
class ReplaySchema:
    """Out-of-band protocol state shared at enrollment: the lane (bound
    into the engine), the fleet topology, the base PRNG key data, the
    ZO/BP partition, and the tail leaf layout (JAX's leaf order) that
    payloads are flattened against."""
    lane: LaneConfig
    fleet: FleetConfig
    base_seed: np.ndarray                      # uint32[2] key data
    partition_fn: Callable[[Any], Tuple[Any, Any]]
    tail_shapes: List[Tuple[int, ...]] = field(default_factory=list)
    tail_dtypes: List[Any] = field(default_factory=list)
    tail_template: Any = None      # the bp tree's structure, leaves 0
    engine: Any = None                         # set by make_schema
    # per-step seed memo: W workers, the coordinator and the reference
    # derive the same array each step (bounded cache)
    _seed_cache: Dict[int, np.ndarray] = field(default_factory=dict,
                                               repr=False, compare=False)

    @property
    def n_probes(self) -> int:
        return self.fleet.n_probes

    @property
    def numerics(self) -> str:
        return self.engine.numerics


def make_schema(params, lane: LaneConfig, fleet_cfg: FleetConfig,
                base_seed, partition_fn=None) -> ReplaySchema:
    engine = engine_for(lane, partition_fn)
    _, bp_part = engine.partition(params)
    if engine.numerics == "int8":
        # int8 tails are QTensor weights; the payload is the flat int8
        # update against each leaf's .data (exponents are static)
        flat = zo.leaves(bp_part)
        shapes = [tuple(q.data.shape) for q in flat]
        dtypes = [torch.int8 for _ in flat]
    else:
        flat = zo.leaves(bp_part)
        shapes = [tuple(x.shape) for x in flat]
        dtypes = [x.dtype for x in flat]
    return ReplaySchema(
        lane=lane, fleet=fleet_cfg,
        base_seed=np.asarray(base_seed, np.uint32),
        partition_fn=engine.partition,
        tail_shapes=shapes, tail_dtypes=dtypes,
        tail_template=zo.rebuild(bp_part, [0] * len(flat)),
        engine=engine)


def probe_seeds(schema: ReplaySchema, step: int) -> np.ndarray:
    """uint64[n]: the hash seeds of this step's probe keys,
    seed_from_key(fold_in(fold_in(base, step), i)), as the engine's probe
    loop derives them."""
    cached = schema._seed_cache.get(step)
    if cached is not None:
        return cached
    key = keys.fold_in(schema.base_seed, step)
    seeds = np.asarray(
        [np.uint64(prng.seed_from_key(keys.fold_in(key, i)))
         for i in range(schema.n_probes)], np.uint64)
    schema._seed_cache[step] = seeds
    while len(schema._seed_cache) > 64:
        schema._seed_cache.pop(next(iter(schema._seed_cache)))
    return seeds


def step_coeffs(schema: ReplaySchema, step: int, deltas: np.ndarray,
                mask: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    """(coeffs[n], valid): the lane's scalar coeff transform on the host
    (strict fp32 for the fp32 lane, ternary ints for int8)."""
    return schema.engine.host_coeffs(step, deltas, mask)


def step_arrays(commit: Commit, records: Dict[int, Record],
                schema: ReplaySchema):
    """(seeds u64[n], deltas [n], mask f32[n], records) for one commit:
    a view over ``commit_rule.committed_arrays``, post-filter for v2
    commits. Masked probes carry seed 0 / delta 0."""
    cs = committed_arrays(commit, records, schema)
    return cs.seeds, cs.deltas, cs.mask, records


def ledger_step_arrays(ledger: Ledger, step: int, schema: ReplaySchema):
    commit, records = ledger.step_entries(step)
    return step_arrays(commit, records, schema)


def params_device(params) -> torch.device:
    """The device of the first tensor in ``params`` (the CPU if none)."""
    for leaf in zo.leaves(params):
        if isinstance(leaf, QTensor):
            return leaf.data.device
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _tail_tree(rec: Record, schema: ReplaySchema, device):
    """One record's tail payload as a bp-shaped tree on ``device``: fp32,
    the dequantised grads (q * scale); int8, the int32 updates."""
    leaves = []
    if schema.numerics == "int8":
        for q, shape in zip(rec.tail_q, schema.tail_shapes):
            leaves.append(torch.from_numpy(np.asarray(q, np.int8))
                          .to(device).to(torch.int32).reshape(shape))
        return zo.rebuild(schema.tail_template, leaves)
    for q, sc, shape in zip(rec.tail_q, rec.tail_scales,
                            schema.tail_shapes):
        leaves.append(torch.from_numpy(np.asarray(q, np.int8)).to(device)
                      .to(torch.float32).reshape(shape)
                      * float(np.float32(sc)))
    return zo.rebuild(schema.tail_template, leaves)


def _apply_tail(bp_part, step: int, records, accepted: List[int],
                valid: np.float32, schema: ReplaySchema):
    if not zo.leaves(bp_part) or not accepted:
        return bp_part
    device = params_device(bp_part)
    # decoded one worker at a time, in worker-id order, as the sum runs
    trees = (_tail_tree(records[w], schema, device) for w in accepted)
    return schema.engine.apply_tail_records(bp_part, step, trees, valid)


def apply_committed(params, step: int, cstep: CommittedStep,
                    schema: ReplaySchema):
    """One committed step, params(t) -> params(t+1), out of place.
    ``cstep`` is ``commit_rule.committed_arrays``' derivation: post-filter
    arrays and the tail-eligible worker set."""
    zo_part, bp_part = schema.partition_fn(params)
    coeffs, valid = step_coeffs(schema, step, cstep.deltas, cstep.mask)
    new_zo = schema.engine.apply_zo_records(zo_part, cstep.seeds[None, :],
                                            coeffs[None, :])
    new_bp = _apply_tail(bp_part, step, cstep.records,
                         list(cstep.tail_ws), valid, schema)
    return elastic.merge(new_zo, new_bp)


def replay(params, ledger: Ledger, schema: ReplaySchema, lo: int, hi: int):
    """Catch ``params`` up from step ``lo`` to step ``hi`` by ledger
    replay: the ZO half of all hi - lo steps in one fused pass
    (S = hi - lo records a probe), the tail step by step. Bitwise equal
    to having applied every step live."""
    if hi <= lo:
        return params
    per_step, scalar = [], []
    for step in range(lo, hi):
        if step not in ledger.commits:
            raise ValueError(f"ledger gap at step {step}")
        commit, records = ledger.step_entries(step)
        cs = committed_arrays(commit, records, schema)
        per_step.append(cs)
        scalar.append(step_coeffs(schema, step, cs.deltas, cs.mask))
    seeds = np.stack([cs.seeds for cs in per_step])           # [S, n]
    all_coeffs = np.stack([c for c, _ in scalar])             # [S, n]
    zo_part, bp_part = schema.partition_fn(params)
    new_zo = schema.engine.apply_zo_records(zo_part, seeds, all_coeffs)
    for i, cs in enumerate(per_step):
        bp_part = _apply_tail(bp_part, lo + i, cs.records,
                              list(cs.tail_ws), scalar[i][1], schema)
    return elastic.merge(new_zo, bp_part)


def make_replay_fn(schema: ReplaySchema):
    """Adapter for ``train/checkpoint.py`` delta mode: bytes -> replay."""
    def replay_fn(params, ledger_bytes: bytes, base_step: int, step: int):
        ledger = Ledger.from_bytes(ledger_bytes)
        return replay(params, ledger, schema, base_step, step)
    return replay_fn
