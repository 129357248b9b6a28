"""Fleet training launcher: a simulated edge swarm with chaos injection.

``python -m repro_torch.launch.fleet --arch qwen3-4b --smoke --device cpu
      --workers 8 --dropout 0.2 --steps 20``

The port of ``repro.launch.fleet``, with its flags and checks and one
more flag, ``--device`` (the card unless ``--device cpu`` is given). It
runs N in-process workers against the seed-ledger protocol
(``repro_torch.fleet``): per-step scalar records for the ZO half,
error-feedback int8 payloads for the BP tail, deterministic
dropout/straggler chaos, and crash/rejoin by ledger replay (``--crash
worker:step:down``). It exits 1 if any live worker's parameters differ
from the canon's: the run is its own consistency check.

``--lane int8`` runs ElasticZO-INT8 (Alg. 2) instead: the paper's
LeNet-5 on the deterministic glyphs, integer-only updates, 9-byte ledger
probes, the same chaos, and then the whole run again through the
single-process int8 reference (``fleet/reference.py``), which it must
equal bit for bit; it also exits 1 if a ZO probe entry is over 9 bytes.

``--byzantine 3:sign_flip,5:inflate:100`` puts deterministic attackers
on the named workers (``fleet/adversary.py``); ``--robust`` arms the
robust commit filter and quarantine (``fleet/robust.py``, commit v2).
``--topology gossip`` removes the coordinator: peers exchange records
epidemically (``fleet/gossip.py``) and each closes every step itself
through the deterministic commit rule; ``--partition lo:hi:w+w``
schedules a temporary split.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .. import obs
from ..configs import (FleetConfig, GossipConfig, LaneConfig, RobustConfig,
                       get_arch, reduced)
from ..core import api, keys, zo
from ..data.synthetic import token_batch
from ..fleet import (make_int8_probe_fn, make_reference_step,
                     parse_byzantine, reference_state, run_fleet)
from ..train.train_loop import LoopConfig, run


def _parse_partitions(ap, args):
    """'lo:hi:w+w+w,...' -> ((lo, hi, group_bitmask), ...)."""
    parts = []
    for p in args.partition.split(","):
        if not p:
            continue
        bits = p.split(":")
        if len(bits) != 3:
            ap.error(f"--partition entry {p!r} must be lo:hi:w+w+w")
        try:
            lo, hi = int(bits[0]), int(bits[1])
            group = 0
            for w in bits[2].split("+"):
                wi = int(w)
                if not 0 <= wi < args.workers:
                    ap.error(f"--partition worker {wi} out of range for "
                             f"--workers {args.workers}")
                group |= 1 << wi
        except ValueError:
            ap.error(f"--partition entry {p!r} must be lo:hi:w+w+w")
        parts.append((lo, hi, group))
    return tuple(parts)


def _parse_crashes(ap, args):
    crashes = []
    for c in args.crash.split(","):
        if not c:
            continue
        parts = c.split(":")
        if len(parts) != 3:
            ap.error(f"--crash entry {c!r} must be worker:step:down")
        w, cs, down = (int(x) for x in parts)
        if not 0 <= w < args.workers:
            ap.error(f"--crash worker {w} out of range for "
                     f"--workers {args.workers}")
        if cs < 0 or down < 1:
            ap.error(f"--crash entry {c!r}: step must be >= 0, down >= 1")
        crashes.append((w, cs, down))
    return tuple(crashes)


def lenet_int8_fleet_setup(bp_tail_layers: int = 1, probes: int = 1,
                           batch: int = 8, seed: int = 0, *, device=None):
    """LeNet-5 int8 fleet pieces: (params, lane, partition_fn, probe_fn,
    batch_fn), on ``device`` (the card unless it says otherwise). The one
    assembly of the paper's int8 deployment. ``bp_tail_layers`` counts
    trailing FC layers (paper: ZO-Feat-Cls1/2 = 1/2; 0 = Full-ZO INT8)."""
    from ..core.int8 import quant_from_float
    from ..data.synthetic import glyphs
    from ..models import lenet
    if not 0 <= bp_tail_layers <= 2:
        raise ValueError("int8 lane supports 0..2 tail FCs, got "
                         f"{bp_tail_layers}")
    device = api.resolve_device(device)
    c = 5 - bp_tail_layers
    tail_fcs = [("fc2", "fc2_in"), ("fc3", "fc3_in")][2 - bp_tail_layers:]
    lane = LaneConfig(lane="elastic_zo_int8", zo_num_probes=probes)
    partition_fn = lambda p, c=c: lenet.partition_at(p, c)  # noqa: E731
    probe_fn = make_int8_probe_fn(lenet.lenet5_forward_int8, lane,
                                  partition_fn, tail_fcs)
    params = lenet.init_lenet5_int8(seed, device=device)

    def batch_fn(step):
        xs, ys = glyphs(batch, seed=seed + 1, start=step * batch)
        return {"x": quant_from_float(torch.from_numpy(xs).to(device)),
                "y": torch.from_numpy(ys).to(device)}

    return params, lane, partition_fn, probe_fn, batch_fn


def trees_equal(a, b) -> bool:
    """Same structure and bitwise equal leaves (a ``QTensor``'s data and
    exponent both)."""
    la, lb = list(zo.leaves_with_path(a)), list(zo.leaves_with_path(b))

    def parts(x):
        return tuple(x) if isinstance(x, tuple) else (x,)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        len(parts(x)) == len(parts(y)) and all(
            s.dtype == t.dtype and torch.equal(s, t)
            for s, t in zip(parts(x), parts(y)))
        for (_, x), (_, y) in zip(la, lb))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="LM arch (fp32 lanes; default llama3-8b)")
    ap.add_argument("--lane", default="elastic_zo",
                    choices=["elastic_zo", "full_zo", "int8"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--probes-per-worker", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--bp-tail-layers", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None,
                    help="ZO learning rate (fp32 lanes; default 1e-2)")
    ap.add_argument("--eps", type=float, default=None,
                    help="SPSA eps (fp32 lanes; default 1e-3)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-record transport loss probability")
    ap.add_argument("--max-delay", type=int, default=0,
                    help="max record delivery delay (virtual ticks)")
    ap.add_argument("--deadline", type=int, default=0,
                    help="coordinator per-step wait (virtual ticks)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--snapshot-every", type=int, default=10)
    ap.add_argument("--crash", default="",
                    help="worker:step:down triples, comma-separated, e.g. "
                         "'3:5:4' = worker 3 dies at step 5 for 4 steps")
    ap.add_argument("--byzantine", default="",
                    help="worker:attack[:amp] triples, comma-separated, "
                         "e.g. '3:sign_flip,5:inflate:100' "
                         "(fleet/adversary.py)")
    ap.add_argument("--robust", action="store_true",
                    help="arm the Byzantine-robust commit filter + "
                         "quarantine (fleet/robust.py; commit v2)")
    ap.add_argument("--robust-k-mad", type=float, default=6.0,
                    help="scalar filter band half-width, in MADs")
    ap.add_argument("--robust-mode", default="mask",
                    choices=["mask", "clip"],
                    help="reject out-of-band probes, or clip their "
                         "loss-diffs to the band")
    ap.add_argument("--topology", default="star",
                    choices=["star", "gossip"],
                    help="star: a coordinator closes every step; gossip: "
                         "leaderless, every peer closes independently "
                         "via the deterministic commit rule "
                         "(fleet/gossip.py)")
    ap.add_argument("--gossip-fanout", type=int, default=2,
                    help="peers contacted per epidemic push round")
    ap.add_argument("--gossip-rounds", type=int, default=2,
                    help="push rounds per step (anti-entropy then runs "
                         "the component to quiescence)")
    ap.add_argument("--partition", default="",
                    help="lo:hi:w+w+w windows, comma-separated: during "
                         "steps [lo,hi) the listed workers split from "
                         "the rest; the majority side keeps committing "
                         "(gossip topology only)")
    ap.add_argument("--no-verify-reference", action="store_true",
                    help="skip the single-process reference re-run "
                         "(int8 lane verifies it by default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    obs.add_observability_args(ap)
    args = ap.parse_args(argv)
    args.crashes = _parse_crashes(ap, args)
    try:
        args.byzantine_specs = parse_byzantine(args.byzantine)
    except ValueError as e:
        ap.error(str(e))
    args.partitions = _parse_partitions(ap, args)
    if args.partitions and args.topology != "gossip":
        ap.error("--partition needs --topology gossip (the star "
                 "coordinator cannot survive a split)")
    if args.lane == "int8":
        # the int8 lane is integer-only LeNet-5: reject fp32-lane flags
        # instead of silently ignoring them
        for flag, val in (("--lr", args.lr), ("--eps", args.eps),
                          ("--arch", args.arch)):
            if val is not None:
                ap.error(f"{flag} does not apply to --lane int8 "
                         "(integer-only LeNet-5; Alg. 2 knobs live in "
                         "LaneConfig.int8_*)")
    try:
        args.fleet_cfg = fleet_config(args)
    except ValueError as e:
        ap.error(str(e))
    return args


def fleet_config(args) -> FleetConfig:
    robust = RobustConfig(mode=args.robust_mode, k_mad=args.robust_k_mad) \
        if args.robust else None
    gossip = GossipConfig(fanout=args.gossip_fanout,
                          rounds=args.gossip_rounds,
                          partitions=args.partitions) \
        if args.topology == "gossip" else None
    return FleetConfig(
        num_workers=args.workers, probes_per_worker=args.probes_per_worker,
        dropout=args.dropout, max_delay=args.max_delay,
        deadline=args.deadline, chaos_seed=args.chaos_seed,
        snapshot_every=args.snapshot_every, crashes=args.crashes,
        byzantine=args.byzantine_specs, robust=robust,
        topology=args.topology, gossip=gossip)


def setup(args):
    """(params, lane, partition_fn, probe_fn, loss_fn, batch_fn, name) of
    the lane the flags ask for, on ``--device``."""
    device = api.resolve_device(args.device)
    if args.lane == "int8":
        params, lane, partition_fn, probe_fn, batch_fn = \
            lenet_int8_fleet_setup(args.bp_tail_layers,
                                   args.probes_per_worker, args.batch,
                                   args.seed, device=device)
        return params, lane, partition_fn, probe_fn, None, batch_fn, \
            "lenet5-int8"
    lr = 1e-2 if args.lr is None else args.lr
    eps = 1e-3 if args.eps is None else args.eps
    cfg = get_arch(args.arch or "llama3-8b")
    if args.smoke:
        cfg = reduced(cfg)
    lane = LaneConfig(lane=args.lane, bp_tail_layers=args.bp_tail_layers,
                      zo_num_probes=args.probes_per_worker,
                      learning_rate=lr, zo_eps=eps)
    params = api.init(cfg, lane, seed=args.seed, device=device)

    def loss_fn(p, batch):
        return api.loss_fn(p, cfg, batch)

    def batch_fn(step):
        x, y, m = token_batch(args.batch, args.seq, cfg.vocab_size,
                              seed=args.seed + 1, step=step)
        return {k: torch.from_numpy(v).to(device)
                for k, v in (("tokens", x), ("labels", y), ("mask", m))}

    return params, lane, None, None, loss_fn, batch_fn, cfg.name


def verify_reference(res, params, probe_fn, loss_fn, batch_fn, steps,
                     base_seed) -> bool:
    """Replay the realised masks through the single-process reference
    (``train_loop.run`` with ``mask_fn``); True if it ends bitwise on the
    canon. Byzantine runs are driven by the arrival masks, since the
    reference re-derives validation, quarantine and the filter itself."""
    fleet = res.schema.fleet
    byz_path = bool(fleet.byzantine) or fleet.robust is not None
    drive = res.arrival_masks if byz_path else res.masks
    step_fn = make_reference_step(loss_fn, res.schema, probe_fn=probe_fn)
    state = reference_state(params, res.schema, base_seed)
    loop = LoopConfig(total_steps=steps, log_every=0,
                      n_probes=res.schema.n_probes,
                      mask_fn=lambda t: drive[t])
    state, _ = run(step_fn, state, batch_fn, loop, log=None)
    return trees_equal(state.params["model"], res.params)


def main(argv=None):
    args = parse_args(argv)
    obs.configure_from_args(args)
    params, lane, partition_fn, probe_fn, loss_fn, batch_fn, desc = \
        setup(args)
    fleet_cfg = args.fleet_cfg
    base_seed = keys.key_data(args.seed + 1)
    obs.log("fleet", f"{desc}: {args.workers} workers x "
            f"{args.probes_per_worker} probes, lane={args.lane}, "
            f"topology={args.topology}, dropout={args.dropout}, "
            f"crashes={args.crashes or 'none'}, "
            f"partitions={args.partition or 'none'}, "
            f"byzantine={args.byzantine or 'none'}, "
            f"robust={'on' if args.robust else 'off'}, "
            f"device={params_device_name(params)}")
    res = run_fleet(loss_fn, params, lane, fleet_cfg, batch_fn,
                    steps=args.steps, base_seed=base_seed,
                    partition_fn=partition_fn, probe_fn=probe_fn,
                    log_every=max(args.steps // 10, 1))
    for e in res.coordinator.events:
        obs.log("fleet", f"event: {e}")
    s = res.stats
    n_records = sum(len(t) for t in res.ledger.records.values())
    per_worker_step = s["ledger_bytes_zo"] / max(n_records, 1)
    # step 0 always holds a record: a step is never empty (the commit
    # rule force-accepts the earliest arrival)
    some_rec = next(iter(res.ledger.records[0].values()))
    obs.log("fleet", f"done: {s['steps']} steps, wall {s['wall_s']:.1f}s; "
            f"ZO wire {s['ledger_bytes_zo']}B "
            f"({per_worker_step:.1f}B/record, "
            f"{some_rec.zo_probe_nbytes}B/probe), tail wire "
            f"{s['ledger_bytes_tail']}B, catch-up {s['bytes_catchup']}B; "
            f"dropped {s['n_dropped']}, straggled {s['n_straggled']}, "
            f"redelivered {s['n_redelivered']}, "
            f"rejoins {s['n_catchups']}; rejected {s['n_rejected']}, "
            f"filtered probes {s['n_filtered_probes']}, "
            f"quarantines {s['n_quarantines']}"
            + (f"; gossip wire {s['bytes_gossip']}B, "
               f"reconciles {s['n_reconciles']}"
               if s["topology"] == "gossip" else ""))

    failed = False
    if args.lane == "int8" and some_rec.zo_probe_nbytes > 9:
        obs.log("fleet", "ERROR int8 ZO probe entry is "
                f"{some_rec.zo_probe_nbytes}B on the wire (> 9B budget)",
                level="error")
        failed = True

    n_exact = n_checked = 0
    for w in res.workers:
        if not w.alive:
            # crash scheduled past the end of the run: nothing to verify
            obs.log("fleet", f"note: worker {w.id} still down at end of run")
            continue
        ok = trees_equal(w.params, res.params)
        if not ok:
            obs.log("fleet", f"ERROR worker {w.id} diverged from the canon",
                    level="error")
            failed = True
        n_exact += ok
        n_checked += 1
    who = "the coordinator" if args.topology == "star" \
        else "every other surviving peer (leaderless canon)"
    obs.log("fleet", f"{n_exact}/{n_checked} live workers bit-exact with "
            f"{who} at step {res.coordinator.step}")

    if args.lane == "int8" and not args.no_verify_reference:
        if verify_reference(res, params, probe_fn, None, batch_fn,
                            args.steps, base_seed):
            obs.log("fleet", "single-process int8 reference: bit-exact")
        else:
            obs.log("fleet", "ERROR fleet diverged from the "
                    "single-process int8 reference", level="error")
            failed = True

    obs.write_outputs(args)
    if failed:
        sys.exit(1)
    return res


def params_device_name(params) -> str:
    from ..fleet.replay import params_device
    dev = params_device(params)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


if __name__ == "__main__":
    main()
