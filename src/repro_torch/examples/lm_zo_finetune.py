"""LM-scale ElasticZO: the paper's technique on a transformer LM.

Compares the three lanes (full_zo / elastic_zo / full_bp) on a reduced
llama3-family config: the hybrid recovers most of the BP convergence
while the ZO part needs no gradient memory.

    PYTHONPATH=src python -m repro_torch.examples.lm_zo_finetune [--device cpu] [--steps N]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import LaneConfig, get_arch, reduced
from repro_torch.core import api
from repro_torch.data.synthetic import token_batch
from repro_torch.train.train_loop import init_state

SEQ, BATCH = 64, 8


def run_lane(lane_name, cfg, steps, device, probes=4):
    """The loss of every step of one lane."""
    # per-lane lr, as the paper tunes per experiment: ZO needs a far
    # smaller step than BP (SPSA step variance scales with dim)
    zo_lr = 2e-3 if lane_name != "full_bp" else 0.05
    lane = LaneConfig(lane=lane_name, bp_tail_layers=1, learning_rate=zo_lr,
                      tail_learning_rate=0.05, zo_eps=1e-2,
                      zo_num_probes=probes,
                      lr_decay_factor=0.8, lr_decay_every=max(steps // 10, 1))
    state = init_state(api.init(cfg, lane, seed=0, device=device), 1)
    step = api.make_train_step(cfg, lane)
    pm = np.ones((probes,), np.float32)
    losses = []
    for i in range(steps):
        x, y, m = token_batch(BATCH, SEQ, cfg.vocab_size, seed=3, step=i % 4)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in (("tokens", x), ("labels", y), ("mask", m))}
        state, metrics = step(state, batch, pm)
        losses.append(metrics["loss"])
    return [float(v) for v in losses]


def main(steps: int = 60, device=None, check: bool = True):
    """Returns {"losses": {lane: every step's loss}, "drops": {lane: first
    loss - lowest}}; ``check`` asserts the paper's ordering (elastic_zo's
    drop at least full_zo's - 0.05)."""
    device = api.resolve_device(device)
    cfg = reduced(get_arch("llama3-8b"), num_layers=4, d_model=128,
                  d_ff=256, vocab_size=512)
    print(f"config: {cfg.name} L={cfg.num_layers} d={cfg.d_model}")
    results = {}
    for lane in ("full_zo", "elastic_zo", "full_bp"):
        losses = run_lane(lane, cfg, steps, device)
        results[lane] = losses
        print(f"{lane:11s}: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    # paper ordering: elastic between zo and bp
    drop = {k: v[0] - min(v) for k, v in results.items()}
    print("loss drops:", {k: f"{v:.3f}" for k, v in drop.items()})
    if check:
        assert drop["elastic_zo"] >= drop["full_zo"] - 0.05, \
            "elastic should converge at least as fast as pure ZO"
        print("lm_zo_finetune OK")
    return {"losses": results, "drops": drop}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None)
    main(**vars(ap.parse_args()))
