"""Quickstart: the port's public API in ~60 lines.

Builds a small LLaMA-family model, trains it with ElasticZO (ZO body +
BP tail), then serves it (prefill + greedy decode), on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import LaneConfig, get_arch, reduced
from repro_torch.core import api, zo
from repro_torch.data.synthetic import token_batch
from repro_torch.serve.kv_pages import grow_dense_caches
from repro_torch.train.train_loop import init_state


def main(steps: int = 40, device=None):
    """Trains ``steps`` steps, decodes 8 tokens; returns {"losses": the
    loss of every step, "decoded": row 0's prefill token and 8 decoded}."""
    device = api.resolve_device(device)
    # 1. pick an architecture and reduce it to a laptop-size config of the
    #    same family
    cfg = reduced(get_arch("llama3-8b"), num_layers=4, d_model=128, d_ff=256)
    # 2. the training lane: ElasticZO = ZO for the body, BP for the last
    #    layer
    lane = LaneConfig(lane="elastic_zo", bp_tail_layers=1,
                      learning_rate=5e-2, zo_eps=1e-3, zo_num_probes=2)
    params = api.init(cfg, lane, seed=0, device=device)
    state = init_state(params, seed=1)
    step = api.make_train_step(cfg, lane)

    print(f"training {cfg.name} on {device}: "
          f"{sum(t.numel() for t in zo.leaves(params)):,} params, "
          f"lane={lane.lane}")
    losses = []
    for i in range(steps):
        x, y, m = token_batch(8, 128, cfg.vocab_size, seed=0, step=i)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in (("tokens", x), ("labels", y), ("mask", m))}
        state, metrics = step(state, batch, np.ones((2,), np.float32))
        losses.append(metrics["loss"])
        if i % 10 == 0:
            print(f"  step {i:3d}  loss {float(metrics['loss']):.4f}  "
                  f"|g|={float(metrics['zo_g']):.3f}")
    losses = [float(v) for v in losses]
    assert all(np.isfinite(losses)), losses

    # 3. serve it: prefill a prompt, then decode greedily with the KV cache
    prompt = torch.from_numpy(token_batch(2, 128, cfg.vocab_size,
                                          seed=5)[0]).to(device)
    with torch.no_grad():
        nxt, caches = api.prefill_step(state.params, cfg, prompt)
        caches = grow_dense_caches(caches, cfg, 144)
        out = [nxt]
        for t in range(8):
            nxt, caches = api.decode_step(state.params, cfg, nxt, caches,
                                          128 + t)
            out.append(nxt)
    decoded = [int(t[0, 0]) for t in out]
    print("decoded:", decoded)
    print("quickstart OK")
    return {"losses": losses, "decoded": decoded}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None)
    main(**vars(ap.parse_args()))
