"""ElasticZO-INT8 (Alg. 2): integer-arithmetic-only on-device learning.

Trains the int8 LeNet-5 with the ternary integer loss-sign gradient
(INT8*, §4.3) and the NITI int8 BP tail: no float op touches the model
path (the fp32 numbers printed are evaluation only). On the card the
noise and the products run in the int8 kernels (``int8_perturb``,
``zo_fused_replay_int8``, ``int8_matmul``).

    PYTHONPATH=src python -m repro_torch.examples.int8_ondevice [--device cpu] [--steps N]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import LaneConfig
from repro_torch.core import api
from repro_torch.core.elastic_int8 import int8_eval, make_int8_elastic_step
from repro_torch.core.int8 import quant_from_float
from repro_torch.data.synthetic import glyphs
from repro_torch.models import lenet
from repro_torch.train.train_loop import init_state


def main(steps: int = 400, batch: int = 64, device=None, check: bool = True):
    """Returns {"acc": the final int8* test accuracy, "log": (step, loss,
    test accuracy, g) at every ``steps // 8``-th step, "state": the
    trained state}; ``check`` asserts the accuracy claim (above 0.5, which
    holds at the default 400 steps)."""
    device = api.resolve_device(device)
    lane = LaneConfig(int8_r_max=3, int8_p_zero=0.33, int8_b_zo=1,
                      int8_b_bp=5)
    # ZO-Feat-Cls1: convs+fc1+fc2 via integer ZO, fc3 via integer BP
    step = make_int8_elastic_step(
        lenet.lenet5_forward_int8,
        partition_fn=lambda p: lenet.partition_at(p, 4),
        tail_fcs=[("fc3", "fc3_in")], lane=lane, loss_mode="int")

    state = init_state(lenet.init_lenet5_int8(0, device=device), 2)
    xs_tr, ys_tr = glyphs(2048, seed=0)
    xs_te, ys_te = glyphs(512, seed=1, start=10_000)
    qx_te = quant_from_float(torch.from_numpy(xs_te).to(device))
    y_te = torch.from_numpy(ys_te).to(device)

    log = []
    with api.f32_products(), api.deterministic():
        for s in range(steps):
            i0 = (s * batch) % 2048
            bx = quant_from_float(
                torch.from_numpy(xs_tr[i0:i0 + batch]).to(device))
            by = torch.from_numpy(ys_tr[i0:i0 + batch]).to(device)
            state, m = step(state, {"x": bx, "y": by},
                            np.ones((1,), np.float32))
            if s % max(steps // 8, 1) == 0:
                acc = float(int8_eval(lenet.lenet5_forward_int8,
                                      state.params, qx_te, y_te))
                log.append((s, float(m["loss"]), acc, int(m["g"])))
                print(f"step {s:4d}  train-loss {log[-1][1]:.3f}  "
                      f"test-acc {acc * 100:.1f}%  g={log[-1][3]}")
        acc = float(int8_eval(lenet.lenet5_forward_int8, state.params,
                              qx_te, y_te))
    print(f"final int8* test accuracy: {acc * 100:.1f}%")
    if check:
        assert acc > 0.5, "integer-only training should beat chance by far"
        print("int8_ondevice OK")
    return {"acc": acc, "log": log, "state": state}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None)
    main(**vars(ap.parse_args()))
