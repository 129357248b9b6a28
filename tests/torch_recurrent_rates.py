"""The elastic_zo lane of every case of ``test_torch_mesh_rwkv.py`` and
``test_torch_mesh_jamba.py`` at one ZO rate, on CPU ranks beside JAX:
how far two meshes' steps land apart at that rate, in units of
``LM_TOL`` (the largest |a - b| / (atol + rtol |b|) over the leaves
after the lane's 2 steps; 1 is the tolerance's edge).

For each case it prints the port's step against JAX's on the same mesh,
against the port's one-device step, and JAX's against that one-device
step; then JAX's meshes of the same config and batch against each
other. A case whose meshes land apart in JAX as in the port carries
rounding amplified by the rate, not a fault of the port
(``torch_recurrent_ranks.rate_of``).

Run from the repo root (a few minutes on 4 CPU cores):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_recurrent_rates.py [rate]

``rate`` defaults to 1e-2, the lanes' own.
"""
import itertools
import os
import sys
import tempfile

import numpy as np

import torch_recurrent_ranks as ranks

LANE = "elastic_zo"


def lm_tol_units(got, want):
    """The largest distance over the leaves of ``want``, in LM_TOL."""
    worst = 0.0
    for k, w in want.items():
        if k in ("losses", "attn", "moe", "batch_axes") or not w.size:
            continue
        w = np.asarray(w, np.float64)
        d = np.abs(np.asarray(got[k], np.float64) - w)
        worst = max(worst, float((d / (1e-4 + 1e-3 * np.abs(w))).max()))
    return worst


def report(out, suite_name, rate):
    from repro_torch.core import api, zo
    cases = ranks.suite_cases(suite_name, rate)
    jax = {n: dict(np.load(os.path.join(out, f"jax_{n}_{LANE}.npz")))
           for n in cases}
    for name, case in cases.items():
        got = dict(np.load(os.path.join(out, f"{name}_{LANE}.npz")))
        params = ranks.load_params(
            os.path.join(out, ranks.init_name(case) + ".npz"), case)
        _, one = ranks.run_steps(
            api.make_train_step(ranks.cfg_of(case),
                                ranks.lane_of(LANE, case)),
            params, ranks.batches(out, case, ranks.LANE_STEPS[LANE]))
        one = {zo.keystr(p): t.numpy() for p, t in zo.leaves_with_path(one)}
        print(f"{suite_name} {name} at {rate}: port / JAX "
              f"{lm_tol_units(got, jax[name]):.4g}, port / one device "
              f"{lm_tol_units(got, one):.4g}, JAX / one device "
              f"{lm_tol_units(jax[name], one):.4g}")
    same = {}
    for name, case in cases.items():
        same.setdefault(case[3:5], []).append(name)
    for names in same.values():
        for a, b in itertools.combinations(names, 2):
            print(f"{suite_name} JAX {a} / JAX {b} at {rate}: "
                  f"{lm_tol_units(jax[a], jax[b]):.4g}")


def main():
    rate = float(sys.argv[1]) if len(sys.argv) > 1 else 1e-2
    for suite_name in ranks.SUITES:
        with tempfile.TemporaryDirectory() as out:
            ranks.run_suite(out, suite_name, 4, rate)
            report(out, suite_name, rate)


if __name__ == "__main__":
    main()
