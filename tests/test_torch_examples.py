"""The port's four examples (``repro_torch.examples``) on the CPU.

Each example's ``main`` runs at a handful of steps and returns finite
numbers in its structure; ``int8_ondevice`` is held bitwise against the
same loop written with the JAX package's API (``make_int8_elastic_step``,
``int8_eval``): the int8 lane is integer arithmetic, so its parameters,
gradient signs and accuracies are equal, and only the f32 loss metric is
compared within 1e-6. The examples' own claims hold at their default
step counts, on the card (``chip_smoke.py``); here ``check=False``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.core.elastic import TrainState as JState  # noqa: E402
from repro.core.elastic_int8 import int8_eval as jint8_eval  # noqa: E402
from repro.core.elastic_int8 import (  # noqa: E402
    make_int8_elastic_step as jmake)
from repro.core.int8 import quant_from_float as jquant  # noqa: E402
from repro.data.synthetic import glyphs as jglyphs  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.examples import (finetune_rotated, int8_ondevice,  # noqa: E402
                                  lm_zo_finetune, quickstart)
from repro_torch.train import checkpoint as ckpt  # noqa: E402


def test_quickstart_trains_and_decodes():
    out = quickstart.main(steps=2, device="cpu")
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    vocab = get_arch("llama3-8b").padded_vocab
    assert len(out["decoded"]) == 9
    assert all(0 <= t < vocab for t in out["decoded"])


def test_finetune_rotated_runs_every_lane():
    out = finetune_rotated.main(steps=3, device="cpu", check=False)
    assert 0.0 <= out["pretrained_acc"] <= 1.0
    assert sorted(out["acc"]) == sorted(finetune_rotated.LANES)
    assert all(0.0 <= a <= 1.0 for a in out["acc"].values())


def test_lm_zo_finetune_runs_the_three_lanes():
    out = lm_zo_finetune.main(steps=2, device="cpu", check=False)
    assert sorted(out["losses"]) == ["elastic_zo", "full_bp", "full_zo"]
    for lane, losses in out["losses"].items():
        assert len(losses) == 2 and np.all(np.isfinite(losses)), lane
        assert out["drops"][lane] == losses[0] - min(losses)


def _jax_int8_loop(steps, batch):
    """The example's loop with the JAX package's API."""
    lane = JLane(int8_r_max=3, int8_p_zero=0.33, int8_b_zo=1, int8_b_bp=5)
    step = jax.jit(jmake(jlenet.lenet5_forward_int8,
                         partition_fn=lambda p: jlenet.partition_at(p, 4),
                         tail_fcs=[("fc3", "fc3_in")], lane=lane,
                         loss_mode="int"))
    # the init, quantiser and eval jitted: their eager dispatch compiles
    # each op apart (~20 s here); the jitted init is the eager one bitwise
    evaluate = jax.jit(lambda p, x, y: jint8_eval(jlenet.lenet5_forward_int8,
                                                  p, x, y))
    quant = jax.jit(jquant)
    state = JState(jax.jit(jlenet.init_lenet5_int8)(jax.random.key(0)),
                   jnp.int32(0), jax.random.key_data(jax.random.key(2)))
    xs_tr, ys_tr = jglyphs(2048, seed=0)
    xs_te, ys_te = jglyphs(512, seed=1, start=10_000)
    qx_te, y_te = quant(jnp.asarray(xs_te)), jnp.asarray(ys_te)
    log = []
    for s in range(steps):
        i0 = (s * batch) % 2048
        bx = quant(jnp.asarray(xs_tr[i0:i0 + batch]))
        by = jnp.asarray(ys_tr[i0:i0 + batch])
        state, m = step(state, {"x": bx, "y": by}, jnp.ones((1,)))
        if s % max(steps // 8, 1) == 0:
            acc = evaluate(state.params, qx_te, y_te)
            log.append((s, float(m["loss"]), float(acc), int(m["g"])))
    return float(evaluate(state.params, qx_te, y_te)), log, state.params


def test_int8_ondevice_is_the_jax_loop_bitwise():
    steps, batch = 8, 64
    got = int8_ondevice.main(steps=steps, batch=batch, device="cpu",
                             check=False)
    acc, log, params = _jax_int8_loop(steps, batch)
    assert got["acc"] == acc
    assert [(s, a, g) for s, _, a, g in got["log"]] == \
        [(s, a, g) for s, _, a, g in log]
    np.testing.assert_allclose([v for _, v, _, _ in got["log"]],
                               [v for _, v, _, _ in log], rtol=0, atol=1e-6)
    flat = ckpt.flatten_with_keys(got["state"].params)
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (k, a), (_, b) in zip(flat, jflat):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), k
    assert got["state"].step == steps
