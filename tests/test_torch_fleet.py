"""Port parity: the seed-ledger fleet against the JAX package.

One JAX fleet per lane (4 workers, 4 steps, dropout, stragglers and a
crash whose catch-up replays 3 steps from the step-0 snapshot) and the
port's fleet from the same converted init:

  * int8 (LeNet-5, Alg. 2): the ledgers are equal byte for byte and the
    parameters bitwise, every step;
  * fp32 (the reduced LM of ``tests/test_fleet.py``, in f32): the port
    replaying JAX's ledger lands on JAX's canon within ``LM_TOL``
    (XLA's jitted probes and eager torch sum in other orders); the
    port's own records carry JAX's seeds bitwise, losses within
    ``LM_TOL`` and loss differences within its atol.

Within the port everything is bitwise: each live worker equals the
coordinator and the fleet equals the single-process reference, star and
gossip alike, and delta checkpoints restore through ``make_replay_fn``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import FleetConfig as JFleetConfig  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.int8 import QTensor as JQ  # noqa: E402
from repro.core.int8 import quant_from_float as jquant  # noqa: E402
from repro.data.synthetic import glyphs as jglyphs  # noqa: E402
from repro.data.synthetic import token_batch as jtoken_batch  # noqa: E402
from repro.fleet import make_int8_probe_fn as jmake_int8_probe_fn  # noqa: E402
from repro.fleet import run_fleet as jrun_fleet  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import FleetConfig, GossipConfig, LaneConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import api, engine  # noqa: E402
from repro_torch.core.int8 import QTensor, quant_from_float  # noqa: E402
from repro_torch.data.synthetic import glyphs, token_batch  # noqa: E402
from repro_torch.fleet import (Ledger, make_int8_probe_fn,  # noqa: E402
                               make_reference_step, make_replay_fn,
                               reference_state, run_fleet)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import fleet as launch_fleet  # noqa: E402
from repro_torch.launch.fleet import trees_equal  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.train_loop import LoopConfig, run  # noqa: E402

replay_mod = importlib.import_module("repro_torch.fleet.replay")
LM_TOL = dict(rtol=1e-3, atol=1e-4)
STEPS, WORKERS = 4, 4
CHAOS = dict(num_workers=WORKERS, probes_per_worker=1, dropout=0.25,
             max_delay=2, deadline=1, chaos_seed=1, snapshot_every=10,
             crashes=((1, 1, 2),))      # down at step 1, rejoins at 3
TAIL_FCS = [("fc3", "fc3_in")]


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _assert_port_equals_jax(port, jtree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(_np(jtree))[0]
    pflat = ckpt.flatten_with_keys(port)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [k for k, _ in pflat]
    for (path, want), (_, got) in zip(jflat, pflat):
        got = got.float().numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
        if tol:
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       err_msg=str(path), **tol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(path))


def _check_reference(res, params, batch_fn, loss_fn=None, probe_fn=None):
    """The port's fleet == the port's single-process reference driven by
    the realised masks, and every live worker == the canon, bitwise."""
    for w in res.workers:
        assert w.alive and w.step == STEPS
        assert trees_equal(w.params, res.params), f"worker {w.id}"
    step_fn = make_reference_step(loss_fn, res.schema, probe_fn=probe_fn)
    state = reference_state(params, res.schema, res.schema.base_seed)
    loop = LoopConfig(total_steps=STEPS, log_every=0,
                      n_probes=res.schema.n_probes,
                      mask_fn=lambda t: res.masks[t])
    state, _ = run(step_fn, state, batch_fn, loop, log=None)
    assert trees_equal(state.params["model"], res.params)


# ------------------------------------------------------------------ #
# int8: LeNet-5, bitwise against JAX
# ------------------------------------------------------------------ #
def _int8_part(p):
    return lenet.partition_at(p, 4)


@pytest.fixture(scope="module")
def int8_runs():
    jl = JLane(lane="elastic_zo_int8", zo_num_probes=1)

    def jbatch(step):
        xs, ys = jglyphs(8, seed=1, start=step * 8)
        return {"x": jquant(jnp.asarray(xs)), "y": jnp.asarray(ys)}

    jpart = lambda p: jlenet.partition_at(p, 4)  # noqa: E731
    jparams = jlenet.init_lenet5_int8(jax.random.key(0))
    base = np.asarray(jax.random.key_data(jax.random.key(1)), np.uint32)
    jres = jrun_fleet(None, jparams, jl, JFleetConfig(**CHAOS), jbatch,
                      steps=STEPS, base_seed=base, partition_fn=jpart,
                      probe_fn=jmake_int8_probe_fn(
                          jlenet.lenet5_forward_int8, jl, jpart, TAIL_FCS),
                      trace=True)

    lane = LaneConfig(lane="elastic_zo_int8", zo_num_probes=1)

    def batch(step):
        xs, ys = glyphs(8, seed=1, start=step * 8)
        return {"x": quant_from_float(torch.from_numpy(xs)),
                "y": torch.from_numpy(ys)}

    params = params_from_jax(_np(jparams), "cpu")
    probe_fn = make_int8_probe_fn(lenet.lenet5_forward_int8, lane,
                                  _int8_part, TAIL_FCS)
    shapes = []
    real = ops.zo_fused_replay_int8_leaves

    def counting(thetas, seeds, *a, **k):
        shapes.append(tuple(seeds.shape))
        return real(thetas, seeds, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "zo_fused_replay_int8_leaves", counting)
    try:
        res = run_fleet(None, params, lane, FleetConfig(**CHAOS), batch,
                        steps=STEPS, base_seed=base, partition_fn=_int8_part,
                        probe_fn=probe_fn, trace=True)
    finally:
        mp.undo()
    return dict(jres=jres, jparams=jparams, res=res, params=params,
                batch=batch, probe_fn=probe_fn, replay_shapes=shapes)


def test_int8_ledger_and_params_bitwise_as_jax(int8_runs):
    jres, res = int8_runs["jres"], int8_runs["res"]
    assert res.stats["n_dropped"] and res.stats["n_straggled"]
    assert res.stats["n_catchups"] == 1
    for a, b in zip(jres.masks, res.masks):
        np.testing.assert_array_equal(a, b)
    assert res.ledger.to_bytes() == jres.ledger.to_bytes()
    rec = next(iter(res.ledger.records[0].values()))
    assert rec.numerics == "int8" and rec.zo_probe_nbytes == 9
    for t, (a, b) in enumerate(zip(jres.param_trace, res.param_trace)):
        _assert_port_equals_jax(b, a)
    _assert_port_equals_jax(res.params, jres.params)


def test_int8_catchup_replays_three_steps_in_one_launch(int8_runs):
    """Worker 1 rejoins at step 3 from the step-0 snapshot: one replay
    call of S = 3 steps x n = 4 probes; every live apply is S = 1."""
    shapes = int8_runs["replay_shapes"]
    assert shapes.count((3, WORKERS)) == 1
    assert set(shapes) == {(1, WORKERS), (3, WORKERS)}


def test_int8_fleet_equals_port_reference(int8_runs):
    _check_reference(int8_runs["res"], int8_runs["params"],
                     int8_runs["batch"], probe_fn=int8_runs["probe_fn"])


def test_delta_checkpoints_restore_through_replay(int8_runs, tmp_path):
    """A port-written and a JAX-written delta (full base + ledger slice)
    both restore through the port's make_replay_fn onto the canon."""
    res, jres = int8_runs["res"], int8_runs["jres"]
    base_step, base = res.coordinator.nearest_snapshot(STEPS - 1)
    ckpt.save(tmp_path / "port", base_step, base)
    ckpt.save_delta(tmp_path / "port", STEPS, base_step,
                    res.ledger.slice_bytes(base_step, STEPS))
    jbase_step, jbase = jres.coordinator.nearest_snapshot(STEPS - 1)
    jckpt.save(tmp_path / "jax", jbase_step, jbase)
    jckpt.save_delta(tmp_path / "jax", STEPS, jbase_step,
                     jres.ledger.slice_bytes(jbase_step, STEPS))
    for d in ("port", "jax"):
        got, step = ckpt.restore(tmp_path / d, int8_runs["params"],
                                 replay_fn=make_replay_fn(res.schema))
        assert step == STEPS and trees_equal(got, res.params), d


def test_apply_tail_records_as_jax():
    """Both engines' ledger-domain tail against JAX's: fp32 (with lr decay
    and a bf16 leaf) and int8, bitwise."""
    rng = np.random.default_rng(1)
    kw = dict(lane="elastic_zo", learning_rate=0.05, lr_decay_every=2,
              lr_decay_factor=0.5)
    bp = {"u": rng.normal(size=(7, 3)).astype(np.float32),
          "n": {"g": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{"u": rng.normal(size=(7, 3)).astype(np.float32),
              "n": {"g": rng.normal(size=(5,)).astype(np.float32)}}
             for _ in range(3)]
    jbp = jax.tree.map(jnp.asarray, bp)
    jbp["n"]["g"] = jbp["n"]["g"].astype(jnp.bfloat16)
    want = jengine.Fp32Engine(JLane(**kw)).apply_tail_records(
        jbp, 5, [jax.tree.map(jnp.asarray, g) for g in grads],
        np.float32(3))
    pbp = params_from_jax(_np(jbp), "cpu")
    pbp["n"]["g"] = pbp["n"]["g"].to(torch.bfloat16)
    got = engine.Fp32Engine(LaneConfig(**kw)).apply_tail_records(
        pbp, 5, iter([params_from_jax(g, "cpu") for g in grads]),
        np.float32(3))
    assert got["n"]["g"].dtype == torch.bfloat16
    _assert_port_equals_jax(got, want)

    q = {n: {"w": JQ(jnp.asarray(rng.integers(-127, 128, s), jnp.int8),
                     jnp.int32(-3))} for n, s in (("fc2", (6, 4)),
                                                  ("fc3", (4, 2)))}
    upds = [{n: {"w": jnp.asarray(rng.integers(-127, 128, sub["w"].data
                                               .shape), jnp.int8)}
             for n, sub in q.items()} for _ in range(3)]
    jl = JLane(lane="elastic_zo_int8")
    want = jengine.Int8Engine(jl).apply_tail_records(q, 2, upds)
    got = engine.Int8Engine(LaneConfig(lane="elastic_zo_int8")) \
        .apply_tail_records(
            params_from_jax(_np(q), "cpu"), 2,
            ({n: {"w": torch.from_numpy(np.array(s["w"]))}
              for n, s in u.items()} for u in upds))
    assert isinstance(got["fc2"]["w"], QTensor)
    _assert_port_equals_jax(got, want)


# ------------------------------------------------------------------ #
# fp32: the reduced LM of tests/test_fleet.py, in f32
# ------------------------------------------------------------------ #
LM_KW = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
             head_dim=16, d_ff=64, vocab_size=128, dtype="float32")
LANE_KW = dict(lane="elastic_zo", bp_tail_layers=1, learning_rate=5e-2,
               zo_eps=1e-3)


def _lm_batch(step):
    x, y, m = token_batch(2, 16, 128, seed=1, step=step)
    return {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y),
            "mask": torch.from_numpy(m)}


@pytest.fixture(scope="module")
def fp32_runs():
    jcfg = jreduced(JARCHS["llama3-8b"], **LM_KW)
    jl = JLane(**LANE_KW)
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    model = japi.build(jcfg, shape, jl, ShardingRules(None, jcfg, shape))
    jparams = model.init(jax.random.key(0))
    base = np.asarray(jax.random.key_data(jax.random.key(1)), np.uint32)

    def jbatch(step):
        x, y, m = jtoken_batch(2, 16, 128, seed=1, step=step)
        return {"tokens": jnp.asarray(x), "labels": jnp.asarray(y),
                "mask": jnp.asarray(m)}

    jres = jrun_fleet(model.loss_fn, jparams, jl, JFleetConfig(**CHAOS),
                      jbatch, steps=STEPS, base_seed=base)
    cfg = configs.reduced(configs.ARCHS["llama3-8b"], **LM_KW)

    def loss_fn(p, b):
        return api.loss_fn(p, cfg, b)

    params = params_from_jax(_np(jparams), "cpu")
    res = run_fleet(loss_fn, params, LaneConfig(**LANE_KW),
                    FleetConfig(**CHAOS), _lm_batch, steps=STEPS,
                    base_seed=base)
    return dict(jres=jres, res=res, params=params, loss_fn=loss_fn)


def test_port_replays_jax_ledger_onto_jax_canon(fp32_runs):
    jres, res = fp32_runs["jres"], fp32_runs["res"]
    led = Ledger.from_bytes(jres.ledger.to_bytes())
    got = replay_mod.replay(fp32_runs["params"], led, res.schema, 0, STEPS)
    _assert_port_equals_jax(got, jres.params, **LM_TOL)


def test_port_records_match_jax_records(fp32_runs):
    jres, res = fp32_runs["jres"], fp32_runs["res"]
    assert res.stats["n_catchups"] == 1
    for a, b in zip(jres.masks, res.masks):
        np.testing.assert_array_equal(a, b)
    assert sorted(jres.ledger.commits) == sorted(res.ledger.commits)
    for t in range(STEPS):
        assert res.ledger.commits[t].to_bytes() == \
            jres.ledger.commits[t].to_bytes()
        jr, pr = jres.ledger.records[t], res.ledger.records[t]
        assert sorted(jr) == sorted(pr)
        for w in jr:
            a, b = jr[w], pr[w]
            np.testing.assert_array_equal(a.seeds, b.seeds)
            assert b.numerics == "fp32" and b.zo_probe_nbytes == 12
            np.testing.assert_allclose(b.loss, a.loss, **LM_TOL)
            np.testing.assert_allclose(b.deltas, a.deltas, rtol=0,
                                       atol=LM_TOL["atol"])
            assert [q.size for q in a.tail_q] == [q.size for q in b.tail_q]


def test_fp32_fleet_equals_port_reference(fp32_runs):
    _check_reference(fp32_runs["res"], fp32_runs["params"], _lm_batch,
                     loss_fn=fp32_runs["loss_fn"])


@pytest.mark.parametrize("lane", ["fp32", "int8"])
def test_gossip_fleet_equals_port_reference(lane, int8_runs, fp32_runs):
    """Leaderless: every peer closes each step itself; a partition
    window and the crash; all surviving peers and the reference agree."""
    chaos = dict(CHAOS, topology="gossip",
                 gossip=GossipConfig(partitions=((1, 2, 0b0001),)))
    if lane == "int8":
        runs, loss_fn = int8_runs, None
        kw = dict(partition_fn=_int8_part, probe_fn=runs["probe_fn"])
        lcfg, batch = LaneConfig(lane="elastic_zo_int8"), runs["batch"]
    else:
        runs, loss_fn = fp32_runs, fp32_runs["loss_fn"]
        kw, lcfg, batch = {}, LaneConfig(**LANE_KW), _lm_batch
    res = run_fleet(loss_fn, runs["params"], lcfg, FleetConfig(**chaos),
                    batch, steps=STEPS, base_seed=runs["res"].schema.base_seed,
                    **kw)
    assert res.stats["topology"] == "gossip" and res.stats["n_reconciles"]
    _check_reference(res, runs["params"], batch, loss_fn=loss_fn,
                     probe_fn=kw.get("probe_fn"))


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #
def test_fleet_cli_int8_on_cpu(capsys):
    res = launch_fleet.main(["--lane", "int8", "--device", "cpu",
                             "--workers", "3", "--steps", "3",
                             "--crash", "1:1:1"])
    out = capsys.readouterr().out
    assert "3/3 live workers bit-exact" in out
    assert "single-process int8 reference: bit-exact" in out
    assert res.stats["n_catchups"] == 1


def test_fleet_cli_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_fleet.main(["--lane", "int8", "--steps", "1"])


def test_fleet_rejects_clean_tail_grads():
    with pytest.raises(ValueError, match="avg_perturbed"):
        from repro_torch.fleet import make_probe_fn
        make_probe_fn(None, dataclasses.replace(LaneConfig(**LANE_KW),
                                                bp_grad_mode="clean"))
