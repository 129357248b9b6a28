"""Port parity: the fleet's host-side protocol against the JAX package.

Probe seeds, the ledger's wire bytes, the commit rule, the robust filter,
the chaos transport's fates and the error-feedback int8 compressor, on
the same seeded inputs in both packages. Everything here is integer or
strict f32 host math, so every comparison is bitwise.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import FleetConfig as JFleetConfig  # noqa: E402
from repro.configs import RobustConfig as JRobustConfig  # noqa: E402
from repro.fleet import commit_rule as jcommit_rule  # noqa: E402
from repro.fleet import ledger as jledger  # noqa: E402
from repro.fleet import robust as jrobust  # noqa: E402
from repro.fleet.transport import ChaosTransport as JTransport  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro_torch.configs import FleetConfig, RobustConfig  # noqa: E402
from repro_torch.fleet import commit_rule, ledger, robust  # noqa: E402
from repro_torch.fleet.transport import ChaosTransport  # noqa: E402
from repro_torch.train import compress  # noqa: E402

# the packages export a function named ``replay``; take the modules
jreplay = importlib.import_module("repro.fleet.replay")
replay = importlib.import_module("repro_torch.fleet.replay")
W, M = 6, 2


def _schemas(numerics, robust_on=True, workers=W, m=M):
    """A JAX and a port ReplaySchema carrying only what the host-side
    protocol reads (fleet config, base key, numerics)."""
    base = np.asarray(jax.random.key_data(jax.random.key(11)), np.uint32)
    kw = dict(num_workers=workers, probes_per_worker=m, dropout=0.3,
              max_delay=3, deadline=1, chaos_seed=5)
    jfleet = JFleetConfig(robust=JRobustConfig() if robust_on else None,
                          **kw)
    fleet = FleetConfig(robust=RobustConfig() if robust_on else None, **kw)
    eng = SimpleNamespace(numerics=numerics)
    js = jreplay.ReplaySchema(lane=None, fleet=jfleet, base_seed=base,
                              partition_fn=None, engine=eng)
    ps = replay.ReplaySchema(lane=None, fleet=fleet, base_seed=base,
                             partition_fn=None, engine=eng)
    return js, ps


def test_probe_seeds_bitwise_over_five_steps():
    js, ps = _schemas("fp32")
    for step in range(5):
        a, b = jreplay.probe_seeds(js, step), replay.probe_seeds(ps, step)
        assert a.dtype == b.dtype == np.uint64
        np.testing.assert_array_equal(a, b)


def _records(mod, schema, step, numerics, rng):
    """One record per worker with the step's true seeds; worker 1 sends
    an outlier scalar, worker 2 a diverged seed."""
    seeds = jreplay.probe_seeds(schema, step) if mod is jledger \
        else replay.probe_seeds(schema, step)
    recs = {}
    for w in range(W):
        s = seeds[w * M:(w + 1) * M].copy()
        if w == 2 and step % 2:
            s[0] ^= np.uint64(1)
        if numerics == "int8":
            d = rng.integers(-1, 2, M).astype(np.int8)
            tail = [rng.integers(-127, 128, n).astype(np.int8)
                    for n in (7, 0, 3)]
            recs[w] = mod.Record(step, w, s, d, float(rng.normal()), tail,
                                 numerics="int8")
        else:
            d = rng.normal(size=M).astype(np.float32)
            if w == 1:
                d *= np.float32(1e4)
            tail = [rng.integers(-127, 128, n).astype(np.int8)
                    for n in (7, 0, 3)]
            sc = rng.uniform(size=3).astype(np.float32)
            recs[w] = mod.Record(step, w, s, d, float(rng.normal()), tail,
                                 sc)
    return recs


@pytest.mark.parametrize("numerics", ["fp32", "int8"])
def test_ledger_written_by_jax_reencodes_bitwise(numerics):
    js, _ = _schemas(numerics)
    rng = np.random.default_rng(3)
    led = jledger.Ledger()
    for step in range(3):
        for rec in _records(jledger, js, step, numerics, rng).values():
            led.append_record(rec)
        filt = jledger.pack_bits(np.arange(W * M) % 3 > 0) if step else None
        led.append_commit(jledger.Commit(step, 0b101101, quarantined=step & 2,
                                         filtered=filt))
    wire = led.to_bytes()
    port = ledger.Ledger.from_bytes(wire)
    assert port.to_bytes() == wire
    assert port.slice_bytes(1, 3) == led.slice_bytes(1, 3)
    assert (port.bytes_zo, port.bytes_tail) == (led.bytes_zo, led.bytes_tail)
    assert jledger.Ledger.from_bytes(port.to_bytes()).to_bytes() == wire


@pytest.mark.parametrize("numerics", ["fp32", "int8"])
def test_commit_rule_and_filter_decide_as_jax(numerics):
    js, ps = _schemas(numerics)
    jgate, gate = jrobust.RobustGate(js), robust.RobustGate(ps)
    jt, pt = JTransport(js.fleet), ChaosTransport(ps.fleet)
    rng_j, rng_p = np.random.default_rng(9), np.random.default_rng(9)
    for step in range(4):
        jrecs = _records(jledger, js, step, numerics, rng_j)
        precs = _records(ledger, ps, step, numerics, rng_p)
        jf = [jt.fate(step, w) for w in range(W)]
        pf = [pt.fate(step, w) for w in range(W)]
        assert [(f.delivered, f.delay) for f in jf] == \
            [(f.delivered, f.delay) for f in pf]
        ja = jcommit_rule.close_step(jgate, step,
                                     [(jrecs[w], jf[w]) for w in range(W)])
        pa = commit_rule.close_step(gate, step,
                                    [(precs[w], pf[w]) for w in range(W)])
        jc = jcommit_rule.close_candidates(jgate, step, jrecs)
        pc = commit_rule.close_candidates(gate, step, precs)
        for a, b in ((ja, pa), (jc, pc)):
            assert a.commit.to_bytes() == b.commit.to_bytes()
            assert (a.ontime_bits, a.late_admit_bits, a.rejected,
                    a.outliers, a.events) == \
                (b.ontime_bits, b.late_admit_bits, b.rejected, b.outliers,
                 b.events)
            assert sorted(a.records) == sorted(b.records)
        jgate.advance(step, ja)
        gate.advance(step, pa)
        ja_arr = jcommit_rule.committed_arrays(ja.commit, ja.records, js)
        pa_arr = commit_rule.committed_arrays(pa.commit, pa.records, ps)
        for x, y in ((ja_arr.seeds, pa_arr.seeds),
                     (ja_arr.deltas, pa_arr.deltas),
                     (ja_arr.mask, pa_arr.mask)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert tuple(ja_arr.tail_ws) == tuple(pa_arr.tail_ws)
        # the filter itself, on the raw arrays of an all-accepted commit
        full = jledger.Commit(step, (1 << W) - 1)
        _, jd, jm = jcommit_rule.raw_arrays(full, jrecs, js)
        losses = jrobust.record_losses(jrecs, full.accepted, W)
        for mode in ("mask", "clip"):
            a = jrobust.filter_decision(jd, losses, jm, M,
                                        JRobustConfig(mode=mode), numerics)
            b = robust.filter_decision(jd, losses, jm, M,
                                       RobustConfig(mode=mode), numerics)
            np.testing.assert_array_equal(a.inband, b.inband)
            assert (a.outliers, a.loss_reject, a.lo, a.hi) == \
                (b.outliers, b.loss_reject, b.lo, b.hi)
    assert jgate.quarantine_events() == gate.quarantine_events()


def test_peer_fates_as_jax():
    js, ps = _schemas("fp32")
    jt, pt = JTransport(js.fleet), ChaosTransport(ps.fleet)
    for args in [(s, a, b, r) for s in range(3) for a in range(3)
                 for b in range(3) for r in range(2)]:
        x, y = jt.peer_fate(*args), pt.peer_fate(*args)
        assert (x.delivered, x.delay) == (y.delivered, y.delay)


def _grad_cases():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(33, 17)).astype(np.float32),
         "b": (rng.normal(size=(5,)) * 1e-3).astype(np.float32),
         "empty": np.zeros((0, 4), np.float32),
         # ties: x / scale lands on .5 exactly, rounded half to even
         "ties": np.array([127.0, 0.5, 1.5, 2.5, -2.5, 63.5], np.float32),
         "zeros": np.zeros((6,), np.float32)}
    r = {k: (rng.normal(size=v.shape) * 0.01).astype(np.float32)
         for k, v in g.items()}
    r["ties"] = np.zeros_like(g["ties"])
    return g, r


def test_compress_tree_bitwise_as_jax():
    """q and scale bitwise JAX's (the fleet's jitted quantiser and the
    eager function alike). The residual x - q * scale is bitwise the
    eager function's; XLA contracts the jitted one into an FMA on the
    CPU, one rounding fewer, so it differs from both by at most half an
    ulp of q * scale."""
    g, r = _grad_cases()
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jr = {k: jnp.asarray(v) for k, v in r.items()}
    jit_out = jax.jit(jcompress.compress_tree)(jg, jr)
    eager_out = jcompress.compress_tree(jg, jr)
    q, s, nr = compress.compress_tree(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()})
    for k in g:
        assert q[k].dtype == torch.int8 and s[k].dtype == torch.float32
        for jq, js, _ in (jit_out, eager_out):
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(nr[k].numpy(),
                                      np.asarray(eager_out[2][k]), err_msg=k)
        # the FMA skips the rounding of q * scale: half an ulp of it
        qs = np.abs(q[k].numpy().astype(np.float32) * s[k].numpy())
        assert np.all(np.abs(nr[k].numpy() - np.asarray(jit_out[2][k]))
                      <= np.spacing(qs) / 2), k
    assert q["ties"].tolist() == [127, 0, 2, 2, -2, 64]
    back = compress.decompress_tree(q, s)
    jback = jcompress.decompress_tree(jit_out[0], jit_out[1])
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
