"""The port's flight recorder: primitives, exporters, memory ledger, and
the numerics-inert bar.

Recorder and export cases mirror tests/test_obs.py on the port's copy
(span nesting, histogram percentiles, counter and gauge snapshots,
Chrome-trace validity; the wall-clock overhead bound is left out). The
scheduler's restored counters are held against the JAX package's
scheduler on the same trace. Then the reference's bar
(tests/test_obs_inert.py): with a recorder installed, a reduced
qwen3-4b serve run gives the same tokens and a LeNet-5 lane the same
parameters, bitwise, as without one.
"""
import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.configs import ServeConfig as JServe  # noqa: E402
from repro.serve.sampler import SamplingParams as JSP  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.benchmarks.paper_tables import lenet_lane_configs  # noqa: E402
from repro_torch.configs import ARCHS, ServeConfig, reduced  # noqa: E402
from repro_torch.core import elastic, zo  # noqa: E402
from repro_torch.core.int8 import qtensor  # noqa: E402
from repro_torch.data.synthetic import glyphs  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.obs import NullRecorder, Recorder  # noqa: E402
from repro_torch.obs.export import (chrome_trace, load_chrome_trace,  # noqa: E402
                                    validate_chrome_trace, write_chrome_trace)
from repro_torch.obs.memory import MemoryLedger, tree_nbytes  # noqa: E402
from repro_torch.serve import Engine, SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402
from repro_torch.train.train_loop import LoopConfig, init_state, run  # noqa: E402


@pytest.fixture(autouse=True)
def _pristine_obs():
    """Every test starts and ends on the no-op singletons, verbose."""
    for o in (obs, jobs):
        o.uninstall()
        o.set_verbosity("verbose")
    yield
    for o in (obs, jobs):
        o.uninstall()
        o.set_verbosity("verbose")


# ------------------------------------------------------------------ #
# recorder primitives and export
# ------------------------------------------------------------------ #
def test_span_nesting_depth_and_order():
    rec = Recorder()
    with rec.span("outer", track="train", step=3):
        with rec.span("mid", track="train"):
            with rec.span("inner", track="train"):
                pass
        with rec.span("mid2", track="train"):
            pass
    assert [s["name"] for s in rec.spans] == ["inner", "mid", "mid2", "outer"]
    depth = {s["name"]: s["depth"] for s in rec.spans}
    assert depth == {"outer": 0, "mid": 1, "mid2": 1, "inner": 2}
    outer = rec.spans[-1]
    assert outer["args"] == {"step": 3}
    for s in rec.spans[:-1]:
        assert s["ts"] >= outer["ts"]
        assert s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]
    with pytest.raises(RuntimeError):
        with rec.span("boom"):
            raise RuntimeError("x")
    with rec.span("after"):
        pass
    assert rec.spans[-1]["depth"] == 0
    tot = rec.span_totals()
    assert tot["boom"]["count"] == 1 and tot["outer"]["count"] == 1


def test_histogram_percentiles():
    h = Recorder().histogram("lat")
    for v in [1.0, 2.0, 4.0, 8.0, 1000.0]:
        h.observe(v)
    s = h.summary()
    assert s["count"] == 5 and s["sum"] == pytest.approx(1015.0)
    assert s["min"] == 1.0 and s["max"] == 1000.0
    assert s["p50"] in (2.0, 4.0) and s["p99"] == 1024.0
    assert s["buckets"]["10"] == 1 and sum(s["buckets"].values()) == 5
    assert Recorder().histogram("e").summary()["p99"] == 0.0


def test_counter_and_gauge_snapshot():
    rec = Recorder()
    c = rec.counter("n")
    assert rec.counter("n") is c
    c.inc()
    c.inc(41)
    rec.gauge("g").set(2)
    rec.gauge("g").set(7.5)
    snap = rec.snapshot()
    assert snap["counters"] == {"n": 42} and snap["gauges"] == {"g": 7.5}
    assert set(snap) == {"counters", "gauges", "histograms", "spans",
                         "memory"}
    rec.reset()
    assert rec.snapshot()["counters"] == {}


def test_null_recorder_returns_cached_singletons():
    nrec = NullRecorder()
    assert not nrec.enabled
    assert nrec.counter("a") is nrec.gauge("g") is nrec.histogram("h")
    assert nrec.span("x") is nrec.span("y", track="serve", step=1)
    nrec.counter("a").inc(5)
    assert nrec.snapshot() == {} and not nrec.spans
    assert isinstance(obs.get(), NullRecorder)
    rec = obs.install()
    assert obs.get() is rec
    obs.uninstall()
    assert isinstance(obs.get(), NullRecorder)


def test_chrome_trace_round_trip(tmp_path):
    rec = Recorder()
    with rec.span("train/step", track="train", step=0):
        with rec.span("train/inner", track="train"):
            pass
    with rec.span("serve/tick", track="serve"):
        pass
    rec.event("preempt", track="serve", rid=2)
    path = tmp_path / "trace.json"
    write_chrome_trace(rec, path)
    evs = load_chrome_trace(path)
    tid = {e["args"]["name"]: e["tid"] for e in evs
           if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tid["train"] < tid["serve"]
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    p, c = xs["train/step"], xs["train/inner"]
    assert p["ts"] <= c["ts"] <= c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-3
    (inst,) = [e for e in evs if e["ph"] == "i"]
    assert inst["args"] == {"rid": 2, "level": "info"}


@pytest.mark.parametrize("doc,match", [
    ([], "envelope"),
    ({"traceEvents": {}}, "must be a list"),
    ({"traceEvents": [{"ph": "X", "name": "a", "tid": 1}]}, "missing 'pid'"),
    ({"traceEvents": [{"ph": "Q", "name": "a", "pid": 1, "tid": 1}]},
     "unknown phase"),
    ({"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                       "ts": 0.0}]}, "bad dur"),
])
def test_validate_rejects_garbage(doc, match):
    with pytest.raises(ValueError, match=match):
        validate_chrome_trace(doc)


def test_configure_write_round_trip(tmp_path, capsys):
    ap = argparse.ArgumentParser()
    obs.add_observability_args(ap)
    args = ap.parse_args(["--trace", str(tmp_path / "t.json"), "--metrics",
                          str(tmp_path / "m.json"), "--memory",
                          str(tmp_path / "mem.json"), "--quiet"])
    rec = obs.configure_from_args(args)
    assert rec.enabled and obs.get_verbosity() == "quiet"
    with rec.span("work", track="train"):
        rec.counter("n").inc(3)
    rec.memory.alloc("train.params", 128)
    obs.log("train", "suppressed")
    assert capsys.readouterr().out == ""
    obs.write_outputs(args)
    assert any(e["name"] == "work" for e in
               load_chrome_trace(tmp_path / "t.json"))
    assert json.loads((tmp_path / "m.json").read_text())["counters"] == \
        {"n": 3}
    mem = json.loads((tmp_path / "mem.json").read_text())
    assert mem["live"] == {"train.params": 128}
    # no initialised card: nothing to reconcile against
    assert mem["sample"] == {"tagged_bytes": 128, "torch_live_bytes": None,
                             "untagged_bytes": None}


# ------------------------------------------------------------------ #
# memory ledger
# ------------------------------------------------------------------ #
def test_ledger_accounting_keys_rebind_and_regions():
    led = MemoryLedger()
    led.alloc("a", 100)
    with led.region("r") as r:
        led.alloc("b", 50, key=1)
        led.free("b", key=1)
    assert r.peak_bytes == 150 and led.regions["r"]["hwm_delta_bytes"] == 50
    with pytest.raises(KeyError):
        led.free("b", key=1)
    with pytest.raises(ValueError):
        led.free("a", 101)
    led.rebind("p", 10, key="x")
    led.rebind("p", 30, key="x")
    assert led.live == {"a": 100, "b": 0, "p": 30}
    assert led.total_peak == 150 and led.leaks() == {"p:x": 30}


def test_tree_nbytes_walks_tensors_arrays_and_qtensors():
    tree = {"w": torch.zeros(3, 4), "q": {"w": qtensor(np.ones((5, 2)), -3)},
            "h": np.zeros(7, np.float64), "none": None,
            "l": [torch.zeros(2, dtype=torch.bfloat16), 1.5]}
    assert tree_nbytes(tree) == 48 + (10 + 4) + 56 + 4


def test_module_sample_sets_gauges_only_when_armed():
    assert obs.memory.sample() is None
    rec = obs.install()
    rec.memory.alloc("serve.params", 64)
    s = obs.memory.sample()
    assert s["tagged_bytes"] == 64 and s["torch_live_bytes"] is None
    assert rec.snapshot()["gauges"] == {"memory.tagged_bytes": 64.0}


# ------------------------------------------------------------------ #
# the scheduler's restored counters, against the JAX package's
# ------------------------------------------------------------------ #
def _drive(sched_cls, serve, sp_cls, seed):
    rng = np.random.default_rng(seed)
    sched = sched_cls(serve)
    pending = [(list(rng.integers(1, 100, rng.integers(4, 12))),
                int(rng.integers(4, 9))) for _ in range(8)]
    while pending or sched.has_work():
        while pending and rng.uniform() < 0.6:
            prompt, budget = pending.pop()
            sched.submit(prompt, sp_cls(), budget)
        for seq in sched.poll_admissions():
            sched.record_first_token(seq, int(rng.integers(1, 100)))
        plan = sched.prepare_step()
        if plan is not None:
            sched.commit_step(rng.integers(1, 100, serve.max_batch_slots)
                              .astype(np.int32))
    return sched


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_counters_equal_the_jax_packages(seed):
    """serve.queue_depth, page_reclaims, admissions, evictions, page_util,
    preemptions (and the preempt events), ttft_ms counts: the same on the
    same trace. A small pool forces preemptions."""
    kw = dict(page_size=4, num_pages=9, max_batch_slots=4, max_seq_len=24,
              max_new_tokens=8, eos_id=0)
    snaps = []
    for o, cls, serve, sp in (
            (obs, Scheduler, ServeConfig(**kw), SamplingParams),
            (jobs, JScheduler, JServe(**kw), JSP)):
        rec = o.install()
        _drive(cls, serve, sp, seed)
        o.uninstall()
        snap = rec.snapshot()
        snaps.append((snap["counters"], snap["gauges"],
                      snap["histograms"]["serve.ttft_ms"]["count"],
                      [(e["name"], e["fields"]) for e in rec.events]))
    assert snaps[0] == snaps[1]
    counters = snaps[0][0]
    preempted = counters.get("serve.preemptions", 0)
    # a preempted sequence is evicted and admitted again
    assert counters["serve.admissions"] == counters["serve.evictions"] \
        == 8 + preempted
    assert snaps[0][2] == 8
    assert len(snaps[0][3]) == preempted
    if seed == 0:
        assert preempted > 0


# ------------------------------------------------------------------ #
# numerics-inert
# ------------------------------------------------------------------ #
def test_serve_is_numerics_inert_and_traced():
    cfg = reduced(ARCHS["qwen3-4b"], dtype="float32")
    serve = ServeConfig(page_size=4, num_pages=16, max_batch_slots=2,
                        max_seq_len=24, max_new_tokens=5)
    rng = np.random.default_rng(0)
    prompts = [list(p) for p in rng.integers(0, cfg.vocab_size, (3, 7))]
    knobs = SamplingParams(temperature=0.9, top_k=9, seed=5)
    bare = Engine(cfg, serve, device="cpu")
    want = bare.generate(prompts, knobs, 5)
    rec = obs.install()
    eng = Engine(cfg, serve, params=bare.params, device="cpu")
    got = eng.generate(prompts, knobs, 5)
    obs.uninstall()
    assert got == want
    snap = rec.snapshot()
    assert snap["histograms"]["serve.ttft_ms"]["count"] == 3
    assert snap["counters"]["serve.admissions"] == 3
    assert snap["counters"]["serve.decode_tokens"] > 0
    assert snap["memory"]["live"]["serve.kv_pages"] == \
        tree_nbytes(eng.caches) > 0
    evs = validate_chrome_trace(chrome_trace(rec))
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"serve/run", "serve/tick", "serve/prefill", "serve/decode",
            "serve/sample"} <= names
    n_decode = sum(1 for s in rec.spans if s["name"] == "serve/decode")
    assert n_decode == eng.steps_run


def test_train_lane_is_numerics_inert():
    """LeNet-5's ZO-Feat-Cls1 lane (2 probes), 3 steps through
    train_loop.run, with and without a recorder: bitwise the same
    parameters and losses; the recorder saw every step."""
    name, lane, c = lenet_lane_configs(steps=30, probes=2)[2]
    assert name == "zo_feat_cls1"
    xs, ys = glyphs(24, seed=0)

    def batch_fn(s):
        return {"x": torch.from_numpy(xs[8 * s:8 * s + 8]),
                "y": torch.from_numpy(ys[8 * s:8 * s + 8])}

    def train():
        step = elastic.make_elastic_step(
            lenet.lenet5_loss, lane,
            partition_fn=lambda p: lenet.partition_at(p, c))
        state = init_state(lenet.init_lenet5(7, device="cpu"), 11)
        return run(step, state, batch_fn,
                   LoopConfig.for_lane(lane, total_steps=3, log_every=1),
                   log=None)

    want = train()
    rec = obs.install()
    got = train()
    obs.uninstall()
    assert got.history == want.history
    for (p, a), (_, b) in zip(zo.leaves_with_path(got.state.params),
                              zo.leaves_with_path(want.state.params)):
        assert torch.equal(a, b), zo.keystr(p)
    snap = rec.snapshot()
    assert snap["spans"]["train/step"]["count"] == 3
    assert snap["histograms"]["train.step_ms"]["count"] == 3
    assert snap["gauges"]["train.loss"] == want.history[-1][1]
    assert snap["memory"]["live"]["train.params"] == \
        tree_nbytes(want.state.params)
    assert snap["memory"]["live"]["train.batch"] == 0
