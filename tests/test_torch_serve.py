"""Port parity of the serve path: sampler, model logits, Engine streams.

Parameters come from the JAX package's init, converted through numpy
(``repro_torch.convert``); the model runs in float32 so the comparison
checks the algorithm, not bf16 rounding. Contracts: sampled tokens and
token streams exactly equal, logits within 1e-4.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ServeConfig as JServe  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.models.transformer import make_paged_caches as jmake_paged  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro.serve import kv_pages as jkv  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.models.transformer import make_paged_caches  # noqa: E402
from repro_torch.serve import Engine, SamplingParams, ServeConfig  # noqa: E402
from repro_torch.serve import kv_pages, sampler  # noqa: E402

ARCH = "qwen3-4b"


def _cfgs():
    return (jreduced(JARCHS[ARCH], dtype="float32"),
            tconfigs.reduced(tconfigs.ARCHS[ARCH], dtype="float32"))


def _jax_params(jcfg, seq_len):
    shape = ShapeConfig("p", seq_len=seq_len, global_batch=1, kind="prefill")
    m = japi.build(jcfg, shape, JLane(), ShardingRules(None, jcfg, shape))
    return m.init(jax.random.key(0))


# ------------------------------------------------------------------ #
# sampler
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("reference", [False, True])
def test_sample_tokens_match_jax(reference):
    rng = np.random.default_rng(5)
    B, V = 6, 320
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    temp = np.array([0.0, 0.8, 1.0, 1.3, 0.5, 2.0], np.float32)
    top_k = np.array([0, 50, 0, 7, 1, 0], np.int32)
    top_p = np.array([1.0, 0.95, 0.9, 1.0, 1.0, 0.5], np.float32)
    seed = np.array([0, 123, 2**32 - 1, 7, 99, 2**31], np.uint32)
    jfn = jsampler.sample_tokens_reference if reference \
        else jsampler.sample_tokens
    tfn = sampler.sample_tokens_reference if reference \
        else sampler.sample_tokens
    for step0 in (0, 3, 1000):
        step = np.arange(B, dtype=np.int32) + step0
        want = np.asarray(jfn(*(jnp.asarray(a) for a in
                                (logits, temp, top_k, top_p, seed, step)),
                              vocab_size=300))
        got = tfn(torch.from_numpy(logits), torch.from_numpy(temp),
                  torch.from_numpy(top_k), torch.from_numpy(top_p),
                  torch.from_numpy(seed.astype(np.int64)),
                  torch.from_numpy(step), vocab_size=300).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[1:] < 300).all()


# ------------------------------------------------------------------ #
# model: prefill logits, admission, one paged decode step
# ------------------------------------------------------------------ #
def test_prefill_and_paged_decode_logits_match_jax():
    jcfg, tcfg = _cfgs()
    jserve = JServe(page_size=4, num_pages=16, max_batch_slots=2,
                    max_seq_len=16)
    P = jserve.max_pages_per_seq
    jparams = _jax_params(jcfg, 16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                              torch.float32)
    rng = np.random.default_rng(3)
    S = 6
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    last = np.array([S - 1, S - 3], np.int32)   # row 1 right-padded

    shape = ShapeConfig("p", seq_len=S, global_batch=2, kind="prefill")
    jm = japi.build(jcfg, shape, JLane(), ShardingRules(None, jcfg, shape))
    jl, jdense = jax.jit(jm.prefill_logits)(
        jparams, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    tl, tdense = api.prefill_logits(tparams, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(last))
    assert tl.shape == (2, tcfg.padded_vocab)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-4

    pages = [[3, 5], [1]]                       # row 1 keeps 4 tokens
    pt = np.zeros((2, P), np.int32)
    pt[0, :2], pt[1, :1] = pages[0], pages[1]
    pos = np.array([S, S - 2], np.int32)
    pt[0, 2] = 7                                 # row 0's write opens page 2
    dshape = ShapeConfig("d", seq_len=16, global_batch=2, kind="decode")
    drules = ShardingRules(None, jcfg, dshape)
    jmd = japi.build(jcfg, dshape, JLane(), drules)
    jc = japi.split_caches(jmake_paged(jcfg, 2, 16, 4, drules), jcfg,
                           JLane())
    jc = jkv.admit_prefill(jc, jdense, jcfg, [0, 1], pages, 4, P)
    nxt = np.array([[11], [22]], np.int32)
    jd, _ = jax.jit(jmd.decode_step_paged)(
        jparams, jnp.asarray(nxt), jc, jnp.asarray(pt), jnp.asarray(pos))

    tc = api.split_caches(make_paged_caches(tcfg, 2, 16, 4, device="cpu"),
                          tcfg, tconfigs.LaneConfig())
    kv_pages.admit_prefill(tc, tdense, tcfg, [0, 1], pages, 4, P)
    td = api.decode_step_paged(tparams, tcfg, torch.from_numpy(nxt), tc,
                               torch.from_numpy(pt), torch.from_numpy(pos))
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= 1e-4


# ------------------------------------------------------------------ #
# engine: the same token streams
# ------------------------------------------------------------------ #
def test_engine_streams_match_jax():
    jcfg, tcfg = _cfgs()
    kw = dict(page_size=4, num_pages=32, max_batch_slots=3, max_seq_len=32,
              max_new_tokens=9, megastep=4)
    jeng = JEngine(jcfg, JServe(**kw))
    tparams = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu",
                              torch.float32)
    teng = Engine(tcfg, ServeConfig(**kw), params=tparams, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, jcfg.vocab_size, n)) for n in (4, 8, 5)]
    knobs = [dict(), dict(temperature=0.8, top_k=7, seed=11),
             dict(temperature=1.1, top_p=0.9, seed=23)]
    jr = [jeng.submit(p, JSP(**k), 9) for p, k in zip(prompts, knobs)]
    tr = [teng.submit(p, SamplingParams(**k), 9) for p, k in zip(prompts, knobs)]
    jout, tout = jeng.run(), teng.run()
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    assert teng.ticks_run > teng.steps_run, "megastep fusion never engaged"
    assert teng.sched.pool.used_pages == 0


# ------------------------------------------------------------------ #
# hygiene
# ------------------------------------------------------------------ #
_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in
        pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), bad)
"""


def test_port_imports_neither_jax_nor_repro():
    src = str(Path(__file__).resolve().parents[1] / "src")
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                       capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", r.stdout


def test_engine_needs_cuda_unless_asked_for_cpu(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(tcfg)
    assert Engine(tcfg, device="cpu").device.type == "cpu"
