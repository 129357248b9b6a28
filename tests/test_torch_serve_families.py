"""The paged engine and the dense baseline on the MoE, RWKV6 and
Mamba/hybrid families.

Against the JAX package (one process, ``reduced(..., dtype="float32")``):
the port's ``Engine`` gives the JAX ``Engine``'s token streams, greedy
and sampled, with more requests than decode slots (a slot's recurrent
state is overwritten at re-admission) and prompt bucketing on (which
both packages apply to attention-only stacks only: RWKV6 and Mamba
state would absorb the pad tokens). Within the port: the paged engine's
greedy streams equal ``dense_generate``'s, as the JAX package's
``tests/test_serve_paged.py`` holds its own two paths; and
``grow_dense_caches`` grows attention KV only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ServeConfig as JServe  # noqa: E402
from repro.configs import ShapeConfig, reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSP  # noqa: E402
from repro.sharding.rules import ShardingRules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ATTN  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.transformer import make_caches  # noqa: E402
from repro_torch.serve import (Engine, SamplingParams, ServeConfig,  # noqa: E402
                               dense_generate, grow_dense_caches)


def _port_params_for_jax(tcfg, jcfg):
    """The port's init (seed 0, CPU) as the numpy tree the reference
    takes, its structure held against the reference's init."""
    shape = ShapeConfig("p", seq_len=8, global_batch=1, kind="prefill")
    jm = japi.build(jcfg, shape, JLane(), ShardingRules(None, jcfg, shape))
    tp = api.init(tcfg, seed=0, device="cpu")
    jp = jax.tree.map(lambda t: np.asarray(t.numpy()), tp)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.eval_shape(jm.init, jax.random.key(0)))
    return jp, tp


# ------------------------------------------------------------------ #
# the port's Engine against the JAX Engine
# ------------------------------------------------------------------ #
# prompt lengths: reduced Jamba compiles slowest in JAX, so its four
# prompts share one length (two prefill shapes in all); 5, 6 and 7 are
# not powers of two, so bucketing would pad them
LENGTHS = {"jamba-v0.1-52b": (5, 5, 5, 5), "rwkv6-1.6b": (5, 6, 5, 7),
           "mixtral-8x7b": (5, 6, 5, 7)}
KNOBS = [dict(), dict(temperature=0.8, top_k=7, seed=11),
         dict(temperature=1.1, top_p=0.9, seed=23), dict(temperature=0.9,
                                                         seed=3)]


@pytest.mark.parametrize("arch", sorted(LENGTHS))
def test_engine_streams_match_jax(arch, monkeypatch):
    jcfg = jreduced(JARCHS[arch], dtype="float32")
    tcfg = tconfigs.reduced(tconfigs.ARCHS[arch], dtype="float32")
    # megastep 1: each distinct horizon compiles a JAX megastep; the
    # port's multi-tick megastep is held to dense_generate below
    kw = dict(page_size=4, num_pages=32, max_batch_slots=3, max_seq_len=32,
              max_new_tokens=9, megastep=1, bucket_prompts=True)
    jp, tp = _port_params_for_jax(tcfg, jcfg)
    jeng = JEngine(jcfg, JServe(**kw), params=jax.tree.map(jax.numpy.asarray,
                                                           jp))
    teng = Engine(tcfg, ServeConfig(**kw), params=tp, device="cpu")
    widths = []
    prefill = api.prefill_logits
    monkeypatch.setattr(api, "prefill_logits", lambda p, c, toks, last: (
        widths.append(toks.shape[1]) or prefill(p, c, toks, last)))
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, jcfg.vocab_size, n))
               for n in LENGTHS[arch]]
    jr = [jeng.submit(p, JSP(**k), 9) for p, k in zip(prompts, KNOBS)]
    tr = [teng.submit(p, SamplingParams(**k), 9)
          for p, k in zip(prompts, KNOBS)]
    jout, tout = jeng.run(), teng.run()
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    assert len(widths) >= 2, "the fourth request was never re-admitted"
    if all(k == ATTN for k in tcfg.pattern):
        assert set(widths) == {8}                      # bucketed
    else:
        assert set(widths) <= set(LENGTHS[arch])       # exact lengths
    assert teng.sched.pool.used_pages == 0


# ------------------------------------------------------------------ #
# the paged engine against the port's dense baseline
# ------------------------------------------------------------------ #
# mixtral covers the sliding window: full-length prefill KV in the pool
# and the paged window mask against the dense path's ring, capped at the
# window (16 in the reduced config; prompts of 10 and 6 new tokens never
# wrap it, as in the JAX package's test)
@pytest.mark.parametrize("arch",
                         ["qwen3-4b", "jamba-v0.1-52b", "mixtral-8x7b"])
def test_paged_matches_dense(arch):
    cfg = tconfigs.reduced(tconfigs.ARCHS[arch])
    serve = ServeConfig(page_size=8, num_pages=64, max_batch_slots=3,
                        max_seq_len=64, max_new_tokens=6)
    eng = Engine(cfg, serve, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 10))
    paged = eng.generate([list(p) for p in prompts], SamplingParams(), 6)
    dense = dense_generate(cfg, eng.params, prompts, 6)
    assert [list(d) for d in dense] == paged
    eng.sched.check_invariants()
    assert eng.sched.pool.used_pages == 0


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b"])
def test_grow_dense_caches_grows_attention_kv_only(arch):
    cfg = tconfigs.reduced(tconfigs.ARCHS[arch], dtype="float32")
    params = api.init(cfg, seed=1, device="cpu")
    Lp, total = 12, 30
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, Lp)))
    _, caches = api.prefill_step(params, cfg, toks)
    grown = grow_dense_caches(caches, cfg, total)
    # the shapes of make_caches(cfg, B, total), the window capping T (the
    # ZO head's periods; a one-period stack's empty tail holds no entry)
    want = api.split_caches(make_caches(cfg, 2, total, device="cpu"), cfg,
                            tconfigs.LaneConfig())
    assert api.tree_map(lambda a: a.shape, grown["zo"]) == \
        api.tree_map(lambda a: a.shape, want["zo"])
    T = min(total, cfg.sliding_window) if cfg.sliding_window else total
    n_state = 0
    for part in ("zo", "bp"):
        for kind, old, new in zip(cfg.pattern, caches[part], grown[part]):
            assert sorted(old) == sorted(new)
            for name, a in old.items():
                if kind == ATTN:
                    assert new[name].shape[2] == T
                    assert torch.equal(new[name][:, :, :Lp], a)
                    assert not new[name][:, :, Lp:].any()
                else:                          # conv / ssm state untouched
                    assert new[name] is a
                    n_state += 1
    assert n_state == (14 if cfg.pattern[0] != ATTN else 0)


@pytest.mark.parametrize("paged", [True, False])
def test_serve_launcher_runs_rwkv6(paged, capsys):
    launch_serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--tokens", "3",
                       "--page-size", "4"] + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert ("[serve] paged: 6 tokens across 2 requests" if paged
            else "[serve] dense: 3 tok/seq x2") in out
