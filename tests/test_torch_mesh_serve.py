"""Port parity of serving across a mesh: ``prefill_step`` and
``decode_step`` with a ``MeshRun`` over the sharded caches, on CPU
ranks.

Four spawned gloo ranks (``torch_serve_ranks.py``, one intra-op thread
each; rendezvous at a ``file://`` store under the test's temporary
directory) run every case of ``CASES`` from one init (the port's, drawn
here and handed to JAX as numpy): a prefill of 16 tokens on the case's
mesh, the caches re-laid for the decode shape's rules, and 2 decode
steps of given tokens. The cases cover the ``tp`` plan with kv_dup 2
(reduced KV 2 at 1x4), the ``serve`` strategy's ``seq`` plan at decode
(the cache context-sharded over `model`), context-parallel decode over
`data` (a global batch of 1 below the 2 `data` ranks), the ``seq`` plan
at prefill and decode, Mixtral's window ring under ``serve``, under
context-parallel decode and under the ``seq`` plan (ring slots whose
positions another rank's rows hold), Mixtral under ``fsdp`` with its rows
over (data, model) (the MoE's dispatch all-to-all), RWKV6, one Jamba
period (Mamba, attention and MoE blocks), Whisper (ck / cv split over
`model` at decode: flash's log-sum-exp combined across ranks) and
LLaVA's image-token prefix.

Meanwhile two subprocesses with 4 forced host devices run JAX's
``prefill_step`` and ``decode_step`` of every case, jitted with the
rules' ``in_shardings`` as ``repro/launch/dryrun.py::lower_cell`` jits
them (the decode's caches donated), the caches re-laid alike. Tokens
must be equal; where they are not, the test says so and holds the
logits there instead: the port's one-device top-two logits must lie
within TOKEN_TOL (a near tie the rounding of another summation order can
flip). The caches, gathered from the shards (``unshard_leaf``), after
the prefill and after the last decode step, lie within CACHE_TOL times
each leaf's largest magnitude (at least 1) of JAX's, as
``test_torch_families.py`` holds block states: f32 sums in other orders
(the row-parallel products, the context-parallel softmax's combine, the
RWKV6 chunk walk against JAX's associative scan) than XLA's.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_serve_ranks as ranks  # noqa: E402
from repro_torch.core import api, zo  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.serve.kv_pages import grow_dense_caches  # noqa: E402

CACHE_TOL = 1e-4          # of a leaf's largest magnitude (at least 1)
TOKEN_TOL = 1e-4           # a near tie: the top-two logits this close
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
JAX_PROCS = 2

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS, LaneConfig, ShapeConfig, reduced
    from repro.core import api
    from repro.launch.mesh import make_mesh
    from repro.sharding.params import cache_shardings, param_shardings
    from repro.sharding.rules import ShardingRules

    out = sys.argv[1]
    cases = json.loads(sys.argv[2])
    steps = int(sys.argv[3])
    assert jax.device_count() == 4
    lane = LaneConfig(lane="elastic_zo", bp_tail_layers=1, zo_num_probes=1)

    def dup(rules):
        return rules.attn.kv_dup if rules.attn.kind == "tp" else 1

    def flat(caches):
        return {f"{part}/{j}/{k}": np.asarray(t)
                for part, es in caches.items()
                for j, e in enumerate(es) for k, t in e.items()}

    for name, (arch, shape, strategy, B, S, over, init) in cases.items():
        cfg = reduced(ARCHS[arch], dtype="float32", **over)
        mesh = make_mesh(tuple(shape), ("data", "model"))
        total = S + cfg.num_image_tokens
        sp = ShapeConfig("p", seq_len=total, global_batch=B, kind="prefill")
        sd = ShapeConfig("d", seq_len=total + steps, global_batch=B,
                         kind="decode")
        rp = ShardingRules(mesh, cfg, sp, strategy=strategy)
        rd = ShardingRules(mesh, cfg, sd, strategy=strategy)
        mp = api.build(cfg, sp, lane, rp)
        md = api.build(cfg, sd, lane, rd)
        abstract = md.abstract_params()
        z = np.load(os.path.join(out, init + ".npz"))
        paths, tdef = jax.tree_util.tree_flatten_with_path(abstract)
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(z[jax.tree_util.keystr(p)]) for p, _ in paths])
        data = np.load(os.path.join(out, f"inputs_{name}.npz"))
        pshard = param_shardings(abstract, rp)
        bshard = api.batch_shardings(mp.input_specs(), rp)
        batch = {k: jax.device_put(jnp.asarray(data[k]), bshard[k])
                 for k in bshard}
        tok, caches = jax.jit(mp.prefill_step, in_shardings=(
            pshard, bshard))(jax.tree.map(jax.device_put, params, pshard),
                             batch)
        res = {"prefill": np.asarray(tok)[:, 0]}
        prefill = flat(caches)
        slots = min(sd.seq_len, cfg.sliding_window) if cfg.sliding_window \\
            else sd.seq_len
        idx = [(j // dup(rd)) * dup(rp)
               for j in range(cfg.num_kv_heads * dup(rd))]

        def relay(path, t):
            name_ = jax.tree_util.keystr(path[-1:])
            t = np.asarray(t)
            if any(n in name_ for n in ("'k'", "'v'", "'ck'", "'cv'")):
                t = t[..., idx, :]
            if name_ in ("['k']", "['v']") and t.shape[2] < slots:
                t = np.pad(t, [(0, 0), (0, 0), (0, slots - t.shape[2]),
                               (0, 0), (0, 0)])
            return jnp.asarray(t)
        caches = jax.tree_util.tree_map_with_path(relay, caches)
        scalar = jax.sharding.NamedSharding(mesh,
                                            jax.sharding.PartitionSpec())
        # a zero-length leaf (a one-period stack's empty BP tail) is put
        # replicated, whatever its spec
        cshard = jax.tree.map(lambda s, a: s if a.size else scalar,
                              cache_shardings(md.abstract_caches(), rd),
                              md.abstract_caches())
        caches = jax.tree.map(jax.device_put, caches, cshard)
        dshard = api.batch_shardings(md.input_specs(), rd)
        step = jax.jit(md.decode_step, in_shardings=(
            param_shardings(abstract, rd), dshard["tokens"], cshard, scalar),
            donate_argnums=(2,))
        pd = jax.tree.map(jax.device_put, params,
                          param_shardings(abstract, rd))
        for i in range(steps):
            tok, caches = step(pd, jnp.asarray(data["decode"][:, i:i + 1]),
                               caches, jnp.int32(total + i))
            res[f"decode{i}"] = np.asarray(tok)[:, 0]
        np.savez(os.path.join(out, f"jax_{name}.npz"),
                 **{f"tokens:{k}": v for k, v in res.items()},
                 **{f"prefill:{k}": v for k, v in prefill.items()},
                 **{f"decode:{k}": v for k, v in flat(caches).items()})
    print("JAX_OK")
""")


def _init(out, arch, overrides):
    """The port's init of a case's stack, saved for both sides."""
    cfg = ranks.cfg_of(arch, overrides)
    params = api.init(cfg, ranks.lane_of(), seed=0, device="cpu",
                      max_seq=ranks.shapes_of(cfg, 1, 16)[1].seq_len)
    np.savez(os.path.join(out, ranks.init_name(arch, overrides) + ".npz"),
             **{zo.keystr(p): t.numpy() for p, t in
                zo.leaves_with_path(params)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case once, the JAX subprocesses (the cases dealt out among
    ``JAX_PROCS`` of them) beside the four port ranks. Returns the
    output directory."""
    out = str(tmp_path_factory.mktemp("mesh_serve"))
    cases = {}
    for name, (arch, shape, strategy, B, S, over) in ranks.CASES.items():
        init = ranks.init_name(arch, over)
        if not os.path.exists(os.path.join(out, init + ".npz")):
            _init(out, arch, over)
        cfg = ranks.cfg_of(arch, over)
        np.savez(os.path.join(out, f"inputs_{name}.npz"),
                 **ranks.inputs_of(cfg, B, S))
        cases[name] = [arch, list(shape), strategy, B, S, over, init]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    items = list(cases.items())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, out,
         json.dumps(dict(items[i::JAX_PROCS])), str(ranks.DECODE_STEPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(JAX_PROCS)]
    try:
        mesh_lib.spawn(ranks.serve_rank, 4,
                       ("file://" + os.path.join(out, "store"), out))
    finally:
        done = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, done):
        assert p.returncode == 0 and "JAX_OK" in stdout, stderr[-3000:]
    return out


def _close(got, want, what):
    assert got.shape == want.shape, what
    if want.size:
        err = float(np.abs(got - want).max())
        assert err <= CACHE_TOL * max(1.0, float(np.abs(want).max())), \
            (what, err)


def _tokens(out, name):
    """{step: global tokens} assembled from every rank's rows, and rank
    0's meta."""
    metas = [json.load(open(os.path.join(out, f"{name}_rank{r}.json")))
             for r in range(4)]
    B = ranks.CASES[name][3]
    got = {}
    for step in metas[0]["tokens"]:
        toks = np.full(B, -1)
        for m in metas:
            lo, hi, t = m["tokens"][step]
            if (toks[lo:hi] >= 0).any():
                assert list(toks[lo:hi]) == t, (name, step, "replicas differ")
            toks[lo:hi] = t
        got[step] = toks
    return got, metas[0]


def _one_device_logits(name):
    """The port's one-device logits [B, Vp] of each step of a case, from
    the same init and inputs."""
    arch, _, _, B, S, over = ranks.CASES[name]
    cfg = ranks.cfg_of(arch, over)
    sp, sd = ranks.shapes_of(cfg, B, S)
    params = api.init(cfg, ranks.lane_of(), seed=0, device="cpu",
                      max_seq=sd.seq_len)
    data = {k: torch.from_numpy(v) for k, v in
            ranks.inputs_of(cfg, B, S).items()}
    extra = {k: data[k] for k in ("frames", "img") if k in data}
    _, caches, logits = api.prefill_step(params, cfg, data["tokens"],
                                         logits=True, **extra)
    out = {"prefill": logits[:, 0]}
    caches = grow_dense_caches(caches, cfg, sd.seq_len)
    for i in range(ranks.DECODE_STEPS):
        _, caches, logits = api.decode_step(params, cfg,
                                            data["decode"][:, i:i + 1],
                                            caches, sp.seq_len + i,
                                            logits=True)
        out[f"decode{i}"] = logits[:, 0]
    return out


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_tokens_match_jax(runs, case):
    """The greedy token of the prefill and of each decode step equals
    JAX's on every row; a row where it does not must be a near tie of
    the one-device logits (printed)."""
    got, _ = _tokens(runs, case)
    want = np.load(os.path.join(runs, f"jax_{case}.npz"))
    logits = None
    for step, toks in got.items():
        ref = want[f"tokens:{step}"]
        for row in np.nonzero(toks != ref)[0]:
            logits = logits or _one_device_logits(case)
            lg = logits[step][row]
            gap = float(abs(lg[int(toks[row])] - lg[int(ref[row])]))
            print(f"{case} {step} row {row}: token {toks[row]} against "
                  f"JAX's {ref[row]}, one device's logits {gap:.3g} apart")
            assert gap <= TOKEN_TOL, (case, step, row, gap)


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_caches_match_jax(runs, case):
    """Every cache leaf, gathered from the shards, after the prefill and
    after the last decode step, within CACHE_TOL of JAX's (the prefill's
    in the prefill rules' layout: KV * kv_dup heads under the tp plan)."""
    got = dict(np.load(os.path.join(runs, f"{case}.npz")))
    want = dict(np.load(os.path.join(runs, f"jax_{case}.npz")))
    want = {k: v for k, v in want.items() if not k.startswith("tokens:")}
    # a stack of one period has an empty BP tail: JAX's zero-length
    # leaves, no entries in the port
    missing = {k for k in want if k not in got and want[k].size}
    assert not missing, missing
    assert set(got) <= set(want)
    for k, v in got.items():
        _close(v, want[k], f"{case} {k}")


def test_cases_take_the_plans_they_name(runs):
    """The layouts each case is there for: kv_dup 2 at 1x4, the seq plan
    at decode under serve, the cache's slots over `data` at a batch of
    1, the rows over (data, model) under fsdp at 4 rows."""
    meta = {name: _tokens(runs, name)[1] for name in ranks.CASES}
    assert meta["qwen3_tp_dup2"]["dup"] == [2, 2]
    assert meta["qwen3_serve"]["plans"] == ["tp", "seq"]
    assert meta["qwen3_cp_data"]["cache_seq_axes"] == ["data"]
    assert meta["qwen3_seq"]["plans"] == ["seq", "seq"]
    assert meta["mixtral_serve_ring"]["plans"] == ["tp", "seq"]
    assert meta["mixtral_cp_ring"]["cache_seq_axes"] == ["data"]
    assert meta["mixtral_seq_ring"]["plans"] == ["seq", "seq"]
    assert meta["mixtral_fsdp"]["batch_axes"] == ["data", "model"]
    assert meta["mixtral_fsdp"]["moe"] == "ep"
    assert meta["whisper_serve"]["plans"] == ["tp", "seq"]


def test_one_device_caches_match_the_mesh(runs):
    """The port's one-device caches after the same steps equal the
    gathered mesh caches of the seq-plan serve case (every head whole,
    so the layouts agree), within CACHE_TOL."""
    name = "qwen3_serve"
    arch, _, _, B, S, over = ranks.CASES[name]
    cfg = ranks.cfg_of(arch, over)
    sp, sd = ranks.shapes_of(cfg, B, S)
    params = api.init(cfg, ranks.lane_of(), seed=0, device="cpu",
                      max_seq=sd.seq_len)
    data = {k: torch.from_numpy(v) for k, v in
            ranks.inputs_of(cfg, B, S).items()}
    _, caches = api.prefill_step(params, cfg, data["tokens"])
    caches = grow_dense_caches(caches, cfg, sd.seq_len)
    for i in range(ranks.DECODE_STEPS):
        _, caches = api.decode_step(params, cfg, data["decode"][:, i:i + 1],
                                    caches, sp.seq_len + i)
    got = dict(np.load(os.path.join(runs, f"{name}.npz")))
    for k, v in ranks.flat(caches).items():
        _close(got[f"decode:{k}"], v, k)
