"""Port parity of the sharding rules and specs, and of a shard's noise.

Pure: no ranks. The port's ``ShardingRules`` on an ``AbstractMesh`` of
(axis sizes, names) against the JAX package's on a
``jax.sharding.AbstractMesh`` (no devices either): attention and MoE
plans, axes, ``cache_seq_axes`` and every ``spec_*``, for every arch,
mesh, strategy and shape kind; ``param_shardings`` / ``cache_shardings``
of every arch's full-size abstract trees; a rank's shard descriptors and
index maps, and the plain noise at them against the global noise sliced.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LaneConfig as JLane  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.sharding import params as jparams  # noqa: E402
from repro.sharding.rules import ShardingRules as JRules  # noqa: E402
from repro_torch.configs import ARCHS, LaneConfig, ShapeConfig, reduced  # noqa: E402
from repro_torch.core import api, prng, zo  # noqa: E402
from repro_torch.core.prng import IndexMap  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.sharding import params as sparams  # noqa: E402
from repro_torch.sharding.rules import ShardingRules  # noqa: E402
from repro_torch.train import elastic_runtime  # noqa: E402

MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
STRATEGIES = ("tp", "fsdp", "serve")
SHAPES = [("train", 128, 4), ("train", 128, 1024), ("decode", 4096, 1),
          ("decode", 4096, 256)]
SPEC_METHODS = sorted(n for n in dir(JRules) if n.startswith("spec_"))
PROPS = ("batch_axes", "model_axis", "model_compute", "fsdp_axis", "tp",
         "moe", "cache_seq_axes", "batch", "model", "wmodel", "fsdp",
         "batch_nomodel")


def _norm(spec):
    """A spec as a tuple of names / None, a one-name tuple as the name."""
    def ax(a):
        if isinstance(a, tuple):
            return None if not a else (a[0] if len(a) == 1 else a)
        return a
    return tuple(ax(a) for a in spec)


def _jspec(ns):
    return _norm(tuple(ns.spec))


def _pair(arch, shape, names, strategy, kind, seq, gb):
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    jr = JRules(JAbstractMesh(shape, names), jcfg,
                JShape("s", seq_len=seq, global_batch=gb, kind=kind),
                strategy=strategy)
    r = ShardingRules(mesh_lib.AbstractMesh(shape, names), cfg,
                      ShapeConfig("s", seq_len=seq, global_batch=gb,
                                  kind=kind), strategy=strategy)
    return jr, r


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_match_jax(arch, mesh):
    shape, names = mesh
    for strategy in STRATEGIES:
        for kind, seq, gb in SHAPES:
            jr, r = _pair(arch, shape, names, strategy, kind, seq, gb)
            where = f"{arch} {shape} {strategy} {kind} gb={gb}"
            assert (r.attn.kind, r.attn.kv_dup, r.attn.q_pad,
                    r.attn.padded_heads) == (
                jr.attn.kind, jr.attn.kv_dup, jr.attn.q_pad,
                jr.attn.padded_heads), where
            for p in PROPS:
                assert getattr(r, p) == getattr(jr, p), (where, p)
            for m in SPEC_METHODS:
                assert getattr(r, m)() == getattr(jr, m)(), (where, m)


def test_rules_without_a_mesh_match_jax():
    for arch in sorted(ARCHS):
        jr = JRules(None, JARCHS[arch])
        r = ShardingRules(None, ARCHS[arch])
        assert r.attn == type(r.attn)(jr.attn.kind, jr.attn.kv_dup,
                                      jr.attn.q_pad)
        for p in PROPS:
            assert getattr(r, p) == getattr(jr, p), (arch, p)


# ------------------------------------------------------------------ #
# param and cache specs of every arch's full-size abstract trees
# ------------------------------------------------------------------ #
SPEC_CELLS = [((2, 2), ("data", "model"), "tp"),
              ((1, 4), ("data", "model"), "tp"),
              ((16, 16), ("data", "model"), "tp"),
              ((16, 16), ("data", "model"), "fsdp"),
              ((16, 16), ("data", "model"), "serve"),
              ((2, 16, 16), ("pod", "data", "model"), "tp")]


def _jax_model(arch, kind, gb, mesh, strategy):
    seq = 448 if arch == "whisper-small" else 128
    jshape = JShape("s", seq_len=seq, global_batch=gb, kind=kind)
    jr = JRules(JAbstractMesh(*mesh), JARCHS[arch], jshape,
                strategy=strategy)
    return japi.build(JARCHS[arch], jshape, JLane(), jr), jr, seq


def _flat_specs(tree):
    out = {}
    sparams.map_dict(lambda n, s: out.setdefault(n, _norm(s)), tree)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch):
    """param_shardings of the port's abstract params (FakeTensorMode
    init) equal JAX's on its eval_shape'd params, leaf by leaf."""
    aparams = None
    for shape, names, strategy in SPEC_CELLS:
        jm, jr, seq = _jax_model(arch, "train", 256, (shape, names), strategy)
        if aparams is None:
            aparams = api.abstract_params(ARCHS[arch], LaneConfig(),
                                          max_seq=seq)
            jabstract = jm.abstract_params()
        jspecs = jparams.param_shardings(jabstract, jr)
        want = {tuple(str(getattr(k, "key", k)) for k in p): _jspec(ns)
                for p, ns in jax.tree_util.tree_flatten_with_path(jspecs)[0]}
        r = ShardingRules(mesh_lib.AbstractMesh(shape, names), ARCHS[arch],
                          ShapeConfig("s", seq_len=seq, global_batch=256,
                                      kind="train"), strategy=strategy)
        got = _flat_specs(sparams.param_shardings(aparams, r))
        assert got == want, (arch, shape, strategy)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_jax(arch):
    """cache_shardings over JAX's abstract decode caches (the same tree of
    shapes on both sides: KV heads duplicated as the plan says)."""
    for shape, names, strategy in SPEC_CELLS:
        for gb in (1, 64):
            jm, jr, seq = _jax_model(arch, "decode", gb, (shape, names),
                                     strategy)
            jcaches = jm.abstract_caches()
            jspecs = jparams.cache_shardings(jcaches, jr)
            want = [_jspec(ns) for ns in jax.tree.leaves(jspecs)]
            port_tree = jax.tree.map(
                lambda a: torch.empty(a.shape, device="meta"), jcaches)
            r = ShardingRules(mesh_lib.AbstractMesh(shape, names),
                              ARCHS[arch],
                              ShapeConfig("s", seq_len=seq, global_batch=gb,
                                          kind="decode"), strategy=strategy)
            got = [_norm(s) for s in jax.tree.leaves(
                sparams.cache_shardings(port_tree, r),
                is_leaf=lambda x: isinstance(x, tuple) and not any(
                    isinstance(e, dict) for e in x))]
            assert got == want, (arch, shape, strategy, gb)


def test_batch_shardings_match_jax():
    """Rows over the batch axes, probe_mask replicated, and a batch the
    batch axes do not divide replicated (tiny batches)."""
    for shape, names in MESHES:
        for gb in (1, 2, 4, 512):
            jcfg, cfg = jreduced(JARCHS["qwen3-4b"]), reduced(ARCHS["qwen3-4b"])
            jshape = JShape("s", seq_len=16, global_batch=gb, kind="train")
            jr = JRules(JAbstractMesh(shape, names), jcfg, jshape)
            specs = japi.build_input_specs(jcfg, jshape, JLane(), jr)
            want = {k: _jspec(v)
                    for k, v in japi.batch_shardings(specs, jr).items()}
            r = ShardingRules(mesh_lib.AbstractMesh(shape, names), cfg,
                              ShapeConfig("s", seq_len=16, global_batch=gb,
                                          kind="train"))
            got = {k: _norm(v) for k, v in api.batch_shardings(
                {k: tuple(v.shape) for k, v in specs.items()}, r).items()}
            assert got == want, (shape, gb)


# ------------------------------------------------------------------ #
# shard descriptors, index maps and the noise at them
# ------------------------------------------------------------------ #
def test_index_map_merges_and_bounds():
    d = sparams.shard_desc((35, 2560, 9728), (None, "data", "model"),
                           {"data": 1, "model": 1}, {"data": 2, "model": 2})
    assert d.local_shape == (35, 1280, 4864)
    assert d.index == IndexMap(1280 * 9728 + 4864,
                               ((35, 2560 * 9728), (1280, 9728), (4864, 1)))
    # the H and Dh dims of wo merge: [L, H/tp, Dh, D/dp]
    d = sparams.shard_desc((3, 8, 16, 64), (None, "model", None, "data"),
                           {"data": 0, "model": 1}, {"data": 2, "model": 2})
    assert d.index.levels == ((3, 8 * 16 * 64), (4 * 16, 64), (32, 1))
    # a data-sharded leading dim is one contiguous run
    d = sparams.shard_desc((8, 64), ("data", None), {"data": 2, "model": 0},
                           {"data": 4, "model": 1})
    assert d.index.is_contiguous and d.index.base == 2 * 2 * 64
    assert IndexMap(5, ((10, 1),)).is_contiguous
    assert not IndexMap(5, ((10, 2),)).is_contiguous
    # indices past 2**32 wrap, as the JAX package's uint32 iota does
    assert IndexMap(2**32 - 4, ((5, 1),)).flat_indices().tolist() == [
        2**32 - 4, 2**32 - 3, 2**32 - 2, 2**32 - 1, 0]
    with pytest.raises(ValueError, match="does not split"):
        sparams.shard_desc((6,), ("model",), {"model": 0}, {"model": 4})


def test_shard_and_unshard_round_trip():
    t = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    sizes = {"data": 2, "model": 2}
    descs = [sparams.shard_desc(t.shape, (None, "data", "model"),
                                {"data": r // 2, "model": r % 2}, sizes)
             for r in range(4)]
    shards = [sparams.shard_leaf(t, d) for d in descs]
    assert all(s.is_contiguous() and s.shape == (4, 3, 4) for s in shards)
    assert torch.equal(sparams.unshard_leaf(shards, descs), t)
    for s, d in zip(shards, descs):
        assert torch.equal(s.reshape(-1), t.reshape(-1)[
            d.index.flat_indices()])


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: "x".join(map(str, m)))
def test_shard_noise_is_global_noise_sliced(mesh):
    """Every rank's z of every leaf of reduced qwen3-4b (f32), drawn by
    the plain version at the shard's index map, bitwise the whole leaf's
    z sliced; zo_perturb_ref and zo_fused_replay_ref with the map
    likewise. 1x4 runs the kv_dup = 2 plan (4 heads over 2 KV heads)."""
    cfg = reduced(ARCHS["qwen3-4b"], dtype="float32")
    r = ShardingRules(mesh_lib.AbstractMesh(mesh, ("data", "model")), cfg,
                      ShapeConfig("s", seq_len=16, global_batch=2,
                                  kind="train"))
    if mesh == (1, 4):
        assert r.attn.kv_dup == 2
    params = api.init(cfg, seed=0, device="cpu")
    specs = sparams.param_shardings(params, r)
    seeds = torch.tensor([[12345, 777]], dtype=torch.int64)
    coeffs = torch.tensor([[1e-3, -2e-3]])
    sharded = 0
    for rank in range(4):
        coords = {"data": rank // mesh[1], "model": rank % mesh[1]}
        descs = sparams.shard_descs(params, specs, coords, r.sizes)
        for path, leaf in zo.leaves_with_path(params):
            d = zo._at(descs, path)
            salt = zo.path_salt(path)
            shard = sparams.shard_leaf(leaf, d)
            sharded += not d.whole
            z = prng.normal(12345, salt, d.local_shape, index=d.index)
            assert torch.equal(z, prng.normal(12345, salt,
                                              leaf.shape)[d.slices]), path
            assert torch.equal(
                ref.zo_perturb_ref(shard, 12345, salt, 1e-3, index=d.index),
                ref.zo_perturb_ref(leaf, 12345, salt, 1e-3)[d.slices]), path
            assert torch.equal(
                ref.zo_fused_replay_ref(shard, seeds, coeffs, salt,
                                        index=d.index),
                ref.zo_fused_replay_ref(leaf, seeds, coeffs,
                                        salt)[d.slices]), path
    assert sharded > 0


# ------------------------------------------------------------------ #
# what a mesh refuses
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "whisper-small",
                                  "llava-next-34b"])
def test_mesh_refuses_other_stacks(arch):
    """No stack is refused under a mesh any more: the MoE stacks
    (tests/test_torch_mesh_moe.py), RWKV6 (tests/test_torch_mesh_rwkv.py),
    Jamba's Mamba, attention and MoE blocks
    (tests/test_torch_mesh_jamba.py), Whisper's encoder-decoder and
    LLaVA's image-token prefix (tests/test_torch_mesh_encdec.py) build
    their engines on a mesh, unfused and fused."""
    cfg = reduced(ARCHS[arch])
    run = types.SimpleNamespace(index_maps=lambda: None)
    for fused in (False, True):
        engine, _ = api.train_engine(cfg, LaneConfig(fused_probes=fused),
                                     run=run)
        assert engine.run is run
        assert (engine.paired_loss_fn is not None) == fused


def test_mesh_refuses_other_strategies_and_fused_probes(monkeypatch):
    """What a mesh still refuses: a strategy the rules do not name (on a
    mesh and without one). RWKV6's recurrent blocks build in every
    strategy (a rank's view of the mesh, ``torch_recurrent_ranks.
    RankView``, in place of the process groups) and with fused probes;
    tests/test_torch_strategies.py, tests/test_torch_mesh_rwkv.py and
    the other mesh tests run them on ranks."""
    import torch_recurrent_ranks
    from repro_torch.sharding import collectives
    monkeypatch.setattr(collectives, "MeshRun", torch_recurrent_ranks.RankView)
    cfg = reduced(ARCHS["qwen3-4b"])
    rwkv = reduced(ARCHS["rwkv6-1.6b"])
    shape = ShapeConfig("s", seq_len=16, global_batch=2, kind="train")
    mesh = mesh_lib.AbstractMesh((2, 2), ("data", "model"))
    for m in (mesh, None):
        with pytest.raises(ValueError, match="strategy 'dp'"):
            elastic_runtime.build_for_mesh(cfg, shape, LaneConfig(), m, "dp")
    for strategy in ("tp", "fsdp", "serve"):
        for fused in (False, True):
            model, _ = elastic_runtime.build_for_mesh(
                rwkv, shape, LaneConfig(fused_probes=fused), mesh, strategy)
            assert model.run.rules.strategy == strategy
            assert model.engine.run is model.run
            assert (model.engine.paired_loss_fn is not None) == fused


def test_seq_plan_raises(monkeypatch):
    """phi4-mini at tp 16 takes the seq plan (24 heads pad to 32: 33%
    waste), whose ranks split the query rows in blocks of ceil(S / tp),
    the last ones short or empty (tests/test_torch_strategies.py runs
    the plan); whisper-small takes it at tp 8, and its encoder-decoder
    stack is accepted under a mesh (tests/test_torch_mesh_encdec.py
    runs Whisper's seq plan at 1x4). Jamba's stack, Mamba blocks among
    its attention and MoE blocks, is accepted there too, and takes the
    tp attention plan and the ep MoE plan at tp 8."""
    import torch_recurrent_ranks
    from repro_torch.models.layers import seq_rows
    from repro_torch.sharding import collectives
    cfg = ARCHS["phi4-mini-3.8b"]
    r = ShardingRules(mesh_lib.AbstractMesh((1, 16), ("data", "model")), cfg)
    assert r.attn.kind == "seq"
    assert [seq_rows(18, 4, i) for i in range(4)] == [
        (0, 5), (5, 10), (10, 15), (15, 18)]
    assert [seq_rows(6, 4, i) for i in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 6)]
    whisper = ARCHS["whisper-small"]
    mesh = mesh_lib.AbstractMesh((1, 8), ("data", "model"))
    assert ShardingRules(mesh, whisper).attn.kind == "seq"
    monkeypatch.setattr(collectives, "MeshRun", torch_recurrent_ranks.RankView)
    shape = ShapeConfig("s", seq_len=16, global_batch=2, kind="train")
    for arch in ("whisper-small", "jamba-v0.1-52b"):
        model, _ = elastic_runtime.build_for_mesh(ARCHS[arch], shape,
                                                  LaneConfig(), mesh)
        assert model.engine.run is model.run
    rules = model.run.rules
    assert (rules.attn.kind, rules.moe) == ("tp", "ep")


def test_nccl_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs a card a rank"):
        mesh_lib.check_world("nccl", "cuda", 4)
    with pytest.raises(ValueError, match="rank 1 has none"):
        mesh_lib.rank_device("nccl", "cuda", 1)
    mesh_lib.check_world("gloo", "cuda", 4)            # sharing, as asked
    assert mesh_lib.rank_device("gloo", "cuda", 3) == torch.device("cuda", 0)
    assert "gloo" in mesh_lib.sharing_note("gloo", "cuda", 4)
    assert mesh_lib.default_backend("cpu") == "gloo"
    assert mesh_lib.default_backend("cuda") == "nccl"


def test_nccl_counts_the_ranks_of_this_host(monkeypatch):
    """Under torchrun across hosts, NCCL holds this host's ranks
    (LOCAL_WORLD_SIZE), not the world, against its cards."""
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for k, v in {"RANK": "300", "WORLD_SIZE": "512", "LOCAL_RANK": "4",
                 "LOCAL_WORLD_SIZE": "8"}.items():
        monkeypatch.setenv(k, v)
    assert mesh_lib.env_rank() == (300, 512, 4, 8)
    mesh_lib.check_world("nccl", "cuda", 8)
    with pytest.raises(ValueError, match="9 ranks on this host, 8 card"):
        mesh_lib.check_world("nccl", "cuda", 9)
    seen = []

    def joined(*a, **kw):
        seen.append((a, kw))
        raise KeyboardInterrupt           # stop before the group is made
    monkeypatch.setattr(mesh_lib, "init_ranks", joined)
    with pytest.raises(KeyboardInterrupt):
        launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device",
                           "cuda", "--mesh", "2x16x16:pod,data,model"])
    assert seen == [(("nccl", "cuda", 4, 512, "env://"),
                     {"rank": 300, "local_world": 8})]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    with pytest.raises(ValueError, match="16 ranks on this host"):
        launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device",
                           "cuda", "--mesh", "2x16x16:pod,data,model"])


def test_parse_mesh_and_production_shape():
    assert mesh_lib.parse_mesh("2x2:data,model") == ((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        mesh_lib.parse_mesh("2x2:data")
    assert mesh_lib.production_shape() == ((16, 16), ("data", "model"))
    assert mesh_lib.production_shape(True) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh()


def test_abstract_mesh_and_dataclass_shapes():
    m = mesh_lib.AbstractMesh((2, 4), ("data", "model"))
    assert mesh_lib.axis_shape(m) == {"data": 2, "model": 4}
    assert dataclasses.is_dataclass(m)
    assert np.prod(m.axis_sizes) == 8
