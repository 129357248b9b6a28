"""Port parity of RWKV6 trained across a mesh, on CPU ranks: its heads
split over `model` (``models/ssm.py``), in every strategy.

Four spawned gloo ranks (``torch_recurrent_ranks.py``, one intra-op
thread each; rendezvous at a ``file://`` store under the test's
temporary directory, never a TCP port) train reduced rwkv6-1.6b in f32
(4 heads of 16) from one init in every case of the suite: 2 elastic_zo
steps and 1 full_bp step each, under ``tp`` (2x2, 1x4 at one head a
rank, and the pod mesh 2x1x2), ``fsdp`` (rows over (data, model) at batch
4, over data at batch 2) and ``serve``; and 2 heads of 32 at 1x4, where
tp divides d_model but not the heads (the time mix on weights gathered
over `model`, the channel mix split), held against one device. Then the
fused probe pair at 2x2 ``tp``, a ``tp`` checkpoint restored under
``fsdp``, and rank 0 alone on a 1x1 mesh. Meanwhile subprocesses with 4
forced host devices run JAX's jitted step in every case from the same
init and batches.

Tolerances: the sharded products and sums add in other orders than one
device's (and than XLA's), and the port walks the WKV chunk boundaries
in order where JAX takes ``associative_scan``'s tree, so steps agree
within ``LM_TOL`` (as ``test_torch_strategies.py``). The full_bp step
moves every leaf, so a ddlerp or decay_base gradient left partial on a
`model` rank (or summed twice) leaves the tolerance or breaks the
replicas. The elastic_zo lane takes the lanes' ZO rate, 1e-2, but 1e-3
in the fsdp case at batch 4 and the 2-head case, where at 1e-2 JAX's
meshes too land outside LM_TOL of one device's step
(``torch_recurrent_ranks.rate_of``). The fused pair and the one-rank
world are bitwise.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_recurrent_ranks as ranks  # noqa: E402
from repro_torch.core import api, zo  # noqa: E402

LM_TOL = dict(rtol=1e-3, atol=1e-4)
SUITE = ranks.SUITES["rwkv"]
CASES = SUITE["cases"]
LOCAL = SUITE["local"]
JAX_PROCS = 3           # JAX subprocesses, each compiling part of the cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case once (``ranks.run_suite``). Returns the output
    directory."""
    out = str(tmp_path_factory.mktemp("mesh_rwkv"))
    ranks.run_suite(out, "rwkv", JAX_PROCS)
    return out


def _load(out, name):
    path = os.path.join(out, name + ".npz")
    arrays = dict(np.load(path)) if os.path.exists(path) else {}
    meta = os.path.join(out, name + ".json")
    return arrays, (json.load(open(meta)) if os.path.exists(meta) else {})


def _jax(out, name):
    """JAX's run ``name``: (losses, batch axes, leaves)."""
    want = dict(np.load(os.path.join(out, f"jax_{name}.npz")))
    axes = str(want.pop("batch_axes"))
    want.pop("attn"), want.pop("moe")
    return want.pop("losses"), axes.split(",") if axes else [], want


def _close(got, want, what):
    assert set(got) >= set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **LM_TOL)


def _one_device(out, case, lane_name):
    """The port's run on one device from the same init and batches."""
    params = ranks.load_params(
        os.path.join(out, ranks.init_name(case) + ".npz"), case)
    steps = ranks.LANE_STEPS[lane_name]
    return ranks.run_steps(
        api.make_train_step(ranks.cfg_of(case),
                            ranks.lane_of(lane_name, case)),
        params, ranks.batches(out, case, steps))


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_jax(runs, case, lane):
    """Losses of 2 elastic_zo steps, and every leaf after them (the tail's
    BP update included), or after 1 full_bp step (every leaf moved),
    within LM_TOL of JAX's step on the same mesh in the same
    strategy."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, _, want = _jax(runs, f"{case}_{lane}")
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, want, f"{case} {lane} against JAX")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(CASES) + list(LOCAL))
def test_case_matches_one_device(runs, case, lane):
    """The same runs within LM_TOL of the port's one-device step, the
    replicated leaves (the ddlerp's and the channel mix's cm_r over
    `model`, the norm scales) and the copies of each shard bitwise on
    every rank (``MeshRun.check_replicas``)."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, params = _one_device(runs, {**CASES, **LOCAL}[case], lane)
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, {zo.keystr(p): t.numpy()
                 for p, t in zo.leaves_with_path(params)},
           f"{case} {lane} against one device")
    assert meta["replica_pairs"] > 0


BATCH_AXES = {"fsdp_b4": ["data", "model"], "pod": ["pod", "data"]}


@pytest.mark.parametrize("case", list(CASES))
def test_rules_split_the_rows(runs, case):
    """fsdp puts the rows over (data, model) where 4 rows divide the mesh
    and over data alone at 2 rows; the pod mesh over (pod, data); JAX's
    rules say the same."""
    _, meta = _load(runs, f"{case}_full_bp")
    _, axes, _ = _jax(runs, f"{case}_full_bp")
    assert meta["batch_axes"] == axes == BATCH_AXES.get(case, ["data"])


@pytest.mark.parametrize("case", list(SUITE["fused"]))
def test_fused_pair_is_bitwise_the_unfused_pair(runs, case):
    """The fused pair perturbs each period's slice of the rank's shards
    at their period maps; it is bitwise the unfused pair."""
    _, meta = _load(runs, case)
    assert meta["fused_pair"] == meta["unfused_pair"]


@pytest.mark.parametrize("case", list(SUITE["fused"]))
def test_fused_matches_jax_unfused(runs, case):
    """The fused lane's 2 steps within LM_TOL of JAX's unfused lane on
    the same mesh (the fused pair is the unfused one)."""
    got, meta = _load(runs, case)
    losses, _, want = _jax(runs, f"{SUITE['fused'][case]}_elastic_zo")
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, want, f"{case} against JAX's unfused lane")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
def test_one_rank_world_is_one_device(runs, lane):
    res = json.load(open(os.path.join(runs, "one_rank.json")))
    assert res[lane] == {"losses": True, "params": True}


def test_tp_checkpoint_restores_under_fsdp(runs):
    """RWKV6 saved at 2x2 tp after one step, restored at 2x2 fsdp: on
    every rank each of the 45 leaves' shards is bytes-equal to the whole
    leaf's slice, 30 of them sharded (every RWKV6 leaf but the vectors,
    maa_base and the norm scales)."""
    _, meta = _load(runs, "restored_fsdp")
    assert meta["ranks"] == [[True, 45, 30, 1]] * 4


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch and the port
    only, and runs nothing when imported)."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_per_step_at_full_width():
    """The launches a rank makes a step in the card's RWKV6 lane
    (``chip_smoke.py::mesh_per_step``) at 2 of 24 layers: 22 ZO leaves
    (embed and the ZO period's 21 block leaves), so 44 / 22 / 0, fused
    44 / 22 / 0 (one ZO period); every strategy alike."""
    cs = _chip_smoke()
    cfg = cs.mesh_cfg("rwkv6-1.6b")
    assert cfg.num_layers == 2 and cfg.d_model == 2048
    assert [tuple(cs.mesh_per_step(cfg, f).values()) for f in (False, True)
            ] == [(44, 22, 0), (44, 22, 0)]


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_per_step_counts_a_step(fused, monkeypatch):
    """``mesh_per_step`` of reduced RWKV6 (two periods) is what one
    elastic_zo step calls of each kernel's entry point in ``kernels.ops``
    on one device (the CPU runs the plain versions; a mesh rank makes the
    same calls in every strategy)."""
    from repro_torch.kernels import ops
    cs = _chip_smoke()
    counts = {}
    for name in ("zo_perturb", "zo_fused_replay", "flash_attention"):
        def count(*a, _f=getattr(ops, name), _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, name, count)
    c = CASES["tp"]
    cfg = ranks.cfg_of(c)
    lane = ranks.lane_of("elastic_zo", fused=fused)
    params = api.init(cfg, lane, seed=0, device="cpu", max_seq=ranks.SEQ)
    batch = {k: torch.from_numpy(v) for k, v in ranks.make_batch(c, 0).items()}
    ranks.run_steps(api.make_train_step(cfg, lane), params, [batch])
    want = cs.mesh_per_step(cfg, fused)
    assert {k: counts.get(k, 0) for k in want} == want


def test_head_split_follows_the_specs():
    """Which RWKV6 leaves `model` splits at the reduced config's tp 4
    (``sharding/params.py``, JAX's specs): 4 heads of 16 split the
    heads (w_r, bonus, gn_scale, decay_w2) and d_ff (cm_k, cm_v); 2
    heads of 32 split d_model's columns but not the heads, so the time
    mix gathers its leaves over `model` and computes the whole mix."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.layers import _model_sharded
    from repro_torch.sharding.params import param_shardings
    from repro_torch.sharding.rules import ShardingRules
    for name, heads in (("tp", True), ("tp_h2", False)):
        case = {**CASES, **LOCAL}[name]
        cfg = ranks.cfg_of(case)
        rules = ShardingRules(AbstractMesh((1, 4), ("data", "model")), cfg,
                              ranks.shape_of(case), strategy="tp")
        specs = param_shardings(api.abstract_params(
            cfg, ranks.lane_of("elastic_zo"), max_seq=ranks.SEQ),
            rules)["periods_zo"]["blk0"]["rwkv"]
        split = {k for k, s in specs.items() if _model_sharded(s)}
        assert {"w_r", "w_k", "w_v", "w_g", "w_o", "decay_w2", "cm_k",
                "cm_v"} <= split
        assert ({"bonus", "gn_scale"} <= split) == heads
        assert not split & {"maa_w1", "maa_w2", "decay_w1", "cm_r",
                            "decay_base", "maa_base"}
