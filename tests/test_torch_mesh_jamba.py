"""Port parity of Jamba trained across a mesh, on CPU ranks: its Mamba
blocks' d_inner split over `model` (``models/ssm.py``) beside its
attention and MoE blocks, in every strategy.

Four spawned gloo ranks (``torch_recurrent_ranks.py``, one intra-op
thread each; rendezvous at a ``file://`` store under the test's
temporary directory, never a TCP port) train reduced jamba-v0.1-52b in
f32 from one init in every case of the suite: 2 elastic_zo steps and 1
full_bp step each. Most cases run a 3-block pattern (Mamba, Mamba with
a MoE FFN, attention) over two periods, so the BP tail differentiates a
dense Mamba block, a MoE Mamba block and an attention block: 2x2 ``tp``
(4 experts over 2 `model` ranks: the ``ep`` plan, each rank its own
experts), 2x2 ``fsdp`` at batch 4 (the rows over (data, model): the
dispatch all-to-all beside the Mamba blocks), 2x2 ``serve`` and 1x4
``tp`` (d_inner 128, 32 channels a rank). Jamba's own 8-block pattern
(one period) runs at 2x2 ``tp``. Then the fused probe pair at 2x2
``fsdp``, the in_proj re-layout at tp 2 and 4, and rank 0 alone on a 1x1
mesh. Meanwhile subprocesses with 4 forced host devices run JAX's jitted
step in every case from the same init and batches.

Tolerances as in ``test_torch_mesh_rwkv.py``: ``LM_TOL`` for the sharded
sums' orders and the scan's chunk walk; the full_bp step moves every
leaf, so a norm-scale gradient left partial on a `model` rank (dt_norm,
B_norm, C_norm after x_proj's sum) or an in_proj column taken from the
wrong rank leaves the tolerance or breaks the replicas. The elastic_zo
lane takes the lanes' ZO rate, 1e-2, but 1e-3 in the serve case and the
8-block one (``torch_recurrent_ranks.rate_of``). The fused pair, the
re-layout's channels and the one-rank world are bitwise.
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
SUITE = ranks.SUITES["jamba"]
CASES = SUITE["cases"]
JAX_PROCS = 4           # JAX subprocesses, each compiling part of the cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case once (``ranks.run_suite``). Returns the output
    directory."""
    out = str(tmp_path_factory.mktemp("mesh_jamba"))
    ranks.run_suite(out, "jamba", JAX_PROCS)
    return out


def _load(out, name):
    path = os.path.join(out, name + ".npz")
    arrays = dict(np.load(path)) if os.path.exists(path) else {}
    meta = os.path.join(out, name + ".json")
    return arrays, (json.load(open(meta)) if os.path.exists(meta) else {})


def _jax(out, name):
    """JAX's run ``name``: (losses, rules.moe, batch axes, leaves)."""
    want = dict(np.load(os.path.join(out, f"jax_{name}.npz")))
    axes = str(want.pop("batch_axes"))
    want.pop("attn")
    return (want.pop("losses"), str(want.pop("moe")),
            axes.split(",") if axes else [], want)


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
    BP update of its Mamba, MoE and attention blocks included), or after
    1 full_bp step (every leaf moved), within LM_TOL of JAX's step on the
    same mesh in the same strategy."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, moe, _, want = _jax(runs, f"{case}_{lane}")
    assert meta["moe"] == moe
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, want, f"{case} {lane} against JAX")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_one_device(runs, case, lane):
    """The same runs within LM_TOL of the port's one-device step, the
    replicated leaves (the Mamba norms and dt / B / C norm scales, the
    router over `model`) and the copies of each shard bitwise on every
    rank (``MeshRun.check_replicas``)."""
    got, meta = _load(runs, f"{case}_{lane}")
    losses, params = _one_device(runs, CASES[case], lane)
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, {zo.keystr(p): t.numpy()
                 for p, t in zo.leaves_with_path(params)},
           f"{case} {lane} against one device")
    assert meta["replica_pairs"] > 0


BATCH_AXES = {"fsdp_b4": ["data", "model"]}


@pytest.mark.parametrize("case", list(CASES))
def test_rules_take_the_plans(runs, case):
    """4 experts over 2 or 4 `model` ranks take the ``ep`` plan in every
    strategy; the attention block the ``tp`` plan (at 1x4 its 2 KV heads
    duplicated); fsdp at batch 4 puts the rows over (data, model). JAX's
    rules say the same."""
    _, meta = _load(runs, f"{case}_full_bp")
    _, moe, axes, _ = _jax(runs, f"{case}_full_bp")
    assert meta["moe"] == moe == "ep"
    assert meta["attn"] == "tp"
    assert meta["batch_axes"] == axes == BATCH_AXES.get(case, ["data"])


@pytest.mark.parametrize("case", list(SUITE["fused"]))
def test_fused_pair_is_bitwise_the_unfused_pair(runs, case):
    """The fused pair under ``fsdp`` perturbs each period's gathered
    slice (an expert leaf's block of experts) at its global flat
    indices, a period mixing Mamba, MoE and attention blocks; it is
    bitwise the unfused pair."""
    _, meta = _load(runs, case)
    assert meta["fused_pair"] == meta["unfused_pair"]


@pytest.mark.parametrize("case", list(SUITE["fused"]))
def test_fused_matches_jax_unfused(runs, case):
    """The fused lane's 2 steps within LM_TOL of JAX's unfused lane on
    the same mesh (the fused pair is the unfused one)."""
    got, meta = _load(runs, case)
    losses, _, _, want = _jax(runs, f"{SUITE['fused'][case]}_elastic_zo")
    np.testing.assert_allclose(meta["losses"], losses, **LM_TOL)
    _close(got, want, f"{case} against JAX's unfused lane")


@pytest.mark.parametrize("lane", list(ranks.LANE_STEPS))
def test_one_rank_world_is_one_device(runs, lane):
    res = json.load(open(os.path.join(runs, "one_rank.json")))
    assert res[lane] == {"losses": True, "params": True}


def test_in_proj_relayout_gives_the_ranks_channels(runs):
    """``ssm.py::in_proj_channels`` on every rank at tp 2 and tp 4: xs
    and z bitwise the rank's d_inner channels of the one-device product
    (whose contiguous in_proj shard holds other channels: at tp 2 rank 0
    holds all of xs), and the in_proj shard's gradient the whole one's
    shard."""
    _, meta = _load(runs, "in_proj")
    ok = {"xs": True, "z": True, "grad": True}
    assert meta["ranks"] == [{"tp2": ok, "tp4": ok}] * 4


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
    """The launches a rank makes a step in the card's Mamba lane
    (``chip_smoke.py::mesh_per_step`` of ``mesh_cfg`` at the lane's
    overrides, MESH_MAMBA_ONLY: 2 of Jamba's Mamba blocks at full width,
    each with a dense FFN): 18 ZO
    leaves (embed, and the ZO period's 13 Mamba leaves, ln_ffn and the
    MLP's 3), so 36 / 18 / 0, fused 36 / 18 / 0. A Jamba stack of two
    periods: 133 ZO leaves (embed and a period's 8 blocks: 7 Mamba, one
    attention, 4 MoE FFNs), 2 flash launches."""
    cs = _chip_smoke()
    cfg = cs.mesh_cfg("jamba-v0.1-52b", cs.MESH_MAMBA_ONLY)
    assert (cfg.d_model, cfg.ssm_expand, cfg.num_layers, cfg.is_moe) == (
        4096, 2, 2, False)
    assert [tuple(cs.mesh_per_step(cfg, f).values()) for f in (False, True)
            ] == [(36, 18, 0), (36, 18, 0)]
    import dataclasses
    from repro_torch.configs import ARCHS
    two = dataclasses.replace(ARCHS["jamba-v0.1-52b"], num_layers=16)
    assert tuple(cs.mesh_per_step(two).values()) == (266, 133, 2)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["tp", "tp8"])
def test_mesh_per_step_counts_a_step(case, fused, monkeypatch):
    """``mesh_per_step`` of reduced Jamba (the 3-block pattern over two
    periods, and its own pattern over one: an empty tail) is what one
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
    c = CASES[case]
    cfg = ranks.cfg_of(c)
    lane = ranks.lane_of("elastic_zo", fused=fused)
    params = api.init(cfg, lane, seed=0, device="cpu", max_seq=ranks.SEQ)
    batch = {k: torch.from_numpy(v) for k, v in ranks.make_batch(c, 0).items()}
    ranks.run_steps(api.make_train_step(cfg, lane), params, [batch])
    assert counts == cs.mesh_per_step(cfg, fused)
