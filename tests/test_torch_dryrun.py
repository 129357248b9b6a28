"""The port's cost tools: the dry run on a fake world (``launch/
dryrun.py``), its collective records, the meta footprint, the audit's
accounting and the H100 roofline, against JAX's and against a real run.

Four spawned gloo ranks (``torch_dryrun_ranks.py``, one intra-op thread
each; rendezvous at a ``file://`` store under the test's temporary
directory) run one train step of reduced f32 stacks on a 2x2 mesh under
a cost counter: qwen3-4b in ``tp``, ``fsdp`` and ``serve``, and Mixtral
under the MoE ``ep`` plan with its rows over (data, model), so that the
dispatch all-to-all runs; then the serving steps of ``SERVE_CASES``
(prefills, and decodes with the cache's slots over `model`, over
`data`, Whisper's ck / cv split, and the MoE's all-to-all under
``fsdp``), and ``attend_combine`` over keys split across ranks. The dry
run of the same steps, on ``meta`` tensors over a fake process group as
rank 0 and as rank 3 in this process (each fake world destroyed on
exit), must record the same collectives in the same order, group ranks
and bytes included, and the same kernel launches. Meanwhile a
subprocess with 4 forced host devices compiles JAX's train, prefill and
decode steps of the same cells for their argument bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import torch_dryrun_ranks as ranks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import LaneConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.launch import comm_analysis, dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.obs.memory import meta_footprint  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LANES = ("elastic_zo", "full_zo", "full_bp")
DECODER = ("tp", "fsdp", "serve")

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    assert jax.device_count() == 4
    from repro.configs import ARCHS, LaneConfig, ShapeConfig, reduced
    from repro.launch.dryrun import lower_cell
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, (arch, strategy, B, S, kind) in json.loads(
            sys.argv[1]).items():
        cfg = reduced(ARCHS[arch], dtype="float32")
        shape = ShapeConfig("t", seq_len=S, global_batch=B, kind=kind)
        lane = LaneConfig(lane="elastic_zo", bp_tail_layers=1,
                          zo_num_probes=1)
        _, compiled = lower_cell(cfg, shape, mesh, lane, strategy=strategy)
        out[name] = compiled.memory_analysis().argument_size_in_bytes
    print("ARGS " + json.dumps(out))
""")


SERVE_JAX = ("prefill_tp", "decode_serve", "decode_context")


def _case(name):
    """(arch, strategy, batch, seq, kind) of a train or serve case."""
    if name in ranks.CASES:
        return tuple(ranks.CASES[name]) + ("train",)
    return ranks.SERVE_CASES[name]


def _dry(name, rank):
    arch, strategy, B, S, kind = _case(name)
    with mesh_lib.fake_world(4, rank=rank):
        mesh = mesh_lib.make_mesh(*ranks.MESH)
        full = dryrun.analyze(ranks.cfg_of(arch), ranks.shape_of(B, S, kind),
                              ranks.lane_of(), mesh, strategy)
    full["records"] = [ranks.record(r) for r in full["records"]]
    return full


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ranks")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    jax_cases = {k: _case(k) for k in DECODER + SERVE_JAX}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT,
                             json.dumps(jax_cases)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        mesh_lib.spawn(ranks.dryrun_rank, 4,
                       ("file://" + str(out / "store"), str(out)))
        real = [json.loads((out / f"rank{r}.json").read_text())
                for r in range(4)]
        dry = {(name, r): _dry(name, r)
               for name in list(ranks.CASES) + list(ranks.SERVE_CASES)
               for r in (0, 3)}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    line = [x for x in stdout.splitlines() if x.startswith("ARGS ")]
    assert line, stderr[-3000:]
    return real, dry, json.loads(line[0][5:])


# ---------------------------------------------------------------------- #
# the configs and the analytic FLOPs, against the JAX package's
# ---------------------------------------------------------------------- #
def test_shapes_and_cell_matrix_match_jax():
    import repro.configs as jc
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}
    for name in jc.SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(jc.get_shape(name))
    assert configs.cell_matrix() == jc.cell_matrix()
    cells = configs.cell_matrix()
    assert len(cells) == 40 and sum(not c[2] for c in cells) == 7
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


@pytest.mark.parametrize("lane", LANES)
def test_model_flops_match_the_reference(lane):
    from benchmarks.roofline import model_flops_per_device as jax_flops
    from repro.configs import LaneConfig as JaxLane
    for arch, shape, _run, _why in configs.cell_matrix():
        got = roofline.model_flops_per_device(arch, shape, 256,
                                              LaneConfig(lane=lane))
        want = jax_flops(arch, shape, 256, JaxLane(lane=lane))
        for k in ("total", "per_device"):
            assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), (arch,
                                                                   shape, k)
        assert got["formula"] == want["formula"]
        assert (got["params_active"], got["params_total"]) == (
            want["params_active"], want["params_total"])


def test_index_maps_past_2_32_wrap_as_jax_does():
    """A shard of a leaf past 2**32 elements draws at each flat index mod
    2**32: JAX's uint32 iota plus offset wraps the same way."""
    import jax.numpy as jnp
    from repro.core import prng as jprng
    from repro_torch.core import prng
    base = 2**32 - 5
    got = prng.uniform_bits(7, 11, (9,), index=prng.IndexMap(
        base, ((9, 1),)))
    want = np.asarray(jprng.uniform_bits(jnp.uint32(7), 11, (9,),
                                         offset=base)).astype(np.int64)
    assert got.tolist() == want.tolist()
    assert prng.IndexMap(base, ((3, 4), (2, 1))).flat_indices().tolist() == [
        (base + 4 * i + j) % 2**32 for i in range(3) for j in range(2)]


# ---------------------------------------------------------------------- #
# the dry run against a real gloo run of the same steps
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_collective_records_match_a_gloo_run(runs, case):
    real, dry, _ = runs
    for rank in (0, 3):
        assert dry[(case, rank)]["records"] == real[rank][case]["records"]
    kinds = {r[0] for r in real[0][case]["records"]}
    assert {"all-gather", "all-reduce"} <= kinds
    if case == "moe_ep":
        assert "all-to-all" in kinds


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_launches_match_a_gloo_run_and_the_last_rank(runs, case):
    real, dry, _ = runs
    got = {k: v["launches"] for k, v in dry[(case, 0)]["kernels"].items()}
    assert got == real[0][case]["launches"]
    assert all(r[case]["launches"] == got for r in real)
    last = dry[(case, 3)]
    assert {k: v["launches"] for k, v in last["kernels"].items()} == got
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        assert last[key] == dry[(case, 0)][key]
    assert last["memory"] == dry[(case, 0)]["memory"]


@pytest.mark.parametrize("case", DECODER)
def test_argument_bytes_match_jax(runs, case):
    """Rank 0's argument bytes (its shards of the params and its rows of
    the batch) are JAX's per-device argument bytes, less the terms the
    port keeps on the host: the state's step (int32) and key data
    (uint32[2]), and the probe mask (f32[1])."""
    _, dry, jax_args = runs
    host_terms = 4 + 8 + 4
    got = dry[(case, 0)]["memory"]["argument_bytes"]
    assert got == jax_args[case] - host_terms


@pytest.mark.parametrize("case", list(ranks.SERVE_CASES))
def test_serve_records_and_launches_match_a_gloo_run(runs, case):
    """A prefill or decode step's dry run, as rank 0 and as rank 3,
    records the collectives of a gloo run of the same step on those
    ranks (kinds, groups, bytes, in order) and its launches; every rank
    launches the same."""
    real, dry, _ = runs
    for rank in (0, 3):
        assert dry[(case, rank)]["records"] == real[rank][case]["records"]
    got = {k: v["launches"] for k, v in dry[(case, 0)]["kernels"].items()}
    assert got == real[0][case]["launches"]
    assert all(r[case]["launches"] == got for r in real)
    kinds = {r[0] for r in real[0][case]["records"]}
    assert "all-gather" in kinds
    if case in ("decode_serve", "decode_context", "decode_whisper"):
        assert "all-reduce" in kinds        # attend_combine's MAX and sums
    if case == "decode_moe_fsdp":
        assert "all-to-all" in kinds
    if case in ("prefill_tp", "prefill_whisper", "decode_whisper"):
        assert got.get("flash_attention")


@pytest.mark.parametrize("case", SERVE_JAX)
def test_serve_argument_bytes_match_jax(runs, case):
    """A prefill's argument bytes (rank 0's param shards and its rows of
    the tokens) and a decode's (with its cache shards, donated) are
    JAX's per-device argument bytes, less the decode's cache_len (an
    int32 the port keeps on the host)."""
    _, dry, jax_args = runs
    host = 4 if _case(case)[4] == "decode" else 0
    assert dry[(case, 0)]["memory"]["argument_bytes"] == \
        jax_args[case] - host
    if _case(case)[4] == "decode":
        mem = dry[(case, 0)]["memory"]
        assert mem["alias_bytes"] > 0 and dry[(case, 0)]["cache_len"] == 17


@pytest.mark.parametrize("split", ["data", "data_model"])
def test_attend_combine_is_the_whole_attention(runs, split):
    """Partial attentions over 12 keys split 2 ways over `data` and 4
    ways over (`data`, `model`), one of them masked, combined by
    ``attend_combine``: the whole softmax attention within f32
    rounding, on every rank."""
    real, _, _ = runs
    for r in real:
        assert r["combine"][split] < 1e-6


def test_flash_ref_lse_by_hand():
    """The plain flash's log-sum-exp, f32 [B, H, Sq], against float64 by
    hand over the visible keys (a causal window at a query offset, and
    a row that sees no key: -1e30, its scores' fill); the output with
    ``return_lse`` is bitwise the output without it, and the meta branch
    gives the lse's shape."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 4, 5, 16, generator=g)
    k = torch.randn(2, 2, 9, 16, generator=g)
    v = torch.randn(2, 2, 9, 16, generator=g)
    kw = dict(causal=True, window=3, scale=0.3, q_offset=2)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, ref.flash_attention_ref(q, k, v, **kw))
    assert lse.shape == (2, 4, 5) and lse.dtype == torch.float32
    qd, kd = q.double(), k.double().repeat_interleave(2, dim=1)
    for b in range(2):
        for h in range(4):
            for i in range(5):
                p = 2 + i
                keys = [j for j in range(9) if p - 3 < j <= p]
                s = [float(qd[b, h, i] @ kd[b, h, j]) * 0.3 for j in keys]
                want = np.log(np.sum(np.exp(s)))
                assert abs(float(lse[b, h, i]) - want) < 1e-5
    _, none = ref.flash_attention_ref(q[:, :, :1], k[:, :, :2], v[:, :, :2],
                                      causal=True, window=1, q_offset=5,
                                      return_lse=True)
    assert torch.all(none == -1e30)
    qm, km = q.to("meta"), k.to("meta")
    om, lm = ops.flash_attention(qm, km, km, return_lse=True)
    assert (om.shape, lm.shape, lm.dtype) == (qm.shape, (2, 4, 5),
                                              torch.float32)
    c0 = cost.flash_attention((2, 4, 5, 16), (2, 2, 9, 16), torch.float32)
    c1 = cost.flash_attention((2, 4, 5, 16), (2, 2, 9, 16), torch.float32,
                              lse=True)
    assert c1.bytes - c0.bytes == 4 * 2 * 4 * 5 and c1.flops == c0.flops


def test_audit_runs_a_serve_cell(capsys):
    """``audit`` of a decode cell on the 16x16 mesh under ``serve``: the
    seq plan's combine all-reduces and the vocab argmax's gather among
    its collectives."""
    from repro_torch.launch import audit
    total, ops_ = audit.audit("qwen3-4b", "decode_32k", "serve", top=5)
    assert total > 0 and {o.kind for o in ops_} >= {"all-gather",
                                                    "all-reduce"}
    assert "total per-device collective bytes" in capsys.readouterr().out


# ---------------------------------------------------------------------- #
# the accounting by hand
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,want", [
    ("all-gather", 1024 * 3 / 4), ("all-reduce", 2 * 1024 * 3 / 4),
    ("reduce-scatter", 1024 * 3), ("all-to-all", 1024 * 3 / 4)])
def test_collective_byte_conventions(kind, want):
    assert cost.bytes_moved(kind, 1024, 4) == want
    assert cost.bytes_moved(kind, 1024, 1) == 0
    recs = [cost.Collective(kind, (0, 1, 2, 3), 1024, want),
            cost.Collective(kind, (0,), 1024, 0.0)]
    total, opl = comm_analysis.collective_bytes(recs)
    assert total == want and len(opl) == 1
    assert comm_analysis.summarize(opl) == {kind: {"count": 1,
                                                   "bytes": want}}


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _twice_then_three(a):
    x = a * 2
    y = x + 1
    del x
    return y * 3


# (fn, args, donate, argument, output, alias, peak) in bytes
FOOTPRINTS = {
    # [128, 256] @ [256, 64] f32 = 32,768 bytes, then a 4-byte sum: both
    # live with the arguments at the end
    "product_and_sum": (lambda a, b: (a @ b).sum(), (_meta(128, 256),
                                                     _meta(256, 64)), (),
                        196608, 4, 0, 196608 + 32768 + 4),
    # a view is the argument's storage: nothing new
    "view": (lambda a: a.view(256, 128).t(), (_meta(128, 256),), (),
             131072, 131072, 131072, 131072),
    # an in-place write of a donated argument: its storage is the output
    "in_place_donated": (lambda a: a.add_(1), (_meta(128, 256),), (0,),
                         131072, 131072, 131072, 131072),
    # a, x and y live at once when y is made; x dies, y * 3 takes its place
    "temporaries": (_twice_then_three, (_meta(128, 256),), (),
                    131072, 131072, 0, 3 * 131072),
}


@pytest.mark.parametrize("name", list(FOOTPRINTS))
def test_meta_footprint_by_hand(name):
    fn, args, donate, arg, out, alias, peak = FOOTPRINTS[name]
    got = meta_footprint(fn, *args, donate_argnums=donate)
    assert (got["argument_bytes"], got["output_bytes"], got["alias_bytes"],
            got["peak_bytes"]) == (arg, out, alias, peak)
    assert got["temp_bytes"] == peak - (arg + out - alias)
    assert got["generated_code_bytes"] is None


def test_meta_footprint_refuses_an_undonated_write():
    with pytest.raises(ValueError, match="donate_argnums"):
        meta_footprint(lambda a: a.add_(1), _meta(4))


def test_counted_flops_of_a_full_bp_step(monkeypatch):
    """Reduced f32 qwen3-4b, full_bp, one device, 4 x 16: the counted
    FLOPs are the analytic model's (3 x (2N + attention) a token) with
    two terms the model counts otherwise: the embedding is a lookup, not
    a product (2 V d a token, x 3, out), and the tail's chunked
    attention computes every (query, key) score, causal or not (context
    S, not S / 2). So counted / model = 0.868 here, and equal to the
    corrected model exactly."""
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS["qwen3-4b"],
                                              dtype="float32"), name="tiny")
    shape = ShapeConfig("tiny_t", seq_len=16, global_batch=4, kind="train")
    monkeypatch.setitem(configs.ARCHS, "tiny", cfg)
    monkeypatch.setitem(configs.SHAPES, "tiny_t", shape)
    lane = LaneConfig(lane="full_bp")
    full = dryrun.analyze_step(cfg, shape, lane)
    model = roofline.model_flops_per_device("tiny", "tiny_t", 1, lane)
    T, S = 4 * 16, 16
    attn = 4 * cfg.num_heads * cfg.head_dim * cfg.num_layers
    want = model["total"] - 3 * T * 2 * cfg.padded_vocab * cfg.d_model \
        + 3 * T * attn * (S - S / 2)
    kernels = sum(k["flops"] for k in full["kernels"].values())
    assert full["flops"] - kernels == want
    assert 0.85 < full["flops"] / model["total"] < 0.9


def test_roofline_row_by_hand():
    """A synthetic record: compute = bf16 FLOPs at 989e12 + f32 at 67e12
    + the kernels' operation-bound time; memory = bytes at 3.35e12;
    collectives by link: ranks 0..7 share a host (NVLink, 450e9), ranks
    0 and 16 do not (NDR, 50e9)."""
    rec = {"arch": "qwen3-4b", "shape": "train_4k", "mesh": "single",
           "lane": "elastic_zo", "mesh_shape": {"data": 16, "model": 16},
           "full": {"flops": 3e15, "flops_by_dtype": {"bfloat16": 1.978e15,
                                                      "float32": 6.7e12},
                    "bytes_accessed": 6.7e12, "collective_bytes": 2e11,
                    "collective_groups": [
                        {"kind": "all-reduce", "ranks": list(range(8)),
                         "count": 3, "bytes": 9e10},
                        {"kind": "all-gather", "ranks": [0, 16],
                         "count": 1, "bytes": 1e10}],
                    "kernels": {"zo_perturb": {"ops_bound_s": 0.25}},
                    "memory": {"peak_bytes": 1, "temp_bytes": 2,
                               "argument_bytes": 3}}}
    row = roofline.row_of(rec)
    assert row["t_compute_s"] == pytest.approx(2.0 + 0.1 + 0.25, rel=1e-12)
    assert row["t_memory_s"] == pytest.approx(2.0, rel=1e-12)
    assert row["t_nvlink_s"] == pytest.approx(0.2, rel=1e-12)
    assert row["t_ndr_s"] == pytest.approx(0.2, rel=1e-12)
    assert row["t_collective_s"] == pytest.approx(0.4, rel=1e-12)
    assert row["bottleneck"] == "compute"
    model = roofline.model_flops_per_device("qwen3-4b", "train_4k", 256)
    assert row["model_flops_dev"] == model["per_device"]
    assert row["useful_flops_ratio"] == pytest.approx(
        model["per_device"] / 3e15, rel=1e-12)
    assert row["roofline_fraction"] == pytest.approx(
        model["per_device"] / 989e12 / 2.35, rel=1e-12)
    rec["full"]["flops"] = model["per_device"] / 2       # under-counted
    assert roofline.row_of(rec)["useful_flops_ratio"] == pytest.approx(
        2.0, rel=1e-12)                                 # shown, not capped
    assert roofline.link_of(range(8, 16)) == "nvlink"
    assert roofline.link_of([7, 8]) == "ndr"


# ---------------------------------------------------------------------- #
# the kernels' meta branches
# ---------------------------------------------------------------------- #
def test_meta_branches_give_the_kernels_outputs():
    from repro_torch.core.prng import IndexMap
    q = torch.empty(2, 6, 4, 16, device="meta",
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.empty(2, 6, 2, 16, device="meta",
                    dtype=torch.bfloat16).transpose(1, 2)
    o = ops.flash_attention(q, k, k, q_offset=3)
    assert (o.shape, o.dtype, o.stride(), o.device.type) == (
        q.shape, q.dtype, q.stride(), "meta")
    theta = torch.empty(3, 8, device="meta", dtype=torch.bfloat16)
    seed = torch.empty(1, dtype=torch.int32, device="meta")
    for index in (None, IndexMap(100, ((3, 16), (8, 1)))):
        p = ops.zo_perturb(theta, seed, 5, 1e-3, index=index)
        assert (p.shape, p.dtype, p.device.type) == (theta.shape,
                                                     theta.dtype, "meta")
        assert p.untyped_storage() is not theta.untyped_storage()
    seeds = torch.empty(1, 2, dtype=torch.int32, device="meta")
    coeffs = torch.empty(1, 2, dtype=torch.float32, device="meta")
    r = ops.zo_fused_replay(theta, seeds, coeffs, 5)
    assert (r.shape, r.dtype) == (theta.shape, theta.dtype)
    assert ops.zo_fused_replay(theta, seeds, coeffs, 5, out=theta) is theta
    with cost.counting() as counter:
        ops.zo_perturb(theta, seed, 5, 1e-3)
        ops.zo_fused_replay(theta, seeds, coeffs, 5, out=theta)
        ops.flash_attention(q, k, k)
    assert counter.launch_counts() == {"zo_perturb": 1, "zo_fused_replay": 1,
                                       "flash_attention": 1}
    assert counter.launches[1].cost == cost.zo_fused_replay(24, torch.bfloat16,
                                                            2)


OTHER_KERNELS = {
    "paged_attention_step": lambda m: ops.paged_attention_step(
        m(2, 2, 1, 16), m(2, 2, 16), m(2, 2, 16), m(4, 4, 2, 16),
        m(4, 4, 2, 16), m(2, 2, dtype=torch.int32), m(2, dtype=torch.int32),
        scale=0.25),
    "topk_topp_mask": lambda m: ops.topk_topp_mask(
        m(2, 8), m(2, dtype=torch.int32), m(2)),
    "int8_matmul": lambda m: ops.int8_matmul(m(4, 8, dtype=torch.int8),
                                             m(8, 4, dtype=torch.int8)),
    "int8_perturb": lambda m: ops.int8_perturb_leaves(
        [m(8, dtype=torch.int8)], m(1, dtype=torch.int32), [1], 1, 3, 0.33),
    "zo_fused_replay_int8": lambda m: ops.zo_fused_replay_int8_leaves(
        [m(8, dtype=torch.int8)], m(1, 1, dtype=torch.int32),
        m(1, 1, dtype=torch.int32), [1], 3, 0.33, 1),
}


@pytest.mark.parametrize("name", list(OTHER_KERNELS))
def test_other_kernels_raise_for_meta(name):
    def m(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="no path for meta"):
        OTHER_KERNELS[name](m)


def test_cost_bounds_are_the_kernel_table_s():
    """The bounds of PERF.md's kernel table at its shapes: rows 1 and 3
    at the 871,628,800-element bf16 leaf, row 6 at seq 4096."""
    n = 871628800
    assert cost.zo_perturb(n, torch.bfloat16).bound_s * 1e3 == \
        pytest.approx(3.0875, abs=5e-5)
    assert cost.zo_fused_replay(n, torch.bfloat16).bound_s * 1e3 == \
        pytest.approx(3.8463, abs=5e-5)
    c = cost.flash_attention((1, 32, 4096, 128), (1, 8, 4096, 128),
                             torch.bfloat16)
    assert (round(c.bound_s * 1e3, 3), c.bound_by) == (0.139, "operations")


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def test_dryrun_main_writes_the_reference_keys(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(configs.ARCHS, "qwen3-4b", configs.reduced(
        configs.ARCHS["qwen3-4b"]))
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-4b__train_4k__single.json")
                     .read_text())
    assert {"arch", "shape", "mesh", "strategy", "mesh_shape", "lane",
            "status", "full", "attn_plan", "moe_plan",
            "elapsed_s"} <= set(rec)
    assert rec["status"] == "ok" and rec["mesh_shape"] == {"data": 16,
                                                           "model": 16}
    full = rec["full"]
    assert {"flops", "bytes_accessed", "memory", "collective_bytes",
            "collectives", "kernels"} <= set(full)
    assert set(full["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_bytes", "generated_code_bytes"}
    assert full["collective_bytes"] > 0 and full["flops"] > 0
    assert roofline.row_of(rec)["status"] == "ok"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "prefill_32k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-4b__prefill_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["full"]["flops"] > 0
    assert rec["full"]["kernels"]["flash_attention"]["launches"] > 0
    assert roofline.row_of(rec)["status"] == "ok"
    assert "OK   qwen3-4b x prefill_32k" in capsys.readouterr().out
