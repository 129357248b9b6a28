"""Port parity: the paper-table harness and its runner against the reference.

``repro_torch.benchmarks.paper_tables`` against ``benchmarks/paper_tables``:
the analytic memory tables exactly, the sign-agreement rate and count on
the same numpy stream, the lane configurations field by field; then the
runner ``python -m repro_torch.benchmarks.run`` on the CPU (schema, the
measured rows None, exit codes), the precision flags its entry points
set, their deterministic algorithms and a Table 2 that repeats bitwise,
and the rule that the port imports neither JAX nor the JAX package.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from benchmarks import paper_tables as jpt  # noqa: E402
from repro_torch.benchmarks import paper_tables as pt  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("batch", [1, 32, 256])
def test_lenet_memory_table_equals_reference(batch):
    assert pt.lenet_memory_table(batch) == jpt.lenet_memory_table(batch)


@pytest.mark.parametrize("batch,num_points", [(32, 1024), (8, 256)])
def test_pointnet_memory_table_equals_reference(batch, num_points):
    got = pt.pointnet_memory_table(batch, num_points)
    assert got == jpt.pointnet_memory_table(batch, num_points)
    if (batch, num_points) == (32, 1024):
        ratio = got["full_bp"]["fp32_bytes"] / got["full_zo"]["fp32_bytes"]
        assert round(ratio, 4) == 1.9993


def test_sign_agreement_equals_reference():
    assert pt.sign_agreement(trials=50, device="cpu") == \
        jpt.sign_agreement(trials=50)


def test_lenet_lane_configs_equal_reference():
    for steps in (150, 600):
        got = pt.lenet_lane_configs(steps=steps, probes=2)
        want = jpt.lenet_lane_configs(steps=steps, probes=2)
        assert [(n, dataclasses.asdict(lc), c) for n, lc, c in got] == \
            [(n, dataclasses.asdict(lc), c) for n, lc, c in want]


def test_pointnet_lane_configs_equal_reference(monkeypatch):
    """The reference builds PointNet's lanes inline in pointnet_lanes:
    capture what it hands make_elastic_step (zero steps, tiny data)."""
    seen = []

    def capture(loss_fn, lane, partition_fn=None):
        seen.append(lane)
        return lambda state, batch, mask: (state, {})

    monkeypatch.setattr(jpt, "make_elastic_step", capture)
    for steps in (100, 400):
        seen.clear()
        jpt.pointnet_lanes(steps=0, train_n=4, test_n=4, num_points=8)
        want = [dataclasses.asdict(lc) for lc in seen]
        got = pt.pointnet_lane_configs(steps)
        # the reference's lr_decay_every is max(steps // 10, 1) of its
        # own ``steps`` argument (0 here): compare the rest exactly
        for g, w in zip(got, want):
            gd = dataclasses.asdict(g[1])
            assert gd.pop("lr_decay_every") == max(steps // 10, 1)
            w.pop("lr_decay_every")
            assert gd == w
        assert [c for _, _, c in got] == [8, 6, 7, 0]
        assert [n for n, _, _ in got] == ["full_zo", "zo_feat_cls2",
                                          "zo_feat_cls1", "full_bp"]


def test_pointnet_lanes_match_reference_accuracy():
    """The slice as a whole: PointNet's four lanes through both harnesses
    at full width on a tiny set (2 steps of 4 clouds of 16 points, 16
    test clouds) give the same test accuracy."""
    kw = dict(steps=2, batch=4, train_n=8, test_n=16, num_points=16)
    want = jpt.pointnet_lanes(**kw)
    got = pt.pointnet_lanes(**kw, device="cpu")
    assert {k: v.acc for k, v in got.items()} == \
        {k: v[0] for k, v in want.items()}


def test_measured_memory_is_none_on_the_cpu():
    assert pt.lenet_measured_memory(device="cpu") is None
    assert pt.lenet_int8_measured_memory(device="cpu") is None


def test_entry_points_compute_in_f32_and_restore_the_flags(monkeypatch):
    """TF32 is off inside every harness entry point (the reference
    computes in f32) and the caller's flags come back on return."""
    flags = []
    loss = pt.lenet.lenet5_loss

    def spy(params, batch):
        flags.append((torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
        return loss(params, batch)

    monkeypatch.setattr(pt.lenet, "lenet5_loss", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    pt.lenet_lanes(steps=1, batch=4, train_n=8, test_n=8, device="cpu",
                   lanes=["full_bp"])
    assert flags and set(flags) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def _spy_steps(monkeypatch, module, name, seen):
    """Wrap ``module.name`` (it makes a train step) so that every step records
    whether deterministic algorithms are on while it runs."""
    make = getattr(module, name)

    def spy(*a, **k):
        step = make(*a, **k)

        def wrapped(state, batch, mask):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return step(state, batch, mask)
        return wrapped
    monkeypatch.setattr(module, name, spy)


def test_training_entry_points_run_deterministic_algorithms(monkeypatch):
    """Every harness entry point that trains (Table 1's fp32, PointNet and
    int8 lanes, Table 2's pretraining) steps under
    ``core/api.py::deterministic``, and the caller's setting comes back."""
    from repro_torch.train import paper_lanes
    seen = []
    _spy_steps(monkeypatch, pt, "make_elastic_step", seen)
    _spy_steps(monkeypatch, paper_lanes, "make_int8_elastic_step", seen)
    pt.lenet_lanes(steps=1, batch=4, train_n=8, test_n=8, device="cpu")
    pt.pointnet_lanes(steps=1, batch=2, train_n=4, test_n=4, num_points=8,
                      device="cpu")
    pt.lenet_pretrained(1, batch=4, device="cpu")
    pt.lenet_int8_lanes(steps=1, batch=4, train_n=8, test_n=8,
                        device="cpu")
    assert len(seen) == 4 + 4 + 1 + 3 and all(seen)
    assert not torch.are_deterministic_algorithms_enabled()


def test_importing_the_port_sets_the_cublas_workspace():
    """Importing ``repro_torch`` sets ``CUBLAS_WORKSPACE_CONFIG``, which
    deterministic cuBLAS products need before the process's first
    product, and keeps a value the caller set."""
    code = ("import os, repro_torch; "
            "print(os.environ['CUBLAS_WORKSPACE_CONFIG'])")
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["PYTHONPATH"] = str(ROOT / "src")
    for given, want in ((None, ":4096:8"), (":16:8", ":16:8")):
        if given:
            env["CUBLAS_WORKSPACE_CONFIG"] = given
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == want


def test_table2_repeats_bitwise():
    """Table 2's pretraining and then its full_zo lane on rotated glyphs,
    twice in one process, give bitwise equal parameters."""
    runs = []
    for _ in range(2):
        pre = pt.lenet_pretrained(4, batch=8, device="cpu")
        res = pt.lenet_lanes(steps=3, batch=8, train_n=16, test_n=16,
                             rotate=30, init_params=pre, device="cpu",
                             lanes=["full_zo"])
        runs.append([pre, res["full_zo"].state.params])
    for a, b in zip(*runs):
        for (path, x), (_, y) in zip(pt.zo.leaves_with_path(a),
                                     pt.zo.leaves_with_path(b)):
            assert torch.equal(x, y), path


def test_steptime_breakdown_has_the_reference_phases():
    got = pt.steptime_breakdown(batch=4, iters=1, device="cpu")
    assert set(got) == {"fp32_forward_us", "fp32_perturb_us",
                        "fp32_update_us", "fp32_bp_tail_us",
                        "int8_forward_us", "int8_perturb_us"}
    assert all(v > 0 for v in got.values())


def test_run_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.benchmarks.run --section signagree
    --section memory`` on the CPU: exits 0, writes the bench_util schema
    with the recorder's sections, the reference's analytic numbers, and
    None for every measured row."""
    out = tmp_path / "BENCH_torch_paper.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--section",
         "signagree", "--section", "memory", "--device", "cpu", "--out",
         str(out)], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    doc = json.loads(out.read_text())
    assert doc["name"] == "torch_paper"
    assert doc["config"]["sections"] == "signagree,memory"
    assert doc["config"]["device"] == "cpu" and "card" not in doc["config"]
    assert {"timings", "counters", "memory"} <= set(doc)
    assert set(doc["timings"]["spans"]) == {"bench/signagree",
                                            "bench/memory"}
    m = doc["metrics"]
    committed = json.loads((ROOT / "BENCH_paper.json").read_text())["metrics"]
    for k in ("int_loss_sign_agreement", "int_loss_sign_trials",
              "memory_lenet_b32_bp_over_zo", "memory_lenet_b256_int8_saving",
              "memory_pointnet_b32_bp_over_zo"):
        assert m[k] == committed[k], k
    measured = [k for k in m if k.startswith(("memory_measured_",
                                              "memory_resid_"))]
    assert len(measured) == 17 and all(m[k] is None for k in measured)
    assert all(v["peak_bytes"] is None
               for v in doc["memory"]["lanes"].values())
    assert all(isinstance(v, (int, float, str)) or v is None
               for v in m.values())


def test_run_exits_nonzero_when_a_section_fails(tmp_path, monkeypatch):
    def boom(fast, device):
        raise RuntimeError("section failed")

    monkeypatch.setitem(bench_run.SECTIONS, "signagree", boom)
    out = tmp_path / "b.json"
    rc = bench_run.main(["--section", "signagree", "--section", "memory",
                         "--device", "cpu", "--out", str(out)])
    assert rc == 1
    doc = json.loads(out.read_text())
    assert doc["metrics"]["signagree_error"] == "RuntimeError:section failed"
    assert doc["config"]["sections"] == "memory"


def test_run_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_run.main(["--section", "signagree"])


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\s|\.|$)",
                     re.MULTILINE)


def test_slice_sources_import_neither_jax_nor_repro():
    """The new modules and chip_smoke.py never import JAX or the JAX
    package (tests/test_torch_serve.py also imports every module and
    checks sys.modules)."""
    pkg = ROOT / "src" / "repro_torch"
    files = [pkg / "models" / "pointnet.py", ROOT / "chip_smoke.py"] + \
        sorted((pkg / "benchmarks").glob("*.py")) + \
        sorted((pkg / "obs").glob("*.py"))
    assert len(files) == 11
    for f in files:
        assert not _IMPORT.findall(f.read_text()), f
    assert not _IMPORT.findall("\n".join(
        p.read_text() for p in pkg.rglob("*.py")))
