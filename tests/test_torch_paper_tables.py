"""Port parity: the paper-table harness and its runner against the reference.

``repro_torch.benchmarks.paper_tables`` against ``benchmarks/paper_tables``:
the analytic memory tables exactly, the sign-agreement rate and count on
the same numpy stream, the lane configurations field by field; then the
runner ``python -m repro_torch.benchmarks.run`` on the CPU (schema, the
measured rows None, exit codes), the precision flags its entry points
set, and the rule that the port imports neither JAX nor the JAX package.
"""
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

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
    assert len(files) == 10
    for f in files:
        assert not _IMPORT.findall(f.read_text()), f
    assert not _IMPORT.findall("\n".join(
        p.read_text() for p in pkg.rglob("*.py")))
