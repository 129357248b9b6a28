"""reprolint for the port (src/repro_torch/analysis): fixtures, engine
mechanics, the kernel seam, the meta-gate, the CLI, and parity with the
JAX package's checker (src/repro/analysis) on the same inputs.

* every rule id has a red and a green fixture, mini-trees written to
  ``tmp_path`` from the strings below: red must yield a finding of that
  rule (and the CLI exits 1), green must be wholly clean (exit 0);
* engine mechanics: suppression coverage, reasonless and stale allows,
  the allowlist (the port reads only ``.reprolint_torch.json``), parse
  errors as findings;
* kernel-dispatch-complete on a copy of the port's real seam: all eight
  ``csrc/*.cu`` kernels are found, and deleting any one kernel's source,
  wrapper, ops entry, ref or card test fires the rule;
* the meta-gate: the checker over this repository is clean, with
  suppressions in use, and its CLI runs with torch, jax and the JAX
  package blocked;
* parity: the suppression parser, the four determinism rules, the wire
  doc and struct sizes and the catalog parser agree with the JAX
  package's, and the port's catalog is JAX's up to the named delta.

Stdlib and pytest only. Section signs in the fixtures are written as
escapes, so that this file's raw text cites no section docs/design.md
lacks.
"""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import project as jax_project
from repro.analysis import run_analysis as jax_run_analysis
from repro.analysis.rules import determinism as jax_determinism
from repro.analysis.rules import docs_sync as jax_docs_sync
from repro_torch.analysis import (ALL_RULES, META_RULES, AllowEntry,
                                  build_project, load_allowlist,
                                  rules_by_id, run_analysis)
from repro_torch.analysis import cli, project as torch_project
from repro_torch.analysis.core import BAD_SUPPRESSION, STALE_SUPPRESSION
from repro_torch.analysis.rules import determinism, docs_sync
from repro_torch.analysis.rules.kernels import (KernelDispatchComplete,
                                                kernel_inventory)

REPO_ROOT = Path(__file__).resolve().parents[1]
LIB = "src/repro_torch"
SECT = "\u00a7"

# ------------------------------------------------------------------ #
# the mini kernel seam: one csrc source, its wrapper, ops, ref, card test
# ------------------------------------------------------------------ #
SEAM = {
    f"{LIB}/csrc/add.cu":
        'extern "C" int add_f32(const float* x, float* y, int n) '
        "{ return 0; }\n",
    f"{LIB}/kernels/add.py": (
        "from . import _build\n"
        "\n\n"
        "def add(x, y, alpha=1.0):\n"
        '    fn = _build.function("add", "add_f32", None)\n'
        "    return fn(x, y, alpha)\n"),
    f"{LIB}/kernels/ops.py": (
        "from . import add as _add\n"
        "from . import ref\n"
        "\n\n"
        "def add(x, y, alpha=1.0):\n"
        "    if x.is_cuda:\n"
        "        return _add.add(x, y, alpha)\n"
        '    if x.device.type == "cpu":\n'
        "        return ref.add_ref(x, y, alpha=alpha)\n"
        "    raise ValueError(x.device)\n"),
    f"{LIB}/kernels/ref.py": (
        "def add_ref(x, y, *, alpha=1.0):\n"
        "    return x + alpha * y\n"),
    "tests/test_torch_cuda.py": '"""The card test of the add kernel."""\n',
}

CATALOG_ROW = ("# obs\n\n## Metric catalog\n\nCounters:\n\n"
               "| name | meaning |\n|---|---|\n"
               "| `train.tokens` | trained tokens |\n")

WIRE_DOC = """# Fleet

## Ledger record format

```
fp32 ('R'):
R | step u32 | worker u8 | m u8 | loss f32          11 B header
  | m x (probe seed u64, loss-diff f32)             {fp32} B per probe

int8 ('I'):
I | step u32 | worker u8 | m u8 | loss f32          11 B header
  | m x (probe seed u64, ternary g i8)               9 B per probe
```

| lane | probe entry | ZO part of a record |
|---|---|---|
| fp32 | **{fp32} B** (u64 seed + f32 d) | `11 + {fp32}m` B |
| int8 | **9 B** (u64 seed + i8 g) | `11 + 9m` B |
"""

LEDGER_SRC = ('import struct\n\n'
              '_REC_HDR = struct.Struct("<BIBBf")\n'
              '_PROBE = struct.Struct("<Qf")\n'
              '_PROBE8 = struct.Struct("<Qb")\n')


def _edit(files, path, old, new):
    out = dict(files)
    if old not in out[path]:
        raise KeyError(f"{old!r} not in {path}")
    out[path] = out[path].replace(old, new)
    return out


# rule id -> (red tree, green tree); each tree is {repo path: text}
FIXTURES = {
    "no-invariant-assert": (
        {f"{LIB}/examples/demo.py":
            "def main(acc):\n    assert acc > 0.5, 'chance'\n"},
        {f"{LIB}/examples/demo.py":
            "def main(acc):\n    if not acc > 0.5:\n"
            "        raise RuntimeError('chance')\n"}),
    "no-builtin-hash": (
        {f"{LIB}/example.py": "def salt(name):\n    return hash(name)\n"},
        {f"{LIB}/example.py": "import zlib\n\n\ndef salt(name):\n"
                              "    return zlib.crc32(name.encode())\n"}),
    "monotonic-clock": (
        {f"{LIB}/example.py": "import time\n\nt0 = time.time()\n"},
        {f"{LIB}/example.py": "import time\n\nt0 = time.monotonic()\n"}),
    "kernel-dispatch-complete": (
        _edit(SEAM, f"{LIB}/kernels/ops.py", "if x.is_cuda:", "if x.is_meta:"),
        SEAM),
    "design-cite-resolves": (
        {"docs/design.md": f"# Design\n\n## {SECT}1 Intro\n",
         f"{LIB}/example.py": f'"""See docs/design.md {SECT}2."""\n'},
        {"docs/design.md": f"# Design\n\n## {SECT}1 Intro\n",
         f"{LIB}/example.py": f'"""See docs/design.md {SECT}1."""\n'}),
    "metric-catalog-sync": (
        {f"{LIB}/example.py": "def f(rec):\n"
                              "    rec.counter('train.tokens').inc(1)\n"
                              "    rec.gauge('train.phantom').set(1)\n",
         "docs/torch_observability.md": CATALOG_ROW},
        {f"{LIB}/example.py": "def f(rec):\n"
                              "    rec.counter('train.tokens').inc(1)\n",
         "docs/torch_observability.md": CATALOG_ROW}),
    "nondeterministic-iteration": (
        {f"{LIB}/fleet/gossip.py":
            "def bye(transport, peers):\n"
            "    dead = {p for p in peers if not transport.alive(p)}\n"
            "    for p in dead:\n"
            "        transport.send(p, b'bye')\n"},
        {f"{LIB}/fleet/gossip.py":
            "def bye(transport, peers):\n"
            "    dead = {p for p in peers if not transport.alive(p)}\n"
            "    for p in sorted(dead):\n"
            "        transport.send(p, b'bye')\n"}),
    "wire-bytes-consistent": (
        {f"{LIB}/fleet/ledger.py": LEDGER_SRC,
         "docs/fleet.md": WIRE_DOC.format(fp32=16)},
        {f"{LIB}/fleet/ledger.py": LEDGER_SRC,
         "docs/fleet.md": WIRE_DOC.format(fp32=12)}),
    BAD_SUPPRESSION: (
        {f"{LIB}/example.py":
            "import time\n\nt = time.time()  # reprolint: allow(monotonic-clock)\n"},
        {f"{LIB}/example.py":
            "import time\n\n"
            "t = time.time()  # reprolint: allow(monotonic-clock) -- a stamp\n"}),
    STALE_SUPPRESSION: (
        {f"{LIB}/example.py":
            "def f():\n"
            "    # reprolint: allow(no-builtin-hash) -- nothing hashes here\n"
            "    return 1\n"},
        {f"{LIB}/example.py": "def f():\n    return 1\n"}),
}


def _tree(root: Path, files) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text, encoding="utf-8")
    return root


def _run(root: Path, rules=ALL_RULES, allowlist=()):
    return run_analysis(root, rules, allowlist=list(allowlist))


def _lines(report):
    return [f"{f.location()}: [{f.rule}] {f.message}" for f in report.findings]


# ------------------------------------------------------------------ #
# red/green fixtures: every rule demonstrably fires and passes
# ------------------------------------------------------------------ #
def test_every_rule_has_a_fixture():
    meta_ids = {r.id for r in META_RULES}
    assert meta_ids == {BAD_SUPPRESSION, STALE_SUPPRESSION}
    assert set(FIXTURES) == {r.id for r in ALL_RULES} | meta_ids
    assert len(FIXTURES) == 10


@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_red_fixture_fires(rule_id, tmp_path, capsys):
    root = _tree(tmp_path, FIXTURES[rule_id][0])
    fired = {f.rule for f in _run(root).findings}
    assert rule_id in fired, f"red fixture for {rule_id} produced {fired}"
    assert cli.main(["--root", str(root)]) == 1
    assert f"[{rule_id}]" in capsys.readouterr().out


@pytest.mark.parametrize("rule_id", sorted(FIXTURES))
def test_green_fixture_clean(rule_id, tmp_path, capsys):
    root = _tree(tmp_path, FIXTURES[rule_id][1])
    assert _run(root).clean, _lines(_run(root))
    assert cli.main(["--root", str(root)]) == 0


# ------------------------------------------------------------------ #
# engine mechanics
# ------------------------------------------------------------------ #
def _mini_tree(tmp_path: Path, source: str) -> Path:
    return _tree(tmp_path, {f"{LIB}/example.py": source})


def test_trailing_suppression_covers_its_own_line(tmp_path):
    root = _mini_tree(tmp_path, (
        "import time\n"
        "t = time.time()  # reprolint: allow(monotonic-clock) -- stamp\n"))
    report = _run(root)
    assert report.clean
    assert [f.rule for f in report.suppressed] == ["monotonic-clock"]


def test_own_line_suppression_covers_next_line_only(tmp_path):
    root = _mini_tree(tmp_path, (
        "import time\n"
        "# reprolint: allow(monotonic-clock) -- stamp\n"
        "a = time.time()\n"
        "b = time.time()\n"))
    report = _run(root)
    assert [(f.rule, f.line) for f in report.findings] == [
        ("monotonic-clock", 4)]


def test_reasonless_suppression_suppresses_nothing(tmp_path):
    root = _mini_tree(tmp_path, (
        "import time\n"
        "# reprolint: allow(monotonic-clock)\n"
        "t = time.time()\n"))
    rules = sorted(f.rule for f in _run(root).findings)
    assert rules == [BAD_SUPPRESSION, "monotonic-clock"]


def test_suppression_for_wrong_rule_is_stale(tmp_path):
    root = _mini_tree(tmp_path, (
        "import time\n"
        "# reprolint: allow(no-builtin-hash) -- wrong rule id\n"
        "t = time.time()\n"))
    rules = sorted(f.rule for f in _run(root).findings)
    assert rules == ["monotonic-clock", STALE_SUPPRESSION]


def test_allow_inside_a_string_is_not_a_suppression(tmp_path):
    root = _mini_tree(tmp_path, (
        "import time\n"
        "NOTE = '# reprolint: allow(monotonic-clock) -- in a string'\n"
        "t = time.time()\n"))
    report = _run(root)
    assert [f.rule for f in report.findings] == ["monotonic-clock"]


def test_allowlist_discharges_and_goes_stale(tmp_path):
    root = _mini_tree(tmp_path, "import time\nt = time.time()\n")
    entry = AllowEntry(rule="monotonic-clock", path=f"{LIB}/example.py",
                       reason="fixture")
    report = _run(root, allowlist=[entry])
    assert report.clean and len(report.suppressed) == 1

    stale = AllowEntry(rule="no-builtin-hash", path=f"{LIB}/example.py",
                       reason="matches nothing")
    report = _run(root, allowlist=[entry, stale])
    assert [f.rule for f in report.findings] == [STALE_SUPPRESSION]
    assert report.findings[0].path == ".reprolint_torch.json"


def test_allowlist_is_the_ports_own_file(tmp_path):
    root = _mini_tree(tmp_path, "import time\nt = time.time()\n")
    entry = {"rule": "monotonic-clock", "path": f"{LIB}/example.py",
             "contains": "time.time()", "reason": "fixture"}
    (root / ".reprolint.json").write_text(json.dumps({"allow": [entry]}))
    assert load_allowlist(root) == []
    assert [f.rule for f in run_analysis(root, ALL_RULES).findings] == [
        "monotonic-clock"]
    (root / ".reprolint_torch.json").write_text(json.dumps({"allow": [entry]}))
    assert [e.rule for e in load_allowlist(root)] == ["monotonic-clock"]
    assert run_analysis(root, ALL_RULES).clean


def test_allowlist_loader_rejects_missing_reason(tmp_path):
    (tmp_path / ".reprolint_torch.json").write_text(json.dumps(
        {"allow": [{"rule": "no-builtin-hash", "path": "x.py"}]}))
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(tmp_path)


def test_allowlist_loader_rejects_empty_reason(tmp_path):
    (tmp_path / ".reprolint_torch.json").write_text(json.dumps(
        {"allow": [{"rule": "r", "path": "p", "reason": "  "}]}))
    with pytest.raises(ValueError, match="empty reason"):
        load_allowlist(tmp_path)
    assert cli.main(["--root", str(tmp_path)]) == 2


def test_parse_error_is_a_finding(tmp_path):
    root = _mini_tree(tmp_path, "def broken(:\n")
    assert [f.rule for f in _run(root).findings] == ["parse-error"]


def test_project_scans_the_port_only(tmp_path):
    root = _tree(tmp_path, {
        f"{LIB}/a.py": "", f"{LIB}/__pycache__/b.py": "",
        f"{LIB}/csrc/_build/c.py": "", f"{LIB}/csrc/k.cu": "k",
        f"{LIB}/csrc/h.cuh": "h", f"{LIB}/csrc/_build/k.cu": "built",
        "src/repro/d.py": "", "tests/test_torch_e.py": "",
        "tests/torch_f.py": "", "tests/test_g.py": "", "chip_smoke.py": "",
        "benchmarks/h.py": "", "docs/x.md": "x"})
    project = build_project(root)
    assert sorted(project.files) == [
        "chip_smoke.py", f"{LIB}/a.py", "tests/test_torch_e.py",
        "tests/torch_f.py"]
    assert sorted(project.cuda) == [f"{LIB}/csrc/h.cuh", f"{LIB}/csrc/k.cu"]
    assert project.docs == {"docs/x.md": "x"}


def test_rules_by_id_covers_all_rules():
    by_id = rules_by_id()
    assert len(by_id) == 8
    for rule in ALL_RULES:
        assert by_id[rule.id] is rule


# ------------------------------------------------------------------ #
# kernel-dispatch-complete on the mini seam
# ------------------------------------------------------------------ #
OPS, REF, WRAP = (f"{LIB}/kernels/ops.py", f"{LIB}/kernels/ref.py",
                  f"{LIB}/kernels/add.py")
# case -> (tree, a fragment of the finding's message)
SEAM_RED = {
    "stem not a literal": (
        _edit(SEAM, WRAP, '_build.function("add",', "_build.function(NAME,"),
        "stem that is not a literal"),
    "stem with no source": (
        _edit(SEAM, WRAP, '"add", "add_f32"', '"sub", "add_f32"'),
        f"has no {LIB}/csrc/sub.cu"),
    "symbol not in the source": (
        _edit(SEAM, WRAP, '"add_f32"', '"add_f64"'), "C symbol `add_f64`"),
    "two wrapper modules": (
        {**SEAM, f"{LIB}/kernels/add2.py":
         SEAM[WRAP].replace("def add(", "def add2(")},
        "loaded by 2 modules"),
    "no wrapper module": (
        _edit(SEAM, WRAP, '_build.function("add", "add_f32", None)', "None"),
        "no module under kernels/ loads `add`"),
    "no public wrapper": (
        _edit(SEAM, WRAP, "def add(", "def _add("), "no public function"),
    "wrapper called outside the CUDA branch": (
        FIXTURES["kernel-dispatch-complete"][0], "only outside it"),
    "no ops entry": (
        _edit(SEAM, OPS, "_add.add(x, y, alpha)", "None"),
        "called on no ops.py entry"),
    "positional drift": (
        _edit(SEAM, OPS, "def add(x, y, alpha=1.0):",
              "def add(x, y, alpha=1.0, out=None):"),
        "positional signature"),
    "two refs": (
        _edit(SEAM, OPS, "raise ValueError(x.device)",
              "return ref.other_ref(x)"),
        "exactly one ref.<fn> on the CPU (found ['add_ref', 'other_ref'])"),
    "no ref": (
        _edit(SEAM, OPS, "return ref.add_ref(x, y, alpha=alpha)",
              "return x + y"),
        "exactly one ref.<fn> on the CPU (found none)"),
    "ref missing from ref.py": (
        _edit(SEAM, OPS, "ref.add_ref(", "ref.mul_ref("),
        "does not exist in kernels/ref.py"),
    "too many positionals": (
        _edit(SEAM, OPS, "ref.add_ref(x, y, alpha=alpha)",
              "ref.add_ref(x, y, alpha)"),
        "3 positional arguments, where it takes 2"),
    "unknown keyword": (
        _edit(SEAM, OPS, "alpha=alpha)", "beta=alpha)"), "no parameter `beta`"),
    "keyword given twice": (
        _edit(SEAM, OPS, "ref.add_ref(x, y, alpha=alpha)",
              "ref.add_ref(x, y, y=alpha)"),
        "`y` given twice"),
    "required parameter not given": (
        _edit(SEAM, OPS, "ref.add_ref(x, y, alpha=alpha)", "ref.add_ref(x)"),
        "['y'] not given"),
    "orphan ref": (
        _edit(SEAM, REF, "    return x + alpha * y\n",
              "    return x + alpha * y\n\n\n"
              "def sub_ref(x, y):\n    return x - y\n"),
        "ref.sub_ref is called from no ops.py function"),
    "no card test": (
        {**SEAM, "tests/test_torch_cuda.py": '"""Cards."""\n'},
        "has no card test"),
    "no source at all": (
        {k: v for k, v in SEAM.items() if not k.endswith(".cu")},
        f"has no {LIB}/csrc/add.cu"),
}
SEAM_GREEN = {
    "as written": SEAM,
    "a **kw splat binds": _edit(SEAM, OPS, "alpha=alpha)",
                                "**dict(alpha=alpha))"),
    "an elif CUDA branch": _edit(
        SEAM, OPS,
        "    if x.is_cuda:\n        return _add.add(x, y, alpha)\n"
        '    if x.device.type == "cpu":\n'
        "        return ref.add_ref(x, y, alpha=alpha)\n",
        '    if x.device.type == "cpu":\n'
        "        return ref.add_ref(x, y, alpha=alpha)\n"
        '    elif x.device.type == "cuda":\n'
        "        return _add.add(x, y, alpha)\n"),
    "a symbol read off the loaded library": _edit(
        SEAM, WRAP, '    fn = _build.function("add", "add_f32", None)\n',
        '    fn = _build.load("add").add_f32\n'),
    "a private helper reaches the load": _edit(
        SEAM, WRAP,
        'def add(x, y, alpha=1.0):\n    fn = _build.function("add", '
        '"add_f32", None)\n',
        'def _fn():\n    return _build.function("add", "add_f32", None)\n'
        "\n\ndef add(x, y, alpha=1.0):\n    fn = _fn()\n"),
}
KERNEL_RULE = [KernelDispatchComplete()]


@pytest.mark.parametrize("case", sorted(SEAM_RED))
def test_kernel_rule_fires_on_a_broken_seam(case, tmp_path):
    files, why = SEAM_RED[case]
    report = _run(_tree(tmp_path, files), KERNEL_RULE)
    assert {f.rule for f in report.findings} == {KernelDispatchComplete.id}
    assert any(why in f.message for f in report.findings), _lines(report)


@pytest.mark.parametrize("case", sorted(SEAM_GREEN))
def test_kernel_rule_holds_on_a_whole_seam(case, tmp_path):
    report = _run(_tree(tmp_path, SEAM_GREEN[case]), KERNEL_RULE)
    assert report.clean, _lines(report)


# ------------------------------------------------------------------ #
# kernel-dispatch-complete on a copy of the port's real seam
# ------------------------------------------------------------------ #
KERNEL_FILES = ("src/repro_torch/csrc/*.cu", "src/repro_torch/csrc/*.cuh",
                "src/repro_torch/kernels/*.py", "tests/test_torch_cuda.py")
STEMS = ("flash_attn", "int8_matmul", "int8_perturb", "paged_attn",
         "topk_mask", "zo_fused_replay", "zo_fused_replay_int8", "zo_perturb")


@pytest.fixture(scope="module")
def repo_project():
    return build_project(REPO_ROOT)


@pytest.fixture(scope="module")
def inventory(repo_project):
    return kernel_inventory(repo_project)


def test_inventory_holds_every_kernel(inventory):
    assert sorted(inventory) == [f"{LIB}/csrc/{s}.cu" for s in STEMS]
    for source, seam in inventory.items():
        assert seam["wrappers"] and len(seam["entries"]) == 1 \
            and len(seam["refs"]) == 1, (source, seam)
    assert inventory[f"{LIB}/csrc/zo_fused_replay_int8.cu"] == {
        "wrappers": [f"{LIB}/kernels/zo_fused_replay.py:zo_fused_replay_int8",
                     f"{LIB}/kernels/zo_fused_replay.py:"
                     "zo_fused_replay_int8_leaves"],
        "entries": ["ops.zo_fused_replay_int8_leaves"],
        "refs": ["ref.zo_fused_replay_int8_ref"]}


def _drop_function(text: str, name: str) -> str:
    fn = next(n for n in ast.parse(text).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    lines = text.splitlines(keepends=True)
    first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
    return "".join(lines[:first - 1] + lines[fn.end_lineno:])


@pytest.fixture(scope="module")
def real_seam(tmp_path_factory):
    """The project of a tree holding only the port's kernel seam."""
    root = tmp_path_factory.mktemp("seam")
    for pattern in KERNEL_FILES:
        for p in REPO_ROOT.glob(pattern):
            dst = root / p.relative_to(REPO_ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(p, dst)
    project = build_project(root)
    report = run_analysis(root, KERNEL_RULE, allowlist=[], project=project)
    assert report.clean, _lines(report)
    return project


@pytest.mark.parametrize("part", ["source", "wrapper", "entry", "ref",
                                  "card test"])
@pytest.mark.parametrize("stem", STEMS)
def test_deleting_a_seam_part_fires(stem, part, real_seam, inventory,
                                    tmp_path):
    files, cuda = dict(real_seam.files), dict(real_seam.cuda)
    source = f"{LIB}/csrc/{stem}.cu"
    seam = inventory[source]
    edits = {}
    if part == "source":
        del cuda[source]
    elif part == "card test":
        rel = "tests/test_torch_cuda.py"
        edits[rel] = re.sub(rf"\b{stem}\b", "gone", files[rel].text)
    else:
        for name in {"wrapper": seam["wrappers"], "entry": seam["entries"],
                     "ref": seam["refs"]}[part]:
            if part == "wrapper":
                rel, fn = name.split(":")
            else:
                mod, fn = name.split(".")
                rel = f"{LIB}/kernels/{mod}.py"
            edits[rel] = _drop_function(edits.get(rel, files[rel].text), fn)
    for rel, text in edits.items():
        _tree(tmp_path, {rel: text})
        files[rel] = torch_project._load_source(tmp_path, rel)
    project = torch_project.Project(tmp_path, files, {}, cuda)
    report = run_analysis(tmp_path, KERNEL_RULE, allowlist=[],
                          project=project)
    assert {f.rule for f in report.findings} == {KernelDispatchComplete.id}


# ------------------------------------------------------------------ #
# the meta-gate: the port is clean under its own checker
# ------------------------------------------------------------------ #
def test_repo_is_reprolint_clean(repo_project):
    report = run_analysis(REPO_ROOT, ALL_RULES, project=repo_project)
    assert report.clean, "\n".join(_lines(report))
    assert report.suppressed, "expected inline suppressions in use"


# the CLI in a bare interpreter: torch, jax and the JAX package blocked
BLOCKED = ("import runpy, sys; "
           "sys.modules.update(torch=None, jax=None, repro=None); "
           "runpy.run_module('repro_torch.analysis', run_name='__main__', "
           "alter_sys=True)")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-c", BLOCKED, *args], capture_output=True,
        text=True,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_clean_on_repo_and_writes_report(tmp_path):
    out = tmp_path / "reprolint.json"
    proc = _cli("--root", str(REPO_ROOT), "--report", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["tool"] == "reprolint" and doc["clean"] is True
    assert doc["rules"] == [r.id for r in ALL_RULES]
    assert doc["findings"] == [] and doc["suppressed"]
    assert re.search(r"reprolint: 0 findings, \d+ suppressed, 8 rules",
                     proc.stdout)


def test_cli_exits_nonzero_on_findings(tmp_path):
    root = _tree(tmp_path, FIXTURES["no-invariant-assert"][0])
    proc = _cli("--root", str(root))
    assert proc.returncode == 1
    assert "no-invariant-assert" in proc.stdout


def test_cli_usage_errors_and_rule_list(tmp_path, capsys):
    assert cli.main(["--root", str(tmp_path), "--rules", "no-such-rule"]) == 2
    assert "unknown rule ids" in capsys.readouterr().err
    assert cli.main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == [r.id for r in (*ALL_RULES, *META_RULES)]
    root = _tree(tmp_path, FIXTURES["monotonic-clock"][0])
    assert cli.main(["--root", str(root), "--rules", "no-builtin-hash"]) == 0


# ------------------------------------------------------------------ #
# parity with the JAX package's checker
# ------------------------------------------------------------------ #
SUPPRESSION_TEXT = """import time
t = time.time()  # reprolint: allow(monotonic-clock) -- a stamp
# reprolint: allow(no-builtin-hash, monotonic-clock) -- two ids
k = hash(time.time())
# reprolint: allow(no-builtin-hash)
s = '# reprolint: allow(no-builtin-hash) -- a string, not a comment'
    # reprolint:allow( monotonic-clock )--  tight spacing
"""


@pytest.mark.parametrize("text", [SUPPRESSION_TEXT, "x = (\n"],
                         ids=["cases", "tokenize-error"])
def test_suppression_parser_matches_the_reference(text):
    lines = text.splitlines()

    def parsed(mod):
        return [(s.line, s.rules, s.reason, s.covers)
                for s in mod._parse_suppressions("f.py", text, lines)]
    assert parsed(torch_project) == parsed(jax_project)
    if text == SUPPRESSION_TEXT:
        assert [p[0] for p in parsed(torch_project)] == [2, 3, 5, 7]


DETERMINISM_TEXT = """import time
from time import time as stamp
from time import time


def f(xs):
    assert xs, "empty"
    k = hash("seed")
    t0 = time.time()
    t1 = time()
    t2 = stamp()
    # reprolint: allow(monotonic-clock) -- a stamp
    t3 = time.time()
    t4 = time.time()  # reprolint: allow(monotonic-clock, no-builtin-hash) -- x
    t5 = hash(t4)  # reprolint: allow(no-builtin-hash)
    dead = {x for x in xs}
    for x in dead:
        pass
    keep = set(xs) - dead
    ordered = sorted(keep)
    return list(keep), [y for y in dead | keep], tuple(ordered), k, t0, \\
        t1, t2, t3, t5
"""


def test_determinism_rules_match_the_reference(tmp_path):
    names = ("NoInvariantAssert", "NoBuiltinHash", "MonotonicClock",
             "NondeterministicIteration")
    got = {}
    for side, lib, mod, run in (
            ("jax", "src/repro", jax_determinism, jax_run_analysis),
            ("torch", LIB, determinism, run_analysis)):
        root = _tree(tmp_path / side, {
            f"{lib}/example.py": DETERMINISM_TEXT,
            f"{lib}/fleet/gossip.py": DETERMINISM_TEXT})
        report = run(root, [getattr(mod, n)() for n in names], allowlist=[])
        got[side] = [sorted((f.path[len(lib):], f.rule, f.line) for f in fs)
                     for fs in (report.findings, report.suppressed)]
    assert got["torch"] == got["jax"]
    fired = {rule for _, rule, _ in got["torch"][0]}
    assert fired == {"no-invariant-assert", "no-builtin-hash",
                     "monotonic-clock", "nondeterministic-iteration",
                     BAD_SUPPRESSION}
    assert got["torch"][1]


def test_wire_doc_and_struct_sizes_match_the_reference():
    text = (REPO_ROOT / "docs/fleet.md").read_text(encoding="utf-8")
    assert docs_sync.parse_wire_doc(text) == jax_docs_sync.parse_wire_doc(text)
    sizes = {}
    for side, mod, proj in (("jax", jax_docs_sync, jax_project),
                            ("torch", docs_sync, torch_project)):
        rel = mod.LEDGER
        project = proj.Project(REPO_ROOT,
                               {rel: proj._load_source(REPO_ROOT, rel)}, {})
        sizes[side] = {k: size for k, (size, _) in
                       mod.ledger_struct_sizes(project).items()}
    assert sizes["torch"] == sizes["jax"]
    assert {k: sizes["torch"][k] for k in ("_REC_HDR", "_PROBE", "_PROBE8")} \
        == {"_REC_HDR": 11, "_PROBE": 12, "_PROBE8": 9}


def _names(catalog):
    return {(kind, name) for kind, rows in catalog.items()
            for name, _ in rows}


def test_metric_catalog_matches_the_reference_up_to_the_delta():
    jax_text = (REPO_ROOT / "docs/observability.md").read_text(
        encoding="utf-8")
    torch_text = (REPO_ROOT / docs_sync.CATALOG).read_text(encoding="utf-8")
    assert docs_sync.parse_metric_catalog(jax_text) == \
        jax_docs_sync.parse_metric_catalog(jax_text)
    jax_names = _names(jax_docs_sync.parse_metric_catalog(jax_text))
    torch_names = _names(docs_sync.parse_metric_catalog(torch_text))
    assert torch_names - jax_names == {("gauge", "memory.torch_live_bytes")}
    assert jax_names - torch_names == {
        ("gauge", "serve.compile_ms"), ("gauge", "memory.jax_live_bytes"),
        ("histogram", "serve.compile_warm_ms")}


def test_port_registers_its_catalog(repo_project):
    sites = docs_sync.collect_metric_sites(repo_project)
    assert sites
    catalog = _names(docs_sync.parse_metric_catalog(
        repo_project.doc(docs_sync.CATALOG)))
    assert {(kind, name) for kind, name, _, _ in sites} <= catalog
