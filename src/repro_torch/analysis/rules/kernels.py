"""kernel-dispatch-complete: the port's CUDA kernel contract.

Every hand-written kernel of the port is one CUDA source,
``csrc/<stem>.cu``, which ``kernels/_build.py`` compiles and loads, and
which is reached through one seam: a wrapper module under ``kernels/``
loads the source and launches it (CUDA tensors only); ``kernels/ops.py``
is the one public dispatch point, whose CUDA branch calls the wrapper
and whose CPU branch calls the kernel's plain version in
``kernels/ref.py``, the numerical contract off the card; and
``tests/test_torch_cuda.py`` holds the kernel to that plain version on
the card. A kernel outside that seam, or drifting from it in signature,
only fails on the card.

Machine-checked shape of the contract, per ``csrc/<stem>.cu``:

* exactly one module under ``kernels/`` loads it with the literal stem,
  through ``_build.load("<stem>")`` or ``_build.function("<stem>", ...)``
  (a load whose stem is not a literal cannot be inventoried and is a
  finding itself, as is a literal stem with no source);
* a C symbol the wrapper names literally (``_build.function(stem,
  "<symbol>", ...)``, ``_build.load(stem).<symbol>``) is in the source;
* a public ops.py entry calls a public function of that module that
  reaches the load (within the module), on its CUDA branch: inside an
  ``if`` on ``.is_cuda`` or on a device type equal to ``"cuda"``;
* the entry's positional parameters equal that wrapper function's;
* the entry calls exactly one ``ref.<fn>``, which exists in ref.py, and
  each such call binds to the ref's signature: no more positional
  arguments than it has positional parameters, every keyword one of its
  parameters, every parameter without a default given (a ``*args`` or
  ``**kw`` splat is taken as binding). The ref's positional parameters
  may differ from the entry's: a per-leaf ref, an ``out`` the entry
  writes itself;
* ``tests/test_torch_cuda.py`` names the stem (the card test);
* and, in the reverse direction, every public ``*_ref`` in ref.py is
  called from some ops.py function: an orphan ref is dead contract.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import Finding, Rule
from ..project import CSRC, LIB, Project, SourceFile

KERNELS_DIR = f"{LIB}/kernels"
OPS = f"{KERNELS_DIR}/ops.py"
REF = f"{KERNELS_DIR}/ref.py"
CARD_TEST = "tests/test_torch_cuda.py"
_LOADERS = ("load", "function")


def _top_functions(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body
            if isinstance(n, ast.FunctionDef)}


def _functions_of(project: Project, rel: str) -> Dict[str, ast.FunctionDef]:
    """The top-level functions of ``rel`` ({} when absent or unparsed)."""
    sf = project.get(rel)
    return {} if sf is None or sf.tree is None else _top_functions(sf.tree)


def _positional(fn: ast.FunctionDef) -> List[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def _called_names(fn: ast.AST) -> Set[str]:
    return {node.func.id for node in ast.walk(fn)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}


def _literal(node: Optional[ast.expr]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@dataclass
class Load:
    """One ``_build.load`` / ``_build.function`` call in a module."""
    path: str
    line: int
    func: str                       # enclosing top-level function ('' if none)
    stem: Optional[str]             # None: not a literal
    symbols: List[str] = field(default_factory=list)


def _loads(sf: SourceFile) -> List[Load]:
    """Every build load in ``sf``, with the literal C symbols it names."""
    out: Dict[int, Load] = {}
    for stmt in sf.tree.body:
        func = stmt.name if isinstance(stmt, ast.FunctionDef) else ""
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _LOADERS
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                load = Load(sf.path, node.lineno, func,
                            _literal(node.args[0]) if node.args else None)
                if node.func.attr == "function" and len(node.args) > 1 \
                        and _literal(node.args[1]) is not None:
                    load.symbols.append(node.args[1].value)
                out[id(node)] = load
    for node in ast.walk(sf.tree):             # _build.load("x").symbol
        if isinstance(node, ast.Attribute) and id(node.value) in out:
            out[id(node.value)].symbols.append(node.attr)
    return sorted(out.values(), key=lambda ld: ld.line)


def _reaching(fns: Dict[str, ast.FunctionDef], direct: Set[str]) -> Set[str]:
    """Names of the module's functions that reach ``direct`` through
    calls within the module."""
    reach = set(direct)
    changed = True
    while changed:
        changed = False
        for name, fn in fns.items():
            if name not in reach and _called_names(fn) & reach:
                reach.add(name)
                changed = True
    return reach


def _is_cuda_test(test: ast.expr) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr == "is_cuda":
            return True
        if isinstance(node, ast.Compare) and any(
                _literal(c) == "cuda" for c in [node.left, *node.comparators]):
            return True
    return False


def _module_aliases(tree: ast.AST) -> Dict[str, str]:
    """ops.py's ``from . import <module> [as <alias>]``: {alias: module},
    module names relative to ``kernels/``."""
    return {a.asname or a.name: a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 1
            and node.module is None for a in node.names}


@dataclass
class Call:
    """A call from an ops.py function into a kernel module."""
    entry: str
    line: int
    module: str                     # the called module's path
    func: str
    on_cuda: bool


def _kernel_calls(name: str, fn: ast.FunctionDef,
                  mods: Dict[str, str]) -> List[Call]:
    """``<module alias>.<function>(...)`` calls in ``fn``, each marked
    with whether it lies on a CUDA branch."""
    cuda_nodes: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _is_cuda_test(node.test):
            cuda_nodes.update(id(n) for stmt in node.body
                              for n in ast.walk(stmt))
    return [Call(name, node.lineno,
                 f"{KERNELS_DIR}/{mods[node.func.value.id]}.py",
                 node.func.attr, on_cuda=id(node) in cuda_nodes)
            for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in mods]


def _ref_calls(fn: ast.FunctionDef) -> List[ast.Call]:
    """The ``ref.<name>(...)`` calls inside ``fn``."""
    return [node for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "ref"]


def binding_errors(call: ast.Call, fn: ast.FunctionDef) -> List[str]:
    """Why ``call`` would not bind to ``fn``'s signature ([] if it
    binds); a ``*args`` or ``**kw`` splat is taken as binding."""
    a = fn.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    by_keyword = [p.arg for p in a.args + a.kwonlyargs]
    if any(isinstance(x, ast.Starred) for x in call.args):
        return []
    n = len(call.args)
    errors = []
    if n > len(positional) and a.vararg is None:
        errors.append(f"{n} positional arguments, where it takes "
                      f"{len(positional)}")
    given = set(positional[:n])
    splat = False
    for kw in call.keywords:
        if kw.arg is None:
            splat = True
        elif kw.arg in given:
            errors.append(f"`{kw.arg}` given twice")
        elif kw.arg not in by_keyword and a.kwarg is None:
            errors.append(f"no parameter `{kw.arg}`")
        else:
            given.add(kw.arg)
    if not splat:
        first_default = len(positional) - len(a.defaults)
        missing = [p for i, p in enumerate(positional)
                   if i >= n and i < first_default and p not in given]
        missing += [p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                    if d is None and p.arg not in given]
        if missing:
            errors.append(f"{missing} not given")
    return errors


@dataclass
class Seam:
    """One kernel's seam as the project holds it."""
    stem: str
    source: str                               # csrc/<stem>.cu, rel path
    modules: List[str] = field(default_factory=list)   # loading modules
    loads: List[Load] = field(default_factory=list)
    wrappers: Set[str] = field(default_factory=set)    # public fns
    calls: List[Call] = field(default_factory=list)    # ops.py -> them


def kernel_seams(project: Project) -> Tuple[Dict[str, Seam], List[Load]]:
    """({stem: seam} for every ``csrc/*.cu``, the loads whose stem is not
    a literal or names no source)."""
    seams = {}
    for rel in sorted(project.cuda):
        if rel.endswith(".cu"):
            stem = rel.rsplit("/", 1)[1][:-len(".cu")]
            seams[stem] = Seam(stem, rel)
    stray: List[Load] = []
    for sf in project.iter_files(KERNELS_DIR):
        if sf.tree is None or sf.path in (OPS, REF):
            continue
        fns = _top_functions(sf.tree)
        for ld in _loads(sf):
            seam = seams.get(ld.stem)
            if seam is None:
                stray.append(ld)
                continue
            if sf.path not in seam.modules:
                seam.modules.append(sf.path)
            seam.loads.append(ld)
            # a load at import time is reached by no function
            reach = _reaching(fns, {ld.func}) if ld.func else set()
            seam.wrappers.update(n for n in reach if not n.startswith("_"))
    ops_sf = project.get(OPS)
    if ops_sf is None or ops_sf.tree is None:
        return seams, stray
    mods = _module_aliases(ops_sf.tree)
    for name, fn in _top_functions(ops_sf.tree).items():
        if name.startswith("_"):
            continue
        for call in _kernel_calls(name, fn, mods):
            for seam in seams.values():
                if (seam.modules == [call.module]
                        and call.func in seam.wrappers):
                    seam.calls.append(call)
    return seams, stray


def kernel_inventory(project: Project) -> Dict[str, Dict[str, List[str]]]:
    """{csrc source: {"wrappers": [module:function], "entries":
    [ops.function], "refs": [ref.function]}} of every ``csrc/*.cu``
    (``chip_smoke.py`` holds its keys to the kernels it times)."""
    seams, _ = kernel_seams(project)
    ops_fns = _functions_of(project, OPS)
    out = {}
    for s in seams.values():
        entries = sorted({c.entry for c in s.calls if c.on_cuda})
        out[s.source] = {
            "wrappers": [f"{m}:{w}" for m in s.modules
                         for w in sorted(s.wrappers)],
            "entries": [f"ops.{e}" for e in entries],
            "refs": sorted({f"ref.{c.func.attr}" for e in entries
                            for c in _ref_calls(ops_fns[e])})}
    return out


class KernelDispatchComplete(Rule):
    id = "kernel-dispatch-complete"
    title = ("every CUDA kernel has a wrapper, an ops dispatch, a plain "
             "version and a card test")
    rationale = (
        "kernels/ref.py is the numerical contract off the card and "
        "kernels/ops.py the one dispatch seam (docs/design.md §7); a "
        "csrc kernel outside that seam — or drifting from it in "
        "signature — only fails on the card.")

    def check(self, project: Project) -> Iterable[Finding]:
        seams, stray = kernel_seams(project)
        for ld in stray:
            yield Finding(
                rule=self.id, path=ld.path, line=ld.line,
                message=(f"_build loads `{ld.stem}`, which has no "
                         f"{CSRC}/{ld.stem}.cu" if ld.stem is not None else
                         "_build load with a stem that is not a literal — "
                         "the kernel cannot be inventoried"))
        ops_fns = _functions_of(project, OPS)
        ref_fns = _functions_of(project, REF)
        card = project.get(CARD_TEST)
        for stem in sorted(seams):
            yield from self._check_seam(project, seams[stem], ops_fns,
                                        ref_fns, card)
        if not seams:
            return
        used = {c.func.attr for fn in ops_fns.values()
                for c in _ref_calls(fn)}
        for name in sorted(ref_fns):
            if name.endswith("_ref") and not name.startswith("_") \
                    and name not in used:
                yield Finding(
                    rule=self.id, path=REF, line=ref_fns[name].lineno,
                    message=f"ref.{name} is called from no ops.py "
                            "function — orphaned plain version")

    def _check_seam(self, project: Project, seam: Seam,
                    ops_fns: Dict[str, ast.FunctionDef],
                    ref_fns: Dict[str, ast.FunctionDef],
                    card: Optional[SourceFile]) -> Iterable[Finding]:
        stem, src = seam.stem, seam.source
        if card is None or not re.search(rf"\b{re.escape(stem)}\b",
                                         card.text):
            yield Finding(
                rule=self.id, path=src, line=1,
                message=f"{CARD_TEST} does not name `{stem}` — the kernel "
                        "has no card test")
        if len(seam.modules) != 1:
            yield Finding(
                rule=self.id, path=src, line=1,
                message=(f"`{stem}` is loaded by {len(seam.modules)} "
                         f"modules under kernels/ {seam.modules}"
                         if seam.modules else
                         f"no module under kernels/ loads `{stem}`") +
                " — exactly one wrapper module loads each source")
            return
        text = project.cuda.get(src, "")
        for ld in seam.loads:
            for sym in ld.symbols:
                if not re.search(rf"\b{re.escape(sym)}\b", text):
                    yield Finding(
                        rule=self.id, path=ld.path, line=ld.line,
                        message=f"C symbol `{sym}` is not in {src}")
        if not seam.wrappers:
            yield Finding(
                rule=self.id, path=seam.modules[0], line=seam.loads[0].line,
                message=f"no public function of {seam.modules[0]} reaches "
                        f"the load of `{stem}` — nothing to dispatch to")
            return
        entries = [c for c in seam.calls if c.on_cuda]
        if not entries:
            where = [f"ops.{c.entry}" for c in seam.calls]
            yield Finding(
                rule=self.id, path=seam.modules[0], line=seam.loads[0].line,
                message=f"`{stem}`'s wrapper "
                        f"({', '.join(sorted(seam.wrappers))}) is called on "
                        "no ops.py entry's CUDA branch" +
                        (f" (only outside it: {where})" if where else ""))
            return
        wrapper_fns = _top_functions(project.get(seam.modules[0]).tree)
        for call in entries:
            entry = ops_fns[call.entry]
            want = _positional(wrapper_fns[call.func])
            got = _positional(entry)
            if got != want:
                yield Finding(
                    rule=self.id, path=OPS, line=entry.lineno,
                    message=f"ops.{call.entry} positional signature {got} "
                            f"!= wrapper {call.func}'s {want} ({call.module})")
            yield from self._check_ref(call.entry, entry, ref_fns)

    def _check_ref(self, name: str, entry: ast.FunctionDef,
                   ref_fns: Dict[str, ast.FunctionDef]) -> Iterable[Finding]:
        calls = _ref_calls(entry)
        refs = sorted({c.func.attr for c in calls})
        if len(refs) != 1:
            yield Finding(
                rule=self.id, path=OPS, line=entry.lineno,
                message=f"ops.{name} must take exactly one ref.<fn> on "
                        f"the CPU (found {refs or 'none'})")
            return
        ref_fn = ref_fns.get(refs[0])
        if ref_fn is None:
            yield Finding(
                rule=self.id, path=OPS, line=entry.lineno,
                message=f"ops.{name} calls ref.{refs[0]}, which does not "
                        "exist in kernels/ref.py")
            return
        for call in calls:
            for why in binding_errors(call, ref_fn):
                yield Finding(
                    rule=self.id, path=OPS, line=call.lineno,
                    message=f"ops.{name}'s call of ref.{refs[0]} does not "
                            f"bind to its signature: {why}")
