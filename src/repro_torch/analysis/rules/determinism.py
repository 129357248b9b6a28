"""Per-construct determinism rules, over the port (``src/repro_torch``).

The same bug classes the JAX package's checker keeps fixed, held on the
port's tree:

* salted builtin ``hash()`` makes init streams irreproducible across
  processes (docs/design.md §9);
* invariant ``assert``s vanish under ``python -O`` (a lying fleet
  worker could crash the coordinator — or sail through — docs/design.md
  §11);
* ``time.time()`` deltas go negative under NTP steps (the flight
  recorder, ``repro_torch.obs``, owns monotonic timing);
* ``set`` iteration order is salted-hash order for strings and
  insertion-history order for everything else — feeding it into wire
  encoding or commit paths breaks the bit-identical-close guarantee
  (docs/design.md §12).
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Set, Tuple

from ..core import Finding, Rule
from ..project import LIB, Project


def _walk_funcs(tree: ast.AST) -> Iterator[ast.AST]:
    yield from (n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))


class NoInvariantAssert(Rule):
    id = "no-invariant-assert"
    title = "library code must raise, not assert"
    rationale = (
        "`assert` compiles away under python -O, silently disabling the "
        "invariant (docs/design.md §11). Code in src/repro_torch, its "
        "examples included, raises ValueError/RuntimeError instead.")

    def check(self, project: Project) -> Iterable[Finding]:
        for sf in project.iter_files(LIB):
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Assert):
                    yield Finding(
                        rule=self.id, path=sf.path, line=node.lineno,
                        col=node.col_offset,
                        message="invariant guarded by `assert` disappears "
                                "under python -O — raise ValueError/"
                                "RuntimeError instead")


class NoBuiltinHash(Rule):
    id = "no-builtin-hash"
    title = "builtin hash() is process-salted"
    rationale = (
        "str hashes are salted per process (PYTHONHASHSEED), so any "
        "seed/init/wire derivation through builtin hash() is "
        "irreproducible across processes (docs/design.md §9). Use "
        "zlib.crc32 or hashlib.")

    def check(self, project: Project) -> Iterable[Finding]:
        for sf in project.iter_files(LIB):
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "hash"):
                    yield Finding(
                        rule=self.id, path=sf.path, line=node.lineno,
                        col=node.col_offset,
                        message="builtin hash() is salted per process — "
                                "derive streams via zlib.crc32/hashlib "
                                "(docs/design.md §9)")


def _is_time_time(node: ast.Call, from_imports: Set[str]) -> bool:
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr == "time"
            and isinstance(f.value, ast.Name) and f.value.id == "time"):
        return True
    return isinstance(f, ast.Name) and f.id == "time" and "time" in from_imports


class MonotonicClock(Rule):
    id = "monotonic-clock"
    title = "durations come from the monotonic clock"
    rationale = (
        "time.time() steps backwards under NTP, so deltas go negative. "
        "Durations go through repro_torch.obs.monotonic()/perf_ns(); "
        "time.time() is allowed only as the checkpoint manifests' "
        "wall-clock stamp (inline-suppressed there).")

    def check(self, project: Project) -> Iterable[Finding]:
        for sf in project.iter_files(LIB):
            if sf.tree is None:
                continue
            from_imports = {
                a.asname or a.name
                for node in ast.walk(sf.tree)
                if isinstance(node, ast.ImportFrom) and node.module == "time"
                for a in node.names if a.name == "time"}
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call) and _is_time_time(node,
                                                                from_imports):
                    yield Finding(
                        rule=self.id, path=sf.path, line=node.lineno,
                        col=node.col_offset,
                        message="time.time() is not monotonic — use "
                                "repro_torch.obs.monotonic()/perf_ns() for "
                                "durations (wall-clock stamps must carry "
                                "an inline allow)")


# Modules whose iteration order reaches the wire, a digest, or a commit
# decision. Everything a gossip peer or the coordinator serializes or
# closes over must iterate in a canonical (sorted) order.
WIRE_MODULES = (
    f"{LIB}/fleet/ledger.py",
    f"{LIB}/fleet/commit_rule.py",
    f"{LIB}/fleet/coordinator.py",
    f"{LIB}/fleet/gossip.py",
    f"{LIB}/fleet/replay.py",
    f"{LIB}/fleet/transport.py",
    f"{LIB}/fleet/robust.py",
    f"{LIB}/train/checkpoint.py",
)

_SET_CALLS = {"set", "frozenset"}


class _SetTracker:
    """Syntactic set-typed-ness, with single-assignment local tracking."""

    def __init__(self, scope: ast.AST):
        self.setish_names: Set[str] = set()
        assigns: dict = {}
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        assigns.setdefault(tgt.id, []).append(node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if isinstance(node.target, ast.Name):
                    assigns.setdefault(node.target.id, []).append(node.value)
        for name, values in assigns.items():
            if len(values) == 1 and self._expr_setish(values[0], depth=0):
                self.setish_names.add(name)

    def _expr_setish(self, e: ast.AST, depth: int = 1) -> bool:
        if isinstance(e, (ast.Set, ast.SetComp)):
            return True
        if (isinstance(e, ast.Call) and isinstance(e.func, ast.Name)
                and e.func.id in _SET_CALLS):
            return True
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.Sub, ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._expr_setish(e.left, depth) \
                or self._expr_setish(e.right, depth)
        if depth and isinstance(e, ast.Name):
            return e.id in self.setish_names
        return False

    def setish(self, e: ast.AST) -> bool:
        return self._expr_setish(e)


class NondeterministicIteration(Rule):
    id = "nondeterministic-iteration"
    title = "no raw set iteration on wire/digest/commit paths"
    rationale = (
        "set iteration order is not canonical across processes; on the "
        "modules that encode records, compute digests, or close commits "
        "it must go through sorted() (docs/design.md §12 — every peer "
        "must serialize and close in one order).")

    def check(self, project: Project) -> Iterable[Finding]:
        for sf in project.iter_files(*WIRE_MODULES):
            if sf.tree is None:
                continue
            for scope in (sf.tree, *_walk_funcs(sf.tree)):
                tracker = _SetTracker(scope)
                for node, iter_expr in self._iterations(scope):
                    if tracker.setish(iter_expr):
                        yield Finding(
                            rule=self.id, path=sf.path,
                            line=iter_expr.lineno, col=iter_expr.col_offset,
                            message="iteration over a set feeds a wire/"
                                    "commit path — wrap it in sorted() "
                                    "for a canonical order")

    @staticmethod
    def _iterations(scope: ast.AST) \
            -> List[Tuple[ast.AST, ast.expr]]:
        """(node, iterated expr) pairs directly inside ``scope``."""
        out: List[Tuple[ast.AST, ast.expr]] = []
        nested = {id(n) for f in _walk_funcs(scope) if f is not scope
                  for n in ast.walk(f)}
        for node in ast.walk(scope):
            if id(node) in nested:
                continue
            if isinstance(node, (ast.For, ast.AsyncFor)):
                out.append((node, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                out.extend((node, g.iter) for g in node.generators)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id in ("list", "tuple") and node.args):
                out.append((node, node.args[0]))
        return out
