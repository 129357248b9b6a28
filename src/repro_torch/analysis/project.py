"""The whole-project model the port's checker runs its rules against.

A ``Project`` is the parsed view of one checkout as the port sees it:
every Python file of the port (``src/repro_torch``, the port's tests and
``chip_smoke.py``: AST, raw text and inline suppressions), the raw text
of the CUDA sources under ``src/repro_torch/csrc`` (read, never parsed
as Python), and the committed ``docs/*.md`` that the cross-artifact
rules reconcile the code against. Building it never imports the code
under analysis: everything is ``ast`` and text, so the checker runs in
a bare interpreter with neither torch nor a card.

Rules receive the whole project, not one file at a time: that is what
lets kernel-dispatch-complete see ``csrc/*.cu``, the wrapper modules,
``ref.py``, ``ops.py`` and the card test together, and
metric-catalog-sync reconcile call sites against
docs/torch_observability.md in both directions.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

LIB = "src/repro_torch"
CSRC = f"{LIB}/csrc"
# What is scanned for Python sources, relative to the repo root: a
# directory (every ``*.py`` below it) or a glob of files.
SCAN_ROOTS = (LIB, "tests/test_torch_*.py", "tests/torch_*.py",
              "chip_smoke.py")
# Never scanned, besides any ``__pycache__``: the kernels' build outputs.
EXCLUDED = (f"{CSRC}/_build",)
# CUDA sources loaded as text for the kernel rule.
CUDA_SUFFIXES = (".cu", ".cuh")

# Inline suppression grammar (the ``analysis`` package docstring):
#     # reprolint: allow(rule-id[, rule-id...]) -- <why>
# The reason after ``--`` is mandatory; an allow without one is itself
# a finding (bad-suppression).
_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*allow\(\s*([a-z0-9_,\s-]*?)\s*\)"
    r"(?:\s*--\s*(\S.*?))?\s*$")


@dataclass
class Suppression:
    """One inline ``# reprolint: allow(...)`` comment."""
    path: str
    line: int                 # line the comment sits on
    rules: List[str]
    reason: Optional[str]     # None => bad-suppression
    covers: int               # line whose findings it suppresses
    used: bool = False


@dataclass
class SourceFile:
    path: str                 # repo-root-relative, posix separators
    text: str
    lines: List[str] = field(default_factory=list)
    tree: Optional[ast.AST] = None
    parse_error: Optional[str] = None
    suppressions: List[Suppression] = field(default_factory=list)

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


def _parse_suppressions(path: str, text: str,
                        lines: Sequence[str]) -> List[Suppression]:
    """Real COMMENT tokens only: the same text inside a string literal
    (a test fixture, this checker's own sources) is not a suppression."""
    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out                     # unparsable files surface elsewhere
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
        reason = m.group(2)
        # a comment alone on its line covers the next line; a trailing
        # comment covers its own line
        alone = lines[i - 1].lstrip().startswith("#")
        out.append(Suppression(path=path, line=i, rules=rules,
                               reason=reason, covers=i + 1 if alone else i))
    return out


def _load_source(root: Path, rel: str) -> SourceFile:
    text = (root / rel).read_text(encoding="utf-8")
    lines = text.splitlines()
    sf = SourceFile(path=rel, text=text, lines=lines,
                    suppressions=_parse_suppressions(rel, text, lines))
    try:
        sf.tree = ast.parse(text, filename=rel)
    except SyntaxError as e:      # surfaced as a finding by the engine
        sf.parse_error = f"{e.msg} (line {e.lineno})"
    return sf


class Project:
    """Parsed checkout: the port's Python sources, its CUDA sources'
    text and the contract documents."""

    def __init__(self, root: Path, files: Dict[str, SourceFile],
                 docs: Dict[str, str], cuda: Optional[Dict[str, str]] = None):
        self.root = Path(root)
        self.files = files            # rel path -> SourceFile
        self.docs = docs              # rel path -> raw markdown
        self.cuda = cuda or {}        # rel path -> raw .cu / .cuh text

    # ---- source access ------------------------------------------------ #
    def iter_files(self, *prefixes: str) -> Iterator[SourceFile]:
        """Parsed sources under the given path prefixes (all if none)."""
        for rel in sorted(self.files):
            if not prefixes or any(rel == p or rel.startswith(p.rstrip("/") + "/")
                                   for p in prefixes):
                yield self.files[rel]

    def get(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel)

    def doc(self, rel: str) -> str:
        """Raw text of a committed markdown doc ('' when missing)."""
        return self.docs.get(rel, "")

    # ---- doc views used by the cross-artifact rules -------------------- #
    def design_sections(self) -> Dict[int, int]:
        """{section number: heading line} parsed from docs/design.md."""
        out: Dict[int, int] = {}
        for i, line in enumerate(self.doc("docs/design.md").splitlines(), 1):
            m = re.match(r"##\s+§(\d+)\b", line)
            if m:
                out[int(m.group(1))] = i
        return out


def find_repo_root(start: Optional[Path] = None) -> Path:
    """Walk up from ``start`` (default cwd) to the pyproject.toml root."""
    cur = Path(start or Path.cwd()).resolve()
    for cand in (cur, *cur.parents):
        if (cand / "pyproject.toml").is_file():
            return cand
    raise FileNotFoundError(
        f"no pyproject.toml above {cur}; pass --root explicitly")


def _excluded(root: Path, p: Path) -> bool:
    rel = p.relative_to(root)
    return "__pycache__" in rel.parts or any(
        rel.as_posix().startswith(ex + "/") for ex in EXCLUDED)


def _scan(root: Path, scan: str, pattern: str) -> List[Path]:
    """Files matching ``pattern`` below the directory ``scan``, or the
    files that the glob ``scan`` names."""
    base = root / scan
    found = base.rglob(pattern) if base.is_dir() else root.glob(scan)
    return [p for p in sorted(found)
            if p.is_file() and not _excluded(root, p)]


def build_project(root: Path,
                  scan_roots: Sequence[str] = SCAN_ROOTS) -> Project:
    root = Path(root)
    files: Dict[str, SourceFile] = {}
    for scan in scan_roots:
        for p in _scan(root, scan, "*.py"):
            rel = p.relative_to(root).as_posix()
            files[rel] = _load_source(root, rel)
    cuda: Dict[str, str] = {}
    for suffix in CUDA_SUFFIXES:
        for p in _scan(root, CSRC, f"*{suffix}"):
            cuda[p.relative_to(root).as_posix()] = p.read_text(
                encoding="utf-8")
    docs: Dict[str, str] = {}
    docs_dir = root / "docs"
    if docs_dir.is_dir():
        for p in sorted(docs_dir.glob("*.md")):
            rel = p.relative_to(root).as_posix()
            docs[rel] = p.read_text(encoding="utf-8")
    return Project(root, files, docs, cuda)
