"""The port's checker's engine: findings, rules, suppressions, the
allowlist.

The flow (`run_analysis`):

1. build the ``Project`` model of the port (project.py),
2. run every registered rule over it,
3. discharge findings against inline suppressions and the port's own
   committed allowlist (``.reprolint_torch.json`` at the repo root; the
   JAX package's ``.reprolint.json`` names files this scan never sees),
4. turn *unused* suppressions and allowlist entries into
   ``stale-suppression`` findings and malformed inline allows into
   ``bad-suppression`` findings,
5. report. Exit is clean only when nothing survives: an unexplained
   finding, a reasonless allow, and an allow that no longer matches
   anything are all equally fatal — the suppression inventory is kept
   exactly as live as the violations themselves.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from .project import Project, build_project

ALLOWLIST_NAME = ".reprolint_torch.json"

# Meta rule ids (engine-emitted; registered for --list-rules alongside
# the analysis rules proper).
BAD_SUPPRESSION = "bad-suppression"
STALE_SUPPRESSION = "stale-suppression"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    col: int = 0

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


class Rule:
    """One machine-checked repo invariant.

    Subclasses set ``id``/``title``/``rationale`` and implement
    ``check(project)``. ``rationale`` names the prose contract the rule
    enforces (a docs/design.md section or a bug class) — it is what
    `--list-rules` and the package docstring's catalog show.
    """

    id: str = ""
    title: str = ""
    rationale: str = ""

    def check(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError


@dataclass
class AllowEntry:
    """One committed allowlist entry (grandfathered finding).

    Matches findings by rule id + path, optionally narrowed to source
    lines containing ``contains``. A reason is mandatory. An entry that
    matches nothing is stale — delete it when the underlying code is
    fixed.
    """
    rule: str
    path: str
    reason: str
    contains: Optional[str] = None
    index: int = 0            # position in the file, for error messages
    used: int = 0

    def matches(self, project: Project, f: Finding) -> bool:
        if f.rule != self.rule or f.path != self.path:
            return False
        if self.contains is None:
            return True
        sf = project.get(f.path)
        return sf is not None and self.contains in sf.line_at(f.line)


def load_allowlist(root: Path) -> List[AllowEntry]:
    path = Path(root) / ALLOWLIST_NAME
    if not path.is_file():
        return []
    doc = json.loads(path.read_text(encoding="utf-8"))
    entries = []
    for i, raw in enumerate(doc.get("allow", [])):
        missing = {"rule", "path", "reason"} - set(raw)
        if missing:
            raise ValueError(
                f"{ALLOWLIST_NAME} entry {i} is missing {sorted(missing)}")
        if not str(raw["reason"]).strip():
            raise ValueError(f"{ALLOWLIST_NAME} entry {i} has an empty reason")
        entries.append(AllowEntry(rule=raw["rule"], path=raw["path"],
                                  reason=str(raw["reason"]),
                                  contains=raw.get("contains"), index=i))
    return entries


@dataclass
class Report:
    root: str
    rules: List[str]
    findings: List[Finding]                 # unsuppressed + meta — the gate
    suppressed: List[Finding] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "tool": "reprolint",
            "root": self.root,
            "rules": self.rules,
            "clean": self.clean,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
        }


def _syntax_findings(project: Project) -> List[Finding]:
    return [Finding(rule="parse-error", path=sf.path, line=1,
                    message=f"file does not parse: {sf.parse_error}")
            for sf in project.iter_files() if sf.parse_error]


def run_analysis(root: Path, rules: Sequence[Rule],
                 allowlist: Optional[Sequence[AllowEntry]] = None,
                 project: Optional[Project] = None) -> Report:
    """Run ``rules`` over the tree at ``root`` and discharge suppressions."""
    root = Path(root)
    if project is None:
        project = build_project(root)
    if allowlist is None:
        allowlist = load_allowlist(root)

    raw: List[Finding] = list(_syntax_findings(project))
    for rule in rules:
        raw.extend(rule.check(project))

    active: List[Finding] = []
    suppressed: List[Finding] = []
    meta: List[Finding] = []

    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        sf = project.get(f.path)
        inline = None
        if sf is not None:
            for sup in sf.suppressions:
                if f.rule in sup.rules and f.line in (sup.covers, sup.line):
                    inline = sup
                    break
        if inline is not None:
            inline.used = True
            if inline.reason:           # reasonless allows suppress nothing
                suppressed.append(f)
                continue
        entry = next((e for e in allowlist if e.matches(project, f)), None)
        if entry is not None:
            entry.used += 1
            suppressed.append(f)
            continue
        active.append(f)

    # ---- meta findings: the suppression inventory must stay live ------- #
    for sf in project.iter_files():
        for sup in sf.suppressions:
            if not sup.reason:
                meta.append(Finding(
                    rule=BAD_SUPPRESSION, path=sf.path, line=sup.line,
                    message="allow() without a reason — write "
                            "`# reprolint: allow(rule-id) -- <why>`"))
            elif not sup.used:
                meta.append(Finding(
                    rule=STALE_SUPPRESSION, path=sf.path, line=sup.line,
                    message=f"allow({', '.join(sup.rules)}) matches no "
                            "finding on its line — delete the comment"))
    for e in allowlist:
        if not e.used:
            meta.append(Finding(
                rule=STALE_SUPPRESSION, path=ALLOWLIST_NAME, line=e.index + 1,
                message=f"allowlist entry {e.index} "
                        f"({e.rule} @ {e.path}) matches no finding — "
                        "delete the entry"))

    return Report(root=str(root), rules=[r.id for r in rules],
                  findings=active + meta, suppressed=suppressed)
