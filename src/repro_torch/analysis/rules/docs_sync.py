"""Cross-artifact rules: the port's code and committed docs must not
drift.

Three contracts stated in prose get machine-checked over the port:

* ``design-cite-resolves`` — `§N` citations (docstrings, comments,
  other docs) must point at a section that exists in docs/design.md.
* ``metric-catalog-sync`` — the port's observability surface is a
  contract (docs/torch_observability.md, "Metric catalog"): every
  span/counter/gauge/histogram/event/memory-tag literal registered
  through repro_torch.obs must have a catalog row, and every catalog
  row must have a registration site. No phantom metrics, no phantom
  docs rows. The JAX package's catalog (docs/observability.md) is
  read the same way by the same parser.
* ``wire-bytes-consistent`` — the struct formats in the port's
  fleet/ledger.py must produce exactly the documented record sizes
  (docs/fleet.md, "Ledger record format": 11 B header, 12 B/probe fp32,
  9 B/probe int8), the JAX package's wire format byte for byte.
"""
from __future__ import annotations

import ast
import fnmatch
import re
import struct
from typing import Dict, Iterable, Iterator, List, Set, Tuple

from ..core import Finding, Rule
from ..project import LIB, Project

CATALOG = "docs/torch_observability.md"


# --------------------------------------------------------------------- #
# design-cite-resolves
# --------------------------------------------------------------------- #
_CITE_RE = re.compile(r"§(\d+)")
_HEADING_RE = re.compile(r"^##\s+§\d+\b")


class DesignCiteResolves(Rule):
    id = "design-cite-resolves"
    title = "§N citations resolve to a docs/design.md section"
    rationale = (
        "docs/design.md sections are numbered contracts; a citation to "
        "a section that does not exist is unverifiable prose.")

    def check(self, project: Project) -> Iterable[Finding]:
        sections = set(project.design_sections())
        if not sections:
            if any(True for sf in project.iter_files()
                   for _ in self._citations_of_text(sf.text)):
                yield Finding(rule=self.id, path="docs/design.md", line=1,
                              message="sources cite §N sections but "
                                      "docs/design.md has none")
            return
        for sf in project.iter_files():
            for line_no, n in self._citations_of_text(sf.text):
                if n not in sections:
                    yield Finding(
                        rule=self.id, path=sf.path, line=line_no,
                        message=f"cites docs/design.md §{n}, which does "
                                "not exist (sections: "
                                f"§1–§{max(sections)})")
        for rel, text in sorted(project.docs.items()):
            for i, line in enumerate(text.splitlines(), 1):
                if rel == "docs/design.md" and _HEADING_RE.match(line):
                    continue
                for m in _CITE_RE.finditer(line):
                    n = int(m.group(1))
                    if n not in sections:
                        yield Finding(
                            rule=self.id, path=rel, line=i,
                            message=f"cites §{n}, which does not exist "
                                    "in docs/design.md (sections: "
                                    f"§1–§{max(sections)})")

    @staticmethod
    def _citations_of_text(text: str) -> Iterator[Tuple[int, int]]:
        for i, line in enumerate(text.splitlines(), 1):
            for m in _CITE_RE.finditer(line):
                yield i, int(m.group(1))


# --------------------------------------------------------------------- #
# metric-catalog-sync
# --------------------------------------------------------------------- #
_METRIC_METHODS = {"counter": "counter", "gauge": "gauge",
                   "histogram": "histogram", "span": "span",
                   "event": "event"}
_MEMORY_METHODS = {"alloc", "rebind", "free"}
_PLACEHOLDER_RE = re.compile(r"<[^<>]+>")


def _literal_pattern(node: ast.expr) -> str | None:
    """str literal or f-string as a match pattern ({}-fields -> '*')."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return "".join(parts)
    return None


def _compatible(a: str, b: str) -> bool:
    """Do two name patterns ('*' wildcards) plausibly name each other?"""
    return (fnmatch.fnmatchcase(a.replace("*", "\x01"), b)
            or fnmatch.fnmatchcase(b.replace("*", "\x01"), a))


def _expand_cell_names(cell: str, kind: str) -> List[str]:
    """Backticked names from one catalog cell, sibling-expanded.

    `fleet.wire.zo_bytes` / `tail_bytes` names two counters: a bare
    token inherits the previous full name's prefix; a `.suffix` token
    replaces after the previous name's parent. `<x>` placeholders
    become '*' wildcards.
    """
    out: List[str] = []
    for tok in re.findall(r"`([^`]+)`", cell):
        name = _PLACEHOLDER_RE.sub("*", tok.strip())
        if kind == "span" or "/" in name or name.startswith("memory."):
            full = name
        elif name.startswith("."):
            full = (out[-1].rsplit(".", 1)[0] + name) if out else name
        elif "." in name or not out:
            full = name
        else:                       # bare sibling: swap the last segment
            full = out[-1].rsplit(".", 1)[0] + "." + name
        out.append(full)
    return out


_CATALOG_KINDS = {"spans": "span", "counters": "counter", "gauges": "gauge",
                  "histograms": "histogram", "events": "event",
                  "memory tags": "memory"}


def parse_metric_catalog(text: str) -> Dict[str, List[Tuple[str, int]]]:
    """A metric catalog (docs/torch_observability.md, or the JAX
    package's docs/observability.md) -> {kind: [(name pattern, line)]}.

    The catalog is the region from '## Metric catalog' to the next
    '## ' heading, plus the memory 'Tag catalog:' table. Each kind is
    introduced by a '<Kind>...:' lead-in line followed by a markdown
    table whose name column is 'span', 'name' or 'tag'.
    """
    lines = text.splitlines()
    out: Dict[str, List[Tuple[str, int]]] = {k: [] for k in
                                             _CATALOG_KINDS.values()}
    kind = None
    in_catalog = False
    name_col = None
    for i, line in enumerate(lines, 1):
        low = line.strip().lower()
        if low.startswith("## "):
            in_catalog = low == "## metric catalog"
            kind = None
            continue
        for lead, k in _CATALOG_KINDS.items():
            if low.startswith(lead) and low.endswith(":"):
                kind = k if (in_catalog or k == "memory") else None
                name_col = None
                break
        if kind is None and low.startswith("tag catalog"):
            kind, name_col = "memory", None
        if kind is None or not line.strip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if name_col is None:                      # header row
            headers = [c.lower() for c in cells]
            for cand in ("span", "name", "tag"):
                if cand in headers:
                    name_col = headers.index(cand)
                    break
            continue
        if set("".join(cells)) <= {"-", ":", " "}:   # separator row
            continue
        if name_col < len(cells):
            for name in _expand_cell_names(cells[name_col], kind):
                out[kind].append((name, i))
    return out


def collect_metric_sites(project: Project) \
        -> List[Tuple[str, str, str, int]]:
    """(kind, name pattern, path, line) for every literal registration."""
    sites: List[Tuple[str, str, str, int]] = []
    for sf in project.iter_files(LIB):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in _METRIC_METHODS:
                kind = _METRIC_METHODS[attr]
            elif attr in _MEMORY_METHODS:
                kind = "memory"
            else:
                continue
            if not node.args:
                continue
            pat = _literal_pattern(node.args[0])
            if pat is None:
                continue
            if kind == "memory" and "." not in pat:
                continue          # not a dotted ledger tag (e.g. pool.free)
            sites.append((kind, pat, sf.path, node.lineno))
    return sites


class MetricCatalogSync(Rule):
    id = "metric-catalog-sync"
    title = ("observability names match the docs/torch_observability.md "
             "catalog")
    rationale = (
        "dashboards and benchmark gates key on metric names; an "
        "undocumented metric is unreviewable and a documented-but-"
        "unregistered one is a dead dashboard row. The port's catalog "
        "and its code must name exactly the same surface, both "
        "directions.")

    def check(self, project: Project) -> Iterable[Finding]:
        doc_text = project.doc(CATALOG)
        sites = collect_metric_sites(project)
        if not doc_text:
            if sites:
                yield Finding(
                    rule=self.id, path=CATALOG, line=1,
                    message="metrics are registered in code but "
                            f"{CATALOG} is missing")
            return
        catalog = parse_metric_catalog(doc_text)
        # code -> doc: no phantom metrics
        for kind, pat, path, line in sites:
            entries = catalog.get(kind, [])
            if not any(_compatible(pat, doc_pat) for doc_pat, _ in entries):
                yield Finding(
                    rule=self.id, path=path, line=line,
                    message=f"{kind} `{pat}` is not in the "
                            f"{CATALOG} catalog — add a row "
                            "(phantom metric)")
        # doc -> code: no phantom catalog rows
        by_kind: Dict[str, Set[str]] = {}
        for kind, pat, _, _ in sites:
            by_kind.setdefault(kind, set()).add(pat)
        for kind, entries in catalog.items():
            for doc_pat, line in entries:
                if not any(_compatible(code_pat, doc_pat)
                           for code_pat in by_kind.get(kind, ())):
                    yield Finding(
                        rule=self.id, path=CATALOG, line=line,
                        message=f"catalog {kind} `{doc_pat}` has no "
                                f"registration site in {LIB} "
                                "(phantom docs row)")


# --------------------------------------------------------------------- #
# wire-bytes-consistent
# --------------------------------------------------------------------- #
LEDGER = f"{LIB}/fleet/ledger.py"
# The struct constants that ARE the documented wire contract.
_CONTRACT_STRUCTS = {"_REC_HDR": "record header",
                     "_PROBE": "fp32 probe entry",
                     "_PROBE8": "int8 probe entry"}


def ledger_struct_sizes(project: Project) -> Dict[str, Tuple[int, int]]:
    """{const name: (calcsize, line)} for fleet/ledger.py Struct consts."""
    sf = project.get(LEDGER)
    out: Dict[str, Tuple[int, int]] = {}
    if sf is None or sf.tree is None:
        return out
    for node in sf.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr == "Struct" and v.args
                and isinstance(v.args[0], ast.Constant)
                and isinstance(v.args[0].value, str)):
            try:
                size = struct.calcsize(v.args[0].value)
            except struct.error:
                continue
            out[node.targets[0].id] = (size, node.lineno)
    return out


def parse_wire_doc(text: str) -> Dict[str, Tuple[int, int]]:
    """docs/fleet.md 'Ledger record format' -> {fact: (bytes, line)}.

    Facts: header / fp32_probe / int8_probe, each read from BOTH the
    wire diagram ('N B header', 'N B per probe' inside the lane's code
    fence block) and the bytes-per-probe table ('| fp32 | **N B** ...
    `H + Nm` B |'); a disagreement between the two is reported as a
    0-size sentinel by the caller noticing the mismatch.
    """
    out: Dict[str, Tuple[int, int]] = {}
    lines = text.splitlines()
    in_section = False
    lane = None
    for i, line in enumerate(lines, 1):
        s = line.strip()
        if s.startswith("## "):
            in_section = s.lower().startswith("## ledger record format")
            continue
        if not in_section:
            continue
        if re.match(r"fp32\s*\(", s):
            lane = "fp32"
        elif re.match(r"int8\s*\(", s):
            lane = "int8"
        m = re.search(r"(\d+)\s*B header", s)
        if m:
            out.setdefault("header", (int(m.group(1)), i))
        m = re.search(r"(\d+)\s*B per probe", s)
        if m and lane:
            out.setdefault(f"{lane}_probe", (int(m.group(1)), i))
        m = re.match(r"\|\s*(fp32|int8)\s*\|\s*\*\*(\d+)\s*B\*\*.*?"
                     r"`(\d+)\s*\+\s*(\d+)m`", s)
        if m:
            out.setdefault(f"{m.group(1)}_table_probe",
                           (int(m.group(2)), i))
            out.setdefault(f"{m.group(1)}_table_header",
                           (int(m.group(3)), i))
            out.setdefault(f"{m.group(1)}_table_per_probe",
                           (int(m.group(4)), i))
    return out


class WireBytesConsistent(Rule):
    id = "wire-bytes-consistent"
    title = "ledger struct formats match the documented record sizes"
    rationale = (
        "12 B/probe fp32 and 9 B/probe int8 are the paper's headline "
        "wire numbers (docs/fleet.md record tables) — the struct format "
        "strings in the port's fleet/ledger.py must produce exactly "
        "those sizes.")

    def check(self, project: Project) -> Iterable[Finding]:
        structs = ledger_struct_sizes(project)
        if not structs and project.get(LEDGER) is None:
            return                      # no ledger in this tree
        doc = parse_wire_doc(project.doc("docs/fleet.md"))
        if not doc:
            yield Finding(
                rule=self.id, path="docs/fleet.md", line=1,
                message="ledger wire sizes are not documented (no "
                        "parseable 'Ledger record format' section)")
            return
        for const, what in _CONTRACT_STRUCTS.items():
            if const not in structs:
                yield Finding(
                    rule=self.id, path=LEDGER, line=1,
                    message=f"struct constant {const} ({what}) is gone — "
                            "the documented wire contract names it")
        checks = [("_REC_HDR", "header", "record header"),
                  ("_PROBE", "fp32_probe", "fp32 probe entry"),
                  ("_PROBE8", "int8_probe", "int8 probe entry"),
                  ("_REC_HDR", "fp32_table_header", "record header"),
                  ("_REC_HDR", "int8_table_header", "record header"),
                  ("_PROBE", "fp32_table_probe", "fp32 probe entry"),
                  ("_PROBE", "fp32_table_per_probe", "fp32 probe entry"),
                  ("_PROBE8", "int8_table_probe", "int8 probe entry"),
                  ("_PROBE8", "int8_table_per_probe", "int8 probe entry")]
        for const, fact, what in checks:
            if const not in structs or fact not in doc:
                if fact not in doc and const in structs:
                    yield Finding(
                        rule=self.id, path="docs/fleet.md", line=1,
                        message=f"documented size for {what} ({fact}) "
                                "not found in the record-format section")
                continue
            size, code_line = structs[const]
            doc_size, doc_line = doc[fact]
            if size != doc_size:
                yield Finding(
                    rule=self.id, path=LEDGER, line=code_line,
                    message=f"{const} ({what}) is {size} B but "
                            f"docs/fleet.md:{doc_line} documents "
                            f"{doc_size} B — wire format and doc drifted")
