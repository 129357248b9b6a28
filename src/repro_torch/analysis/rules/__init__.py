"""The port's rule registry.

Adding a rule: subclass ``repro_torch.analysis.core.Rule`` in one of the
modules here (or a new one), give it a kebab-case ``id``, a one-line
``title`` and a ``rationale`` naming the prose contract it enforces,
implement ``check(project)``, append an instance to ``ALL_RULES``, add
it to the catalog in the package docstring, and give it a red and a
green fixture in tests/test_torch_analysis.py.
"""
from __future__ import annotations

from typing import Dict, List

from ..core import BAD_SUPPRESSION, STALE_SUPPRESSION, Rule
from .determinism import (MonotonicClock, NoBuiltinHash,
                          NondeterministicIteration, NoInvariantAssert)
from .docs_sync import (DesignCiteResolves, MetricCatalogSync,
                        WireBytesConsistent)
from .kernels import KernelDispatchComplete

ALL_RULES: List[Rule] = [
    NoInvariantAssert(),
    NoBuiltinHash(),
    MonotonicClock(),
    KernelDispatchComplete(),
    DesignCiteResolves(),
    MetricCatalogSync(),
    NondeterministicIteration(),
    WireBytesConsistent(),
]


class _MetaRule(Rule):
    """Engine-emitted rules, registered so --list-rules shows them."""

    def __init__(self, id_: str, title: str, rationale: str):
        self.id, self.title, self.rationale = id_, title, rationale

    def check(self, project):
        return ()


META_RULES: List[Rule] = [
    _MetaRule(BAD_SUPPRESSION, "inline allows must carry a reason",
              "`# reprolint: allow(rule) -- <why>`: a suppression "
              "without its why is an unreviewable exemption."),
    _MetaRule(STALE_SUPPRESSION, "suppressions must still suppress",
              "an allow (inline or allowlist) matching no finding is "
              "debt: the violation was fixed, delete the exemption."),
]


def rules_by_id() -> Dict[str, Rule]:
    return {r.id: r for r in ALL_RULES}
