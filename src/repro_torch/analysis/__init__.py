"""reprolint for the port: the static checker of ``src/repro_torch``.

The port's twin of the JAX package's ``repro.analysis``: the same
engine, suppressions and rule ids, held over the port's tree
(``src/repro_torch``, the port's tests ``tests/test_torch_*.py`` and
``tests/torch_*.py``, and ``chip_smoke.py``), with the kernel contract
restated for the CUDA seam and the metric catalog read from the port's
own docs/torch_observability.md. Pure stdlib: it imports neither torch
nor anything of the JAX package, and never imports the code it checks.

Usage, from the repo root::

    PYTHONPATH=src python -m repro_torch.analysis            # exit 0/1/2
    PYTHONPATH=src python -m repro_torch.analysis --report out.json
    PYTHONPATH=src python -m repro_torch.analysis --rules no-builtin-hash
    PYTHONPATH=src python -m repro_torch.analysis --list-rules

or::

    from repro_torch.analysis import run_analysis, ALL_RULES
    report = run_analysis(root, ALL_RULES)

Exit codes: 0 clean, 1 findings (stale or reasonless suppressions
included), 2 usage error or malformed allowlist.

Rule catalog:

=============================  ==========================================
id                             checks
=============================  ==========================================
``no-invariant-assert``        code under ``src/repro_torch`` (its
                               examples too) states invariants with
                               ``raise``, never ``assert``, which
                               ``python -O`` strips.
``no-builtin-hash``            no builtin ``hash()`` in
                               ``src/repro_torch``: it is salted per
                               process for ``str``/``bytes``. Use
                               ``hashlib`` or ``core/prng``.
``monotonic-clock``            no ``time.time()`` for durations (NTP
                               steps make its deltas negative);
                               ``obs.monotonic()`` is the duration
                               clock. The checkpoint manifests'
                               wall-clock stamps carry inline allows.
``kernel-dispatch-complete``   every ``csrc/<stem>.cu`` is loaded by one
                               wrapper module with its literal stem, is
                               called on an ``ops.py`` entry's CUDA
                               branch with the wrapper's positional
                               signature, whose CPU branch calls exactly
                               one ``ref.<fn>`` that exists and binds
                               the call; the card test names the stem,
                               and no public ``*_ref`` is orphaned
                               (docs/design.md §7;
                               ``rules/kernels.py``).
``design-cite-resolves``       every ``§N`` citation, in the port's
                               sources and in ``docs/*.md``, resolves to
                               a ``## §N`` section of docs/design.md.
``metric-catalog-sync``        every span/counter/gauge/histogram/event/
                               memory-tag literal registered through
                               ``repro_torch.obs`` has a row in
                               docs/torch_observability.md, and every
                               row has a registration site.
``nondeterministic-iteration`` no iteration over a ``set`` in the port's
                               wire/digest/commit modules
                               (``fleet/ledger.py``, ``gossip.py``,
                               ``commit_rule.py``, ...,
                               ``train/checkpoint.py``). Sort first.
``wire-bytes-consistent``      the ``struct`` formats in the port's
                               ``fleet/ledger.py`` give exactly the
                               record sizes docs/fleet.md documents
                               (11 B header, 12 B/probe fp32, 9 B/probe
                               int8).
``bad-suppression`` (meta)     an inline ``allow()`` without a reason;
                               it suppresses nothing.
``stale-suppression`` (meta)   an inline allow or allowlist entry that
                               matches no finding. Delete it.
=============================  ==========================================

Suppressions: ``# reprolint: allow(<id>) -- <why>`` on its own line
covers the next line, trailing a line covers that line; the reason is
mandatory. Grandfathered findings go in ``.reprolint_torch.json`` at the
repo root (the schema of the JAX package's ``.reprolint.json``:
``{"allow": [{"rule", "path", "reason", "contains"?}]}``); the port
reads only its own file.
"""
from .core import (AllowEntry, Finding, Report, Rule, load_allowlist,
                   run_analysis)
from .project import Project, build_project, find_repo_root
from .rules import ALL_RULES, META_RULES, rules_by_id

__all__ = ["AllowEntry", "Finding", "Report", "Rule", "load_allowlist",
           "run_analysis", "Project", "build_project", "find_repo_root",
           "ALL_RULES", "META_RULES", "rules_by_id"]
