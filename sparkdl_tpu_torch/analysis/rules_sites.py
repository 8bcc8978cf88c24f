"""SDL004 — every fault-site string must exist in the canonical registry.
(Port of ``sparkdl_tpu/analysis/rules_sites.py``.)

The chaos layer's whole value is that a spec'd site FIRES; a typo'd
site in an ``inject("...")``/``has_rules("...")`` call would silently
never fire and turn a chaos run vacuous (spec-side typos already fail
at parse time — this closes the code-side half).  The registry is the
``SITE_HELP`` table in ``sparkdl_tpu_torch/faults/sites.py``, read HERE with
``ast`` — the linter never imports the package under analysis.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from sparkdl_tpu_torch.analysis.core import (Finding, LintContext, Module,
                                       load_name_registry_file,
                                       locate_name_registry)

_SITE_CALLS = {"inject", "has_rules"}


def load_site_registry_file(path: str) -> Optional[Set[str]]:
    """Parse ONE registry file (``--sites-file``): the keys of its
    ``SITE_HELP`` dict literal, falling back to a ``SITES`` tuple
    literal.  None when the file holds neither."""
    return load_name_registry_file(path, "SITE_HELP", "SITES")


def load_site_registry(targets: Iterable[str]) -> Optional[Set[str]]:
    """Auto-locate ``faults/sites.py`` under the DIRECTORY targets and
    extract its site set (plain-file targets contribute only if they
    are themselves a ``sites.py`` — linting ``bench.py`` must not walk
    the whole checkout).  None when no registry file is found; pass an
    explicit file through :func:`load_site_registry_file` instead."""
    return locate_name_registry(targets, "faults", "sites.py",
                                "SITE_HELP", "SITES")


def rule_sdl004(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    sites = ctx.sites
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name not in _SITE_CALLS or not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue
        if sites is None:
            findings.append(Finding(
                "SDL004", module.path, node.lineno,
                f"fault site {first.value!r} used but no canonical "
                f"registry (faults/sites.py SITE_HELP) was found under "
                f"the lint targets — site strings cannot be verified"))
            continue
        if first.value not in sites:
            known = ", ".join(sorted(sites))
            findings.append(Finding(
                "SDL004", module.path, node.lineno,
                f"unknown fault site {first.value!r} — a typo'd site "
                f"never fires and makes chaos runs vacuous; register it "
                f"in faults/sites.py or fix the name (known: {known})"))
    return findings
