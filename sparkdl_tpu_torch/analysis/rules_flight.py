"""SDL008 — every flight-event string must exist in the one catalog.
(Port of ``sparkdl_tpu/analysis/rules_flight.py``.)

The flight recorder's whole value is that an incident's state changes
are FOUND at post-mortem time; a typo'd event name in a
``flight_emit("...")``/``flight.emit("...")`` call would raise at the
first real incident (``validate_event`` is the runtime half) — or, on a
path no test drives, silently compile into an instrumentation site
``tools/blackbox.py`` can never reconstruct.  The catalog is the
``EVENT_HELP`` table in ``sparkdl_tpu_torch/obs/flight.py``, read HERE with
``ast`` — the linter never imports the package under analysis (the
SDL004 pattern, applied to the recorder).

Only the recorder's own spellings are matched (the bare
``flight_emit`` import alias and the ``flight.emit`` module attribute)
— ``emit`` is too common a name to claim outright (a benchmark script
may well have an ``emit()`` of its own).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from sparkdl_tpu_torch.analysis.core import (Finding, LintContext, Module,
                                       load_name_registry_file,
                                       locate_name_registry)


def _is_event_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id == "flight_emit"
    if isinstance(f, ast.Attribute) and f.attr == "emit":
        return isinstance(f.value, ast.Name) and f.value.id == "flight"
    return False


def load_event_registry_file(path: str) -> Optional[Set[str]]:
    """Parse ONE catalog file (``--events-file``): the keys of its
    ``EVENT_HELP`` dict literal, falling back to an ``EVENTS`` tuple
    literal.  None when the file holds neither."""
    return load_name_registry_file(path, "EVENT_HELP", "EVENTS")


def load_event_registry(targets: Iterable[str]) -> Optional[Set[str]]:
    """Auto-locate ``obs/flight.py`` under the DIRECTORY targets and
    extract its event catalog (plain-file targets contribute only when
    they are themselves a ``flight.py`` — the SDL004 locator policy)."""
    return locate_name_registry(targets, "obs", "flight.py",
                                "EVENT_HELP", "EVENTS")


def rule_sdl008(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) or not _is_event_call(node):
            continue
        if not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue  # dynamic names hit validate_event at runtime
        if ctx.events is None:
            findings.append(Finding(
                "SDL008", module.path, node.lineno,
                f"flight event {first.value!r} emitted but no catalog "
                f"(obs/flight.py EVENT_HELP) was found under the lint "
                f"targets — event names cannot be verified"))
            continue
        if first.value not in ctx.events:
            known = ", ".join(sorted(ctx.events))
            findings.append(Finding(
                "SDL008", module.path, node.lineno,
                f"unknown flight event {first.value!r} — an uncataloged "
                f"event either raises at the first real incident or "
                f"records something blackbox can never explain; register "
                f"it in obs/flight.py EVENT_HELP or fix the name "
                f"(known: {known})"))
    return findings
