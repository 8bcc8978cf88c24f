"""SDL005 — observability naming schema + span open/close pairing.
(Port of ``sparkdl_tpu/analysis/rules_obs.py``.)

* Names passed to ``Metrics`` recorders (``incr``/``gauge``/
  ``record_time``/``observe``) and to tracer span constructors
  (``span``/``start_span``) must match the project's dotted-lowercase
  schema ``segment(.segment)*`` with ``[a-z0-9_]`` segments — the
  exporters (Prometheus text, Chrome trace, trace_summary) key on these
  strings, so one camelCase stray forks a time series forever.

* A span that is OPENED must be closable: ``tracer.span(...)`` /
  ``tracer.start_span(...)`` results must be used as a context manager,
  stored somewhere that outlives the call (attribute/subscript/arg/
  return — the cross-thread handoff pattern), or explicitly
  ``.finish()``-ed in the same function.  A span discarded or left in a
  dead local never closes, never records, and silently truncates every
  trace tree under it.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from sparkdl_tpu_torch.analysis.core import Finding, LintContext, Module

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)*$")
_METRIC_METHODS = {"incr", "gauge", "record_time", "observe"}
_SPAN_METHODS = {"span", "start_span"}


def _method_call(node: ast.AST, methods) -> Optional[str]:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in methods):
        return node.func.attr
    return None


def rule_sdl005_names(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        method = _method_call(node, _METRIC_METHODS | _SPAN_METHODS)
        if method is None or not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue  # dynamic names are the caller's problem
        if not _NAME_RE.match(first.value):
            findings.append(Finding(
                "SDL005", module.path, node.lineno,
                f"{method}() name {first.value!r} breaks the "
                f"dotted-lowercase schema ([a-z0-9_] segments joined by "
                f"'.'); exporters key on these strings — one stray "
                f"spelling forks the series forever"))
    return findings


def _escapes(module: Module, call: ast.Call, scope: ast.AST) -> bool:
    """The span value leaves the expression: ``with`` item, attribute/
    subscript store, call argument, return/yield, or container literal."""
    node: ast.AST = call
    parent = module.parent(node)
    while parent is not None:
        if isinstance(parent, ast.withitem):
            return True
        if isinstance(parent, ast.Call) and node is not parent.func:
            return True  # passed as an argument
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(parent, (ast.List, ast.Tuple, ast.Dict, ast.Set)):
            return True
        if isinstance(parent, ast.Assign):
            return any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in parent.targets)
        if isinstance(parent, (ast.IfExp, ast.BoolOp, ast.NamedExpr)):
            node = parent
            parent = module.parent(parent)
            continue
        if parent is scope or isinstance(
                parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.stmt)):
            return False
        node = parent
        parent = module.parent(parent)
    return False


def _assigned_name(module: Module, call: ast.Call) -> Optional[str]:
    node: ast.AST = call
    parent = module.parent(node)
    while isinstance(parent, (ast.IfExp, ast.BoolOp, ast.NamedExpr)):
        node = parent
        parent = module.parent(parent)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
            and isinstance(parent.targets[0], ast.Name):
        return parent.targets[0].id
    return None


def _finished_in(scope: ast.AST, name: str) -> bool:
    for n in ast.walk(scope):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "finish"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == name):
            return True
        # handing the local onward (arg/return/attribute store) also
        # moves close responsibility with it
        if (isinstance(n, ast.Call)
                and any(isinstance(a, ast.Name) and a.id == name
                        for a in n.args)):
            return True
        if (isinstance(n, ast.Return) and isinstance(n.value, ast.Name)
                and n.value.id == name):
            return True
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Name) \
                and n.value.id == name and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in n.targets):
            return True
    return False


def _scope_of(module: Module, node: ast.AST) -> ast.AST:
    cur = module.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = module.parent(cur)
    return module.tree


def rule_sdl005_pairing(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        method = _method_call(node, _SPAN_METHODS)
        if method is None:
            continue
        scope = _scope_of(module, node)
        if _escapes(module, node, scope):
            continue
        name = _assigned_name(module, node)
        if name is not None and _finished_in(scope, name):
            continue
        findings.append(Finding(
            "SDL005", module.path, node.lineno,
            f"{method}() result is never closed: use it as a context "
            f"manager, call .finish() on it in this function, or hand "
            f"it somewhere that owns the close — an unclosed span "
            f"records nothing and truncates its whole subtree"))
    return findings
