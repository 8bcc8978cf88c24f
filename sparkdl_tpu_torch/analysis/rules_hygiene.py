"""SDL003/SDL006 — exception hygiene and monotonic timing.
(Port of ``sparkdl_tpu/analysis/rules_hygiene.py``.)

* **SDL003** — a broad handler (bare ``except:``, ``except Exception``,
  ``except BaseException``) must re-raise, log through a
  ``utils.logging`` logger (the port's ``sparkdl_tpu_torch/utils/
  logging.py``), or carry an allow pragma with a reason.
  Swallowing everything silently is how injected chaos faults — and
  real device deaths — disappear into "it returned None".

* **SDL006** — ``time.time()`` is banned in latency paths: wall clock
  steps under NTP slew and is not monotonic, so a latency computed from
  it can be negative or wildly wrong exactly when the fleet is under
  stress.  The rule flags any ``time.time()`` value that feeds a
  subtraction (the latency idiom); plain wall-clock STAMPS (log/artifact
  timestamps that are never differenced) stay legal.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from sparkdl_tpu_torch.analysis.core import Finding, LintContext, Module

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name) and t.id in _BROAD:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BROAD
                   for e in t.elts)
    return False


def _handler_recovers(handler: ast.ExceptHandler) -> bool:
    for n in ast.walk(handler):
        if isinstance(n, ast.Raise):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in _LOG_METHODS):
            return True
    return False


def rule_sdl003(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
            continue
        if _handler_recovers(node):
            continue
        what = ("bare except" if node.type is None else
                f"except {ast.unparse(node.type)}")
        findings.append(Finding(
            "SDL003", module.path, node.lineno,
            f"broad handler ({what}) neither re-raises nor logs; "
            f"narrow the exception type, log via utils.logging, or "
            f"annotate why swallowing is deliberate"))
    return findings


def _time_aliases(tree: ast.AST) -> tuple:
    """``(module_aliases, direct_names)`` for the wall clock: names the
    ``time`` MODULE is bound to (``import time [as time_lib]`` — the
    alias engine.py actually uses) and names the ``time.time`` FUNCTION
    is bound to (``from time import time [as now]``)."""
    modules: Set[str] = set()
    direct: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for alias in n.names:
                if alias.name == "time":
                    modules.add(alias.asname or "time")
        elif isinstance(n, ast.ImportFrom) and n.module == "time":
            for alias in n.names:
                if alias.name == "time":
                    direct.add(alias.asname or "time")
    return modules, direct


def _make_is_wall_clock(tree: ast.AST):
    modules, direct = _time_aliases(tree)

    def is_wall_clock(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute):
            return (f.attr == "time" and isinstance(f.value, ast.Name)
                    and f.value.id in modules)
        return isinstance(f, ast.Name) and f.id in direct

    return is_wall_clock


def _scope_of(module: Module, node: ast.AST) -> ast.AST:
    cur = module.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = module.parent(cur)
    return module.tree


def rule_sdl006(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    is_wall_clock = _make_is_wall_clock(module.tree)
    scopes: List[ast.AST] = [module.tree]
    scopes.extend(n for n in ast.walk(module.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    for scope in scopes:
        # names bound (in this scope, not nested ones) from the wall clock
        wall: Set[str] = set()
        wall_line = {}
        for n in ast.walk(scope):
            if n is not scope and _scope_of(module, n) is not scope:
                continue
            if isinstance(n, ast.Assign) and is_wall_clock(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        wall.add(t.id)
                        wall_line[t.id] = n.lineno
        for n in ast.walk(scope):
            if not isinstance(n, ast.BinOp) or not isinstance(n.op, ast.Sub):
                continue
            if _scope_of(module, n) is not scope:
                continue
            involved: Optional[int] = None
            for side in (n.left, n.right):
                if is_wall_clock(side):
                    involved = side.lineno
                elif isinstance(side, ast.Name) and side.id in wall:
                    involved = wall_line.get(side.id, n.lineno)
            if involved is not None:
                findings.append(Finding(
                    "SDL006", module.path, n.lineno,
                    "latency computed from time.time(); wall clock is "
                    "not monotonic (NTP slew) — use time.perf_counter() "
                    "or time.monotonic() for durations (wall-clock "
                    "stamps that are never differenced are fine)"))
    return findings
