"""SDL001/SDL002 — thread lifecycle and lockset discipline.
(Port of ``sparkdl_tpu/analysis/rules_threads.py``.)

* **SDL001** — every constructed ``threading.Thread``/``Timer`` must be
  daemonized or joined.  The wedged-queue lesson: a non-daemon
  stage thread that is not joined on every exit path outlives its run,
  blocks interpreter exit, and wedges the next run's queues.  The check
  is lexical: the thread must be constructed with ``daemon=True``, have
  ``<t>.daemon = True`` set, or have ``<t>.join(...)`` called — in the
  enclosing function for a local binding, anywhere in the class for a
  ``self.<x>`` binding (start/join commonly split across ``__init__``
  and ``close``).  A thread object that is never bound to a name cannot
  be joined at all and must be a daemon.

* **SDL002** — Eraser-style (Savage et al., SOSP 1997) intra-class
  lockset check: an attribute that is EVER written under ``with
  self.<lock>:`` (outside ``__init__``) is lock-guarded shared state,
  and every other write to it (outside ``__init__``, where the object
  is not yet shared) must also hold the lock.  Lock attributes are
  recognized by construction (``threading.Lock/RLock/Condition`` or the
  :mod:`~sparkdl_tpu_torch.analysis.lockcheck` ``named_*`` factories) or by
  name (``*lock*``/``*cond*``/``*mutex*``).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from sparkdl_tpu_torch.analysis.core import Finding, LintContext, Module

_THREAD_CTORS = {"Thread", "Timer"}
_LOCK_CTORS = {"Lock", "RLock", "Condition",
               "named_lock", "named_rlock", "named_condition"}
_LOCKISH_NAME = re.compile(r"lock|cond|mutex", re.IGNORECASE)


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_thread_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return (f.attr in _THREAD_CTORS and isinstance(f.value, ast.Name)
                and f.value.id == "threading")
    return isinstance(f, ast.Name) and f.id in _THREAD_CTORS


def _daemon_kwarg_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return isinstance(kw.value, ast.Constant) and bool(kw.value.value)
    return False


def _enclosing(module: Module, node: ast.AST, kinds) -> Optional[ast.AST]:
    cur = module.parent(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = module.parent(cur)
    return None


def _is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"
            and (attr is None or node.attr == attr))


def _name_is_handled(scope: ast.AST, name: str) -> bool:
    """``name.join(...)`` called or ``name.daemon = True`` set anywhere
    in ``scope``."""
    for n in ast.walk(scope):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == name):
            return True
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if (isinstance(t, ast.Attribute) and t.attr == "daemon"
                        and isinstance(t.value, ast.Name)
                        and t.value.id == name
                        and isinstance(n.value, ast.Constant)
                        and bool(n.value.value)):
                    return True
    return False


def _container_binding(module: Module,
                       call: ast.Call) -> Optional[tuple]:
    """For a thread constructed inside a list/tuple literal or a
    comprehension, the ``(scope-search node, name)`` the container is
    assigned to — the ``threads = [Thread(...), ...]`` pool pattern."""
    node: ast.AST = call
    parent = module.parent(node)
    seen_container = False
    while isinstance(parent, (ast.List, ast.Tuple, ast.ListComp,
                              ast.comprehension, ast.IfExp)):
        seen_container = seen_container or not isinstance(parent, ast.IfExp)
        node = parent
        parent = module.parent(parent)
    if not seen_container:
        return None
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
            and isinstance(parent.targets[0], ast.Name):
        return parent, parent.targets[0].id
    return None


def _list_is_joined(scope: ast.AST, list_name: str) -> bool:
    """A ``for t in <list_name>: ... t.join()`` loop exists in scope."""
    for n in ast.walk(scope):
        if not isinstance(n, ast.For):
            continue
        if not (isinstance(n.iter, ast.Name) and n.iter.id == list_name
                and isinstance(n.target, ast.Name)):
            continue
        if _name_is_handled(n, n.target.id):
            return True
    return False


def _self_attr_is_handled(cls: ast.AST, attr: str) -> bool:
    """``self.<attr>.join(...)`` called or ``self.<attr>.daemon = True``
    set anywhere in the class."""
    for n in ast.walk(cls):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"
                and _is_self_attr(n.func.value, attr)):
            return True
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if (isinstance(t, ast.Attribute) and t.attr == "daemon"
                        and _is_self_attr(t.value, attr)
                        and isinstance(n.value, ast.Constant)
                        and bool(n.value.value)):
                    return True
    return False


def rule_sdl001(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not _is_thread_ctor(node):
            continue
        if _daemon_kwarg_true(node):
            continue
        parent = module.parent(node)
        scope = _enclosing(module, node,
                           (ast.FunctionDef, ast.AsyncFunctionDef)) \
            or module.tree
        handled = False
        binding = "an unbound"
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = parent.targets[0]
            if isinstance(target, ast.Name):
                binding = f"local {target.id!r}"
                handled = _name_is_handled(scope, target.id)
            elif _is_self_attr(target):
                binding = f"attribute 'self.{target.attr}'"
                cls = _enclosing(module, node, (ast.ClassDef,))
                handled = cls is not None and _self_attr_is_handled(
                    cls, target.attr)
        else:
            pool = _container_binding(module, node)
            if pool is not None:
                binding = f"pooled (list {pool[1]!r})"
                handled = _list_is_joined(scope, pool[1])
        if not handled:
            findings.append(Finding(
                "SDL001", module.path, node.lineno,
                f"{binding} thread is neither daemon=True nor joined; a "
                f"non-daemon thread that can outlive its run wedges "
                f"queues and interpreter exit (join it on every exit "
                f"path, or daemonize)"))
    return findings


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names on ``self`` that hold locks: assigned from a lock
    constructor/factory, or lock-ish by name."""
    out: Set[str] = set()
    for n in ast.walk(cls):
        if not isinstance(n, ast.Assign):
            continue
        for t in n.targets:
            if not _is_self_attr(t):
                continue
            if _LOCKISH_NAME.search(t.attr):
                out.add(t.attr)
            elif (isinstance(n.value, ast.Call)
                  and _call_name(n.value) in _LOCK_CTORS):
                out.add(t.attr)
    return out


def _with_holds_self_lock(node: ast.With, locks: Set[str]) -> bool:
    for item in node.items:
        expr = item.context_expr
        # `with self._lock:` and `with self._lock.something():` both
        # count only for the bare-attribute form — acquire() aliases etc.
        # stay out of scope for a lexical checker.
        if isinstance(expr, ast.Attribute) and _is_self_attr(expr) \
                and expr.attr in locks:
            return True
    return False


def rule_sdl002(module: Module, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        # (attr, line, under_lock, in_init) for every `self.<attr>` write
        writes: List[tuple] = []

        def visit(node: ast.AST, under: bool, in_init: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_init = in_init or node.name == "__init__"
            if isinstance(node, ast.With) and _with_holds_self_lock(
                    node, locks):
                under = True
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if _is_self_attr(t) and t.attr not in locks:
                    writes.append((t.attr, t.lineno, under, in_init))
            for child in ast.iter_child_nodes(node):
                # nested ClassDefs get their own pass from the outer loop
                if isinstance(child, ast.ClassDef):
                    continue
                visit(child, under, in_init)

        for stmt in cls.body:
            visit(stmt, False, False)
        guarded = {a for a, _, under, in_init in writes
                   if under and not in_init}
        for attr, line, under, in_init in writes:
            if attr in guarded and not under and not in_init:
                findings.append(Finding(
                    "SDL002", module.path, line,
                    f"'self.{attr}' is written under a lock elsewhere in "
                    f"{cls.name} but written here without one — either "
                    f"hold the lock or stop pretending the attribute is "
                    f"lock-guarded"))
    return findings
