"""Runtime lock-order checking for the port's serving stack
(``SPARKDL_LOCKCHECK``; port of ``sparkdl_tpu/analysis/lockcheck.py``).

The dynamic half of graftlint: the static rules (SDL001/SDL002) prove
threads are joined and guarded attributes stay guarded, but a lock-order
DEADLOCK only shows up when two threads interleave acquisitions.
Following the lockset idea of Eraser (Savage et al., SOSP 1997) applied
to ORDER rather than ownership: every instrumented acquisition records an
edge ``held -> wanted`` in a process-global graph of lock NAMES (lock
classes, not instances — two engines' breaker locks are one node), and
an acquisition that would close a cycle raises :class:`LockOrderError`
BEFORE blocking, naming the full cycle.  A schedule that merely *could*
deadlock is enough to fail — the probe never has to actually wedge.

Gate: the port creates every lock through :func:`named_lock` /
:func:`named_rlock` / :func:`named_condition`, under the JAX package's
name for the same lock where it has one.  With ``SPARKDL_LOCKCHECK``
unset (production) these return PLAIN ``threading`` primitives — zero
wrapper, zero per-acquire cost, the same disabled-path budget as
``SPARKDL_TRACE``/``SPARKDL_FAULTS``.  With ``SPARKDL_LOCKCHECK=1`` they
return checked wrappers.  Tests flip the gate programmatically with
:func:`enable` / :func:`disable` and isolate state with :func:`reset`.

Everything here is stdlib-only and imports nothing from the rest of
``sparkdl_tpu_torch`` — the lock factories sit below every other layer.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set

__all__ = [
    "LockOrderError",
    "named_lock",
    "named_rlock",
    "named_condition",
    "enabled",
    "enable",
    "disable",
    "reset",
    "order_graph",
]

_ON = ("1", "true", "on", "yes")

# None = consult the env on first ask; True/False = pinned by enable()/
# disable() (tests) or by the first env read.
_enabled: Optional[bool] = None

# name -> names acquired while it was held.  Guarded by _graph_lock; the
# graph lock is only ever held for O(edges) bookkeeping, never while
# blocking on an instrumented lock.
_edges: Dict[str, Set[str]] = {}
_graph_lock = threading.Lock()
_held = threading.local()  # per-thread stack of held lock names


class LockOrderError(RuntimeError):
    """Acquiring ``wanted`` while holding ``held`` closes a cycle in the
    process's lock-acquisition-order graph — two threads running these
    paths concurrently can deadlock.  ``cycle`` is the full name path
    ``wanted -> ... -> held -> wanted``."""

    def __init__(self, wanted: str, held: str, cycle: List[str]):
        super().__init__(
            f"lock-order cycle: acquiring {wanted!r} while holding "
            f"{held!r} inverts the established order "
            f"{' -> '.join(cycle)} -> {cycle[0]} — two threads on these "
            f"paths can deadlock")
        self.wanted = wanted
        self.held = held
        self.cycle = cycle


def enabled() -> bool:
    """Whether lock instrumentation is on (``SPARKDL_LOCKCHECK`` truthy,
    read once, or pinned by :func:`enable`/:func:`disable`)."""
    global _enabled
    if _enabled is None:
        raw = os.environ.get("SPARKDL_LOCKCHECK", "").strip().lower()
        _enabled = raw in _ON
    return _enabled


def enable() -> None:
    """Turn instrumentation on for locks created FROM NOW ON (tests)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the recorded order graph (test isolation).  Locks already
    created keep reporting into the fresh graph."""
    with _graph_lock:
        _edges.clear()


def order_graph() -> Dict[str, List[str]]:
    """Copy of the acquisition-order graph, ``{held: [acquired, ...]}``
    — what the chaos suite can dump on failure."""
    with _graph_lock:
        return {k: sorted(v) for k, v in _edges.items()}


def _stack() -> List[str]:
    s = getattr(_held, "stack", None)
    if s is None:
        s = _held.stack = []
    return s


def _path_between(src: str, dst: str) -> Optional[List[str]]:
    """DFS path ``src -> ... -> dst`` in the edge graph — caller holds
    ``_graph_lock``."""
    seen = set()
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in _edges.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(name: str, check: bool = True) -> None:
    """Record that this thread is acquiring ``name`` with its current
    held set; raise :class:`LockOrderError` when the new edge closes a
    cycle.  Re-entrant / same-name acquisitions (two instances of one
    lock class) are skipped — instance granularity would flood the graph
    with self-edges that cannot deadlock across classes."""
    held = _stack()
    if check and held:
        with _graph_lock:
            for h in held:
                if h == name or name in _edges.get(h, ()):
                    continue
                # would h -> name close a cycle (a name -> ... -> h path)?
                cycle = _path_between(name, h)
                if cycle is not None:
                    raise LockOrderError(name, h, cycle)
                _edges.setdefault(h, set()).add(name)
    held.append(name)


def _note_release(name: str) -> None:
    held = _stack()
    if held and held[-1] == name:
        held.pop()
    elif name in held:  # out-of-order release: tolerate, stay consistent
        held.remove(name)


class _CheckedLock:
    """Order-checking wrapper with the ``threading.Lock``/``RLock``
    surface the stack uses (``acquire``/``release``/context manager/
    ``locked``)."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _note_acquire(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            _note_release(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<CheckedLock {self.name!r} {self._inner!r}>"


class _CheckedCondition:
    """Order-checking ``threading.Condition`` wrapper.  ``wait`` releases
    the underlying lock, so the held-stack entry is popped for the wait
    and re-pushed (without re-checking: waking up re-acquires the SAME
    lock, which established no new ordering) when it returns."""

    def __init__(self, name: str, inner: threading.Condition):
        self.name = name
        self._inner = inner

    def acquire(self, *args) -> bool:
        _note_acquire(self.name)
        ok = self._inner.acquire(*args)
        if not ok:
            _note_release(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_release(self.name)

    def wait(self, timeout: Optional[float] = None) -> bool:
        _note_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquire(self.name, check=False)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _note_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquire(self.name, check=False)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<CheckedCondition {self.name!r} {self._inner!r}>"


def named_lock(name: str):
    """A ``threading.Lock`` registered under ``name`` in the order
    checker when ``SPARKDL_LOCKCHECK`` is on; a PLAIN ``threading.Lock``
    otherwise (zero added cost — the production path)."""
    if not enabled():
        return threading.Lock()
    return _CheckedLock(name, threading.Lock())


def named_rlock(name: str):
    """:func:`named_lock` for ``threading.RLock`` (re-entrant holds of
    the same instance are order-neutral and skipped by the checker)."""
    if not enabled():
        return threading.RLock()
    return _CheckedLock(name, threading.RLock())


def named_condition(name: str):
    """:func:`named_lock` for ``threading.Condition``."""
    if not enabled():
        return threading.Condition()
    return _CheckedCondition(name, threading.Condition())
