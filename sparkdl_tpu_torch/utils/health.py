"""Shared ready/degraded health state machine (port of
``sparkdl_tpu/utils/health.py``).

``Server.health()`` builds its snapshot through :func:`health_payload` /
:meth:`HealthTracker.payload`: ``ready`` <-> ``degraded`` driven by
failure/success outcomes, a ``last_error`` that survives recovery for
post-mortems, and a bounded ``transitions`` history so a ``degraded ->
ready`` recovery is observable after a point-in-time poll would have raced
past it.  The same states, transitions and bound as the JAX package's, and
the same flight events: ``health.degraded`` and ``health.ready``, emitted
after the tracker's lock is released (a ``health.degraded`` also triggers
the recorder's durable dump when a blackbox directory is configured).

Timestamps are ``time.monotonic`` (never wall clock): they order
transitions and measure gaps.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.obs.flight import emit as flight_emit

#: The shared state vocabulary every health() surface speaks.
HEALTH_STATES = ("ready", "degraded", "closed")


def health_payload(*, live: bool, state: str,
                   last_error: Optional[Dict[str, Any]] = None,
                   transitions: Optional[list] = None,
                   **extra: Any) -> Dict[str, Any]:
    """THE ``health()`` schema: ``{"live", "state", "last_error",
    "transitions"}`` plus caller-specific extras (``breaker`` for the
    server).  Extras may never shadow a core key, and ``state`` must come
    from :data:`HEALTH_STATES`."""
    if state not in HEALTH_STATES:
        raise ValueError(f"health state must be one of {HEALTH_STATES}, "
                         f"got {state!r}")
    payload: Dict[str, Any] = {
        "live": bool(live),
        "state": state,
        "last_error": last_error,
        "transitions": list(transitions or []),
    }
    for k, v in extra.items():
        if k in payload:
            raise ValueError(f"health extra field {k!r} collides with a "
                             f"core contract key")
        payload[k] = v
    return payload


class HealthTracker:
    """The ready/degraded half of a ``health()`` snapshot.  Owners layer
    their own overrides on top (``closed``, breaker-open); this class owns
    only the failure/success-driven core state, with at most ``maxlen``
    transitions kept.  ``name`` labels the tracker in flight events
    (default ``lock_name``, which also names its lock in the lock audit,
    ``named_lock(lock_name)``, as in the JAX package)."""

    def __init__(self, lock_name: str = "health", maxlen: int = 64,
                 name: Optional[str] = None):
        self.name = name if name is not None else lock_name
        self._lock = named_lock(lock_name)
        self._state = "ready"
        self._transitions: deque = deque(
            [{"state": "ready", "t_monotonic": round(time.monotonic(), 3)}],
            maxlen=maxlen)
        self._last_error: Optional[Dict[str, Any]] = None

    def note_failure(self, exc: BaseException) -> None:
        """Record one failed attempt: state -> degraded (idempotent:
        repeated failures extend the episode, not the history).  The
        transition emits ``health.degraded``."""
        transitioned = False
        with self._lock:
            self._last_error = {
                "type": type(exc).__name__,
                "error": str(exc)[:300],
                "t_monotonic": round(time.monotonic(), 3),
            }
            if self._state != "degraded":
                self._state = "degraded"
                self._transitions.append(
                    {"state": "degraded",
                     "t_monotonic": round(time.monotonic(), 3)})
                transitioned = True
        if transitioned:
            flight_emit("health.degraded", tracker=self.name,
                        error=type(exc).__name__)

    def note_success(self) -> None:
        """Record recovery: state -> ready (no-op while already ready, so
        steady-state success never grows the transition history).  The
        transition emits ``health.ready``."""
        transitioned = False
        with self._lock:
            if self._state != "ready":
                self._state = "ready"
                self._transitions.append(
                    {"state": "ready",
                     "t_monotonic": round(time.monotonic(), 3)})
                transitioned = True
        if transitioned:
            flight_emit("health.ready", tracker=self.name)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable ``{"state", "last_error", "transitions"}``
        (copies: callers may mutate freely)."""
        with self._lock:
            return {
                "state": self._state,
                "last_error": (dict(self._last_error)
                               if self._last_error else None),
                "transitions": list(self._transitions),
            }

    def payload(self, *, live: bool,
                state_override: Optional[str] = None,
                **extra: Any) -> Dict[str, Any]:
        """The tracker's state rendered through :func:`health_payload`.
        ``state_override`` replaces the tracker's own state (the owner's
        breaker-open/closed layering); extras ride through verbatim."""
        snap = self.snapshot()
        return health_payload(
            live=live,
            state=state_override if state_override is not None
            else snap["state"],
            last_error=snap["last_error"],
            transitions=snap["transitions"],
            **extra)
