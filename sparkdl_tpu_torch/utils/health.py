"""Shared ready/degraded health state machine (port of
``sparkdl_tpu/utils/health.py``).

``Server.health()`` builds its snapshot through :func:`health_payload` /
:meth:`HealthTracker.payload`: ``ready`` <-> ``degraded`` driven by
failure/success outcomes, a ``last_error`` that survives recovery for
post-mortems, and a bounded ``transitions`` history so a ``degraded ->
ready`` recovery is observable after a point-in-time poll would have raced
past it.  The same states, transitions and bound as the JAX package's;
the tracker emits no flight events (``obs/flight.py`` is not ported).

Timestamps are ``time.monotonic`` (never wall clock): they order
transitions and measure gaps.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

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
    transitions kept.  (The JAX package's lock name and tracker name label
    flight events, which the port does not emit.)"""

    def __init__(self, maxlen: int = 64):
        self._lock = threading.Lock()
        self._state = "ready"
        self._transitions: deque = deque(
            [{"state": "ready", "t_monotonic": round(time.monotonic(), 3)}],
            maxlen=maxlen)
        self._last_error: Optional[Dict[str, Any]] = None

    def note_failure(self, exc: BaseException) -> None:
        """Record one failed attempt: state -> degraded (idempotent:
        repeated failures extend the episode, not the history)."""
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

    def note_success(self) -> None:
        """Record recovery: state -> ready (no-op while already ready, so
        steady-state success never grows the transition history)."""
        with self._lock:
            if self._state != "ready":
                self._state = "ready"
                self._transitions.append(
                    {"state": "ready",
                     "t_monotonic": round(time.monotonic(), 3)})

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
