"""Serving-layer exceptions (port of ``sparkdl_tpu/serving/errors.py``,
the same classes, hierarchy, ``retry_after_s`` and messages).

Every failure mode of the online path is a distinct type so callers can
route them: retry later (``QueueFullError`` — carries ``retry_after_s``),
tighten deadlines or shed load upstream (``DeadlineExceededError``),
treat the model as wedged (``DispatchTimeoutError``), or stop sending
(``ServerClosedError``).
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base class of all serving-layer errors."""


class QueueFullError(ServingError):
    """Admission rejected: the bounded queue is full (backpressure).

    ``retry_after_s`` is the server's estimate of when capacity frees up
    (queue depth x recent per-batch service time) — the reject-with-
    retry-after contract of clipper-style front-ends.
    """

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class ServiceUnavailableError(ServingError):
    """Admission shed because the engine's dispatch circuit breaker is
    OPEN (the device has been failing every dispatch): rather than
    admitting requests that would queue, dispatch into a dead device,
    and time out one batch at a time, the server fails them at submit
    with ``retry_after_s`` = the breaker's remaining cool-down.  Same
    retry-later contract as :class:`QueueFullError`, different cause —
    the queue has room; the device does not.
    """

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class QuotaExceededError(QueueFullError):
    """Fleet admission rejected THIS TENANT: its token-bucket rate quota
    is exhausted or its in-flight cap is reached (other tenants are
    unaffected — that is the point of per-tenant admission).  Subclasses
    :class:`QueueFullError` so existing retry-later client handling
    keeps working; ``retry_after_s`` is the token-refill estimate (capped
    — a zero-quota tenant is never admitted and gets the cap).
    """

    def __init__(self, message: str, retry_after_s: float = 0.0,
                 tenant: str = ""):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant


class DeadlineExceededError(ServingError):
    """The request's deadline expired while it waited in the queue; it was
    shed before dispatch (no device work was spent on it)."""


class DispatchTimeoutError(ServingError):
    """The model call for this request's batch exceeded the server's
    ``dispatch_timeout_ms``: the batch's futures fail, the stalled worker
    is abandoned, and later batches proceed."""


class ServerClosedError(ServingError):
    """The server is closed (or closing): no new requests are admitted."""
