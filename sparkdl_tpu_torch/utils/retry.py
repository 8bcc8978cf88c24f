"""Retry with jittered, capped exponential backoff (port of
``sparkdl_tpu/utils/retry.py``).  Every re-execution is a
``retry.attempt`` flight event.

The engine's dispatch retry budget runs through :func:`with_retries`;
:func:`fit_with_retries` retries an estimator's fit, which with
``fitParams={"checkpoint_dir": ...}`` resumes at the newest epoch
checkpoint, so a retry repeats only the epoch that failed.
Jitter draws come from an explicit ``random.Random`` when one is given, so
a test can fix the sequence; with none they come from the ``random``
module's global generator, as in the JAX package.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Tuple, Type

from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# Deterministic failures: retrying reproduces the identical error.
# FloatingPointError is a NaN fail-fast; ValueError / TypeError are
# parameter and shape validation.
NON_RETRYABLE: Tuple[Type[BaseException], ...] = (
    FloatingPointError, ValueError, TypeError)


def backoff_delay(attempt: int, backoff_seconds: float,
                  max_backoff_seconds: Optional[float] = None,
                  jitter: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
    """The sleep before re-execution ``attempt`` (0-based): exponential
    ``backoff_seconds * 2**attempt``, scaled by a uniform draw from
    ``[1 - jitter, 1]``, then capped at ``max_backoff_seconds`` (the cap
    applies after the jitter, so it holds whatever the draw)."""
    delay = backoff_seconds * (2 ** attempt)
    if jitter:
        j = min(1.0, max(0.0, float(jitter)))
        delay *= 1.0 - j * (rng or random).random()
    if max_backoff_seconds is not None:
        delay = min(delay, max_backoff_seconds)
    return max(0.0, delay)


def with_retries(fn: Callable[[], Any], *, max_retries: int = 2,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 non_retryable: Tuple[Type[BaseException], ...]
                 = NON_RETRYABLE,
                 backoff_seconds: float = 0.0,
                 max_backoff_seconds: Optional[float] = None,
                 jitter: float = 0.0,
                 on_retry: Optional[Callable[[int, BaseException], None]]
                 = None,
                 rng: Optional[random.Random] = None) -> Any:
    """Run ``fn()`` with up to ``max_retries`` re-executions.

    ``KeyboardInterrupt``/``SystemExit`` always propagate, as does anything
    in ``non_retryable``.  ``on_retry(attempt_index, exception)`` runs
    before each re-execution.  The sleep before re-execution ``i`` is
    :func:`backoff_delay` ``(i, backoff_seconds, max_backoff_seconds,
    jitter, rng)``, so the added latency is at most ``max_retries *
    max_backoff_seconds``."""
    attempts = max(0, int(max_retries)) + 1
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except non_retryable:
            raise
        except retry_on as e:
            last = e
            if attempt == attempts - 1:
                break
            logger.warning("attempt %d/%d failed (%s: %s); retrying",
                           attempt + 1, attempts, type(e).__name__, e)
            flight_emit("retry.attempt", attempt=attempt + 1,
                        of=attempts, error=type(e).__name__)
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_seconds:
                time.sleep(backoff_delay(attempt, backoff_seconds,
                                         max_backoff_seconds, jitter, rng))
    assert last is not None
    raise last


def fit_with_retries(estimator, dataset, params=None, *,
                     max_retries: int = 2,
                     non_retryable: Tuple[Type[BaseException], ...]
                     = NON_RETRYABLE,
                     backoff_seconds: float = 0.0,
                     max_backoff_seconds: Optional[float] = None,
                     jitter: float = 0.0,
                     on_retry: Optional[Callable] = None):
    """``estimator.fit(dataset, params)`` under :func:`with_retries`.

    With ``fitParams={"checkpoint_dir": ...}`` each retry resumes from the
    newest epoch checkpoint, so a transient failure (preemption, host
    memory, flaky storage) costs one epoch of recompute; without it each
    retry fits from scratch (still correct: a fit is idempotent)."""
    return with_retries(lambda: estimator.fit(dataset, params),
                        max_retries=max_retries,
                        non_retryable=non_retryable,
                        backoff_seconds=backoff_seconds,
                        max_backoff_seconds=max_backoff_seconds,
                        jitter=jitter,
                        on_retry=on_retry)
