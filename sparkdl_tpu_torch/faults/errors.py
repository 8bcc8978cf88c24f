"""Injected-fault error taxonomy (port of ``sparkdl_tpu/faults/errors.py``).

Every exception the harness raises is a distinct type, so the code under
test can be held to route it: transient faults are retried
(:class:`InjectedTransientError` is a plain ``RuntimeError``), deterministic
ones fail fast (:class:`InjectedFatalError` and :class:`InjectedDecodeError`
subclass ``ValueError``, which ``utils.retry.NON_RETRYABLE`` holds), and a
sticky dead device (:class:`InjectedDeadDeviceError`) trips the engine's
circuit breaker.  Each carries ``site`` (where it fired) and ``rule`` (the
canonical spec clause).
"""

from __future__ import annotations


class InjectedFault(RuntimeError):
    """Base class of every fault the harness injects."""

    def __init__(self, message: str, site: str = "", rule: str = ""):
        super().__init__(message)
        self.site = site
        self.rule = rule


class InjectedTransientError(InjectedFault):
    """A one-off device or runtime hiccup: the retryable kind."""


class InjectedDeadDeviceError(InjectedFault):
    """A sticky device death: once a ``dead`` rule fires, every later call
    at its site raises this."""


class InjectedFatalError(InjectedFault, ValueError):
    """A deterministic failure (bad shapes or parameters): never retried."""


class InjectedDecodeError(InjectedFault, ValueError):
    """A corrupt-input decode failure mid-stream."""
