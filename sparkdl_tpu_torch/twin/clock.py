"""Virtual monotonic time, the axis the traffic twin replays a day on
(port of ``sparkdl_tpu/twin/clock.py``).

A :class:`VirtualClock` is a zero-argument callable returning monotonic
seconds, shaped like ``time.monotonic``, so it plugs into every ``clock=``
of the serving stack (``Fleet``, ``Server``, ``DynamicBatcher``,
``AdmissionController``, ``SLOEngine``).  It moves only when
:meth:`advance` is called, so a simulated day of token-bucket refills,
wait-window flushes, deadline expiries and SLO burn windows plays out in
however little wall time the work takes, and identically on every run.

It starts at ``0.0``, not at some process-relative monotonic offset, so
every virtual timestamp is relative to the scenario: two runs of one seed
give byte-identical event lines.
"""

from __future__ import annotations

from sparkdl_tpu_torch.analysis.lockcheck import named_lock


class VirtualClock:
    """Injectable monotonic clock that advances only on demand.

    Thread-safe: the serving stack reads it from submitter, dispatcher and
    worker threads while the twin's own thread advances it, and reads
    take the lock so that no reader sees a torn float.
    """

    def __init__(self, start: float = 0.0):
        self._lock = named_lock("twin.clock")
        self._now = float(start)

    def __call__(self) -> float:
        with self._lock:
            return self._now

    @property
    def now(self) -> float:
        return self()

    def advance(self, dt: float) -> float:
        """Move virtual time forward by ``dt`` seconds (never backward: the
        clock keeps ``time.monotonic``'s contract) and return the new now.
        The caller wakes whatever wait windows the jump may have satisfied
        (``Fleet.wake``)."""
        if dt < 0:
            raise ValueError(f"virtual time cannot move backward "
                             f"(dt={dt})")
        with self._lock:
            self._now += float(dt)
            return self._now
