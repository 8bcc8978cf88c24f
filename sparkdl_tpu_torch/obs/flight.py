"""Flight recorder: the stack's incident black box (port of
``sparkdl_tpu/obs/flight.py``).

A process-global, bounded, lock-cheap ring of structured STATE-CHANGE
events (health transitions, breaker open/half-open/close, admission sheds,
cache hits and evictions, head swaps, fault-injection firings, retry
attempts, SLO breaches, cost regressions), each stamped with wall time,
monotonic time and the active trace id from
:mod:`sparkdl_tpu_torch.obs.trace`, so a post-mortem can correlate the
event stream with the span tree of the request that tripped it.

Gate: ``SPARKDL_BLACKBOX`` (the ``SPARKDL_TRACE`` grammar)
  * ``""``/``0``/``false``/``off``/``no``: DISABLED (default).
    :func:`emit` is one module-global read and an identity check.
  * ``1``/``true``/``on``/``yes``: enabled, in-memory ring only (read it
    with :func:`get_recorder` ``.snapshot()``).
  * anything else: a DIRECTORY; enabled, and the ring is durably dumped to
    ``flight_<pid>.jsonl`` there (fsync'd JSONL through
    :class:`~sparkdl_tpu_torch.utils.jsonl.CrashSafeJsonlWriter`, torn-tail
    tolerant on read) at ``atexit``, on ``SIGTERM`` (the previous handler
    is chained), on explicit :meth:`FlightRecorder.dump`, and on every
    ready->degraded health transition.

Event names come from ONE catalog (:data:`EVENT_HELP`, the JAX package's):
:meth:`FlightRecorder.record` refuses unregistered names at emit time.

Thread model: events are emitted from admission threads, dispatch workers,
the batcher and signal/atexit handlers.  The ring lock guards only the
O(1) append and the snapshot copy; the dump lock serializes file appends
(each event is written once: a monotonic ``seq`` marks how far the file
has caught up).  ``emit`` is always called OUTSIDE the caller's own locks,
so the recorder never deadlocks the paths it observes.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.obs.trace import current_trace_id
from sparkdl_tpu_torch.utils.jsonl import CrashSafeJsonlWriter, read_jsonl
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "EVENT_HELP",
    "EVENTS",
    "validate_event",
    "FlightRecorder",
    "emit",
    "get_recorder",
    "configure",
    "configure_from_env",
    "blackbox_from_env",
    "load_flight",
]

#: event -> operator-facing description of the state change it records:
#: the JAX package's catalog, copied whole (as ``faults.sites.SITE_HELP``
#: is), so that a dump from either package reads the same.  The stream
#: scorer emits ``stream.stall``, ``stream.stall_recovered``,
#: ``stream.redelivery`` and ``stream.commit``; the compile cache
#: ``compile.persist`` and ``compile.invalidate`` (for the port's kernel
#: libraries: "XLA" and "lockfile" in their text read as nvcc's libraries
#: and the cache manifest); the twin ``twin.scenario``, ``policy.adjust``
#: and ``placement.plan``.
EVENT_HELP = {
    "health.ready": ("a HealthTracker recovered: degraded -> ready "
                     "(attrs name the tracker)"),
    "health.degraded": ("a HealthTracker degraded: ready -> degraded — "
                        "also triggers a durable dump when a blackbox "
                        "directory is configured"),
    "breaker.open": ("consecutive device errors opened a dispatch "
                     "circuit breaker"),
    "breaker.half_open": ("breaker cooldown elapsed; one trial dispatch "
                          "admitted"),
    "breaker.close": "a trial dispatch succeeded; breaker closed",
    "serving.shed": ("Server shed a request (queue full, breaker open, "
                     "or deadline expired — see attrs.reason)"),
    "serving.drain": "Server.close() began stopping/draining",
    "batch.topoff": ("a forming ragged micro-batch absorbed late "
                     "arrivals up to its bucket boundary before "
                     "dispatch (attrs: rows pulled, base fill, bucket)"),
    "compile.persist": ("persistent XLA compile cache enabled and "
                        "validated against the committed program "
                        "lockfile (attrs name the dir and whether an "
                        "existing population was reused)"),
    "compile.invalidate": ("program-lockfile drift invalidated the "
                           "persistent compile cache — stale entries "
                           "purged, drift classified back to the GC "
                           "rule whose invariant moved"),
    "cache.hit": ("inference cache served a result without an engine "
                  "dispatch (digest re-check passed)"),
    "cache.miss": ("inference cache miss — this request became the "
                   "single-flight leader and pays the dispatch"),
    "cache.coalesced": ("a request parked on an identical in-flight "
                        "leader (zero extra dispatches)"),
    "cache.evict": ("the bounded cache evicted an LRU entry to honor "
                    "its entries/bytes cap"),
    "cache.invalidate": ("cache entries dropped (hot-swap with a "
                         "changed fingerprint, or a corrupt entry "
                         "caught by the digest re-check)"),
    "cache.feature_hit": ("feature-cut cache served a backbone "
                          "featurization without a backbone dispatch — "
                          "the request pays head-milliseconds only "
                          "(head-fanout tier; attrs carry the tenant)"),
    "head.swap": ("a head bank mutated (add/swap/evict of one tenant's "
                  "head) with the backbone program untouched — attrs "
                  "carry tenant, op, and the bank size"),
    "rollout.start": "fleet canary rollout started (stable + canary live)",
    "rollout.promote": "fleet rollout promoted; old version draining",
    "rollout.rollback": "fleet rollout rolled back; canary draining",
    "fleet.shed": ("fleet admission shed a tenant request (priority/"
                   "pressure/quota/in-flight cap — see attrs.reason)"),
    "stream.stall": "stream source silent past the watchdog deadline",
    "stream.stall_recovered": "a stalled stream source yielded again",
    "stream.redelivery": ("restart replayed a chunk a previous run left "
                          "uncommitted"),
    "stream.commit": "a stream chunk's journal commit reached disk",
    "twin.scenario": ("the traffic twin entered a scenario phase "
                      "(flash crowd, retry storm, canary start — attrs "
                      "carry the virtual time and phase)"),
    "policy.adjust": ("the twin policy engine changed a control knob "
                      "(tenant quota, deadline, canary fraction — "
                      "attrs carry the lever and new value)"),
    "placement.plan": ("the HBM-aware placement planner produced a "
                       "fleet-to-mesh-slice plan (attrs carry chips, "
                       "per-chip bytes and the plan digest)"),
    "fault.fired": "an injected fault rule fired at its site",
    "retry.attempt": "a transient failure is about to be re-executed",
    "slo.breach": "an SLO's burn rate crossed its threshold",
    "slo.recovered": "a breaching SLO's burn rate dropped back under",
    "cost.regression": ("a program's rolling device-time/row crossed "
                        "the cost sentinel's baseline or lockfile-"
                        "analytic threshold (attrs carry the program, "
                        "factor and measured/baseline us-per-row)"),
    "cost.recovered": ("a regressed program's device-time/row dropped "
                       "back under the recovery threshold"),
}

#: Registered event names, in layer order (derived from EVENT_HELP so
#: the catalog cannot drift from its documentation — the SITES pattern).
EVENTS: Tuple[str, ...] = tuple(EVENT_HELP)

_OFF = ("", "0", "false", "off", "no")
_ON = ("1", "true", "on", "yes")


def validate_event(name: str) -> str:
    """Return ``name`` if cataloged, else raise ``ValueError`` naming
    the known events: the emit-time gate."""
    if name not in EVENT_HELP:
        raise ValueError(
            f"unknown flight event {name!r}; register it in "
            f"obs/flight.py EVENT_HELP (known: {', '.join(EVENTS)})")
    return name


def blackbox_from_env():
    """``(enabled, out_dir)`` from ``SPARKDL_BLACKBOX`` — the
    ``SPARKDL_TRACE`` grammar (``0|1|dir``, see module docstring)."""
    raw = os.environ.get("SPARKDL_BLACKBOX", "").strip()
    low = raw.lower()
    if low in _OFF:
        return False, None
    if low in _ON:
        return True, None
    return True, raw


def _jsonable(v: Any) -> Any:
    """Events must always serialize: scalars pass through, anything
    else (an exception, a numpy scalar) is stringified at emit time."""
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    return str(v)


class FlightRecorder:
    """The bounded event ring plus its durable dump channel.

    ``capacity`` bounds memory (oldest events evicted first — the black
    box records the RECENT past, like its aviation namesake).  With an
    ``out_dir``, :meth:`dump` appends every not-yet-dumped event to
    ``flight_<pid>.jsonl`` with one fsync'd write per line, so a crash
    between dumps loses at most the events since the last trigger — and
    ready->degraded transitions trigger a dump synchronously, which is
    exactly when the next instants stop being trustworthy.
    """

    def __init__(self, out_dir: Optional[str] = None,
                 capacity: int = 4096):
        self.out_dir = out_dir
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = named_lock("obs.flight.ring")
        self._seq = itertools.count(1)  # next() is atomic in CPython
        self._dump_lock = named_lock("obs.flight.dump")
        self._writer: Optional[CrashSafeJsonlWriter] = None
        self._dumped_seq = 0
        self._dump_path = (os.path.join(out_dir,
                                        f"flight_{os.getpid()}.jsonl")
                           if out_dir else None)

    # -- the hot hook ------------------------------------------------------
    def record(self, name: str,
               attrs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Append one event.  Stamps wall time (``t_wall`` — the only
        cross-process clock), monotonic time (``t_mono`` — orders events
        and joins the span timeline), and the caller thread's active
        trace id (None when tracing is off), then appends under the ring
        lock.  A ``health.degraded`` event additionally triggers a
        durable dump (see class docstring)."""
        validate_event(name)
        ev: Dict[str, Any] = {
            "seq": next(self._seq),
            "event": name,
            "t_wall": round(time.time(), 6),
            "t_mono": round(time.monotonic(), 6),
            "pid": os.getpid(),
            "trace_id": current_trace_id(),
        }
        if attrs:
            ev["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._ring.append(ev)
        if self._dump_path is not None and name == "health.degraded":
            self.dump()
        return ev

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Current ring contents, oldest first, as copies (the JSONL
        record schema of a dump)."""
        with self._lock:
            events = list(self._ring)
        return [dict(e) for e in events]

    # -- durability --------------------------------------------------------
    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Durably persist the ring.

        With an explicit ``path``: write the FULL current snapshot there
        (truncating; a one-off export).  Without one: append every event
        not yet on disk to the configured ``flight_<pid>.jsonl``
        (incremental — each event is written exactly once across atexit/
        SIGTERM/degraded-transition triggers).  Returns the path written,
        or None when nothing is configured or the disk refused (the
        recorder is a rider on the real work, never a reason to fail it
        — the ``utils.jsonl`` failure policy)."""
        if path is not None:
            w = CrashSafeJsonlWriter(path)
            w.reset()
            ok = True
            for ev in self.snapshot():
                ok = w.write_line(json.dumps(ev)) and ok
            w.close()
            return path if ok else None
        if self._dump_path is None:
            return None
        with self._dump_lock:
            if self._writer is None:
                self._writer = CrashSafeJsonlWriter(self._dump_path)
            with self._lock:
                events = [dict(e) for e in self._ring
                          if e["seq"] > self._dumped_seq]
            for ev in events:
                if not self._writer.write_line(json.dumps(ev)):
                    return None
                self._dumped_seq = ev["seq"]
        return self._dump_path

    def close(self) -> None:
        with self._dump_lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None


def load_flight(path: str) -> List[Dict[str, Any]]:
    """Read a flight dump back, tolerating the torn tail a crash
    mid-append can leave (:func:`~sparkdl_tpu_torch.utils.jsonl.
    read_jsonl`)."""
    records, _ = read_jsonl(path)
    return records


# -- module singleton (the faults.inject pattern) --------------------------
_UNSET = object()   # before the first emit() consults SPARKDL_BLACKBOX
_recorder: Any = _UNSET
_recorder_lock = named_lock("obs.flight.configure")
_atexit_registered = False
_prev_sigterm: Any = None
_sigterm_installed = False


def emit(name: str, **attrs: Any) -> Optional[Dict[str, Any]]:
    """The instrumentation hook state-change sites call.

    Disabled path (``SPARKDL_BLACKBOX`` unset): one module-global read, an
    identity check and a return.  The env var is consulted exactly once,
    on the first call, after which the global is either a recorder or
    ``None``."""
    r = _recorder
    if r is None:
        return None
    if r is _UNSET:
        r = configure_from_env()
        if r is None:
            return None
    return r.record(name, attrs)


def get_recorder() -> Optional[FlightRecorder]:
    """The active recorder (resolving the env on first ask), or None."""
    r = _recorder
    if r is _UNSET:
        return configure_from_env()
    return r


def _dump_current() -> None:
    r = _recorder
    if r is not None and r is not _UNSET:
        r.dump()


def _register_atexit() -> None:
    global _atexit_registered
    if _atexit_registered:
        return
    import atexit

    # Dump whatever recorder is CURRENT at exit (configure() may have
    # replaced the one that registered the hook) — the obs.trace pattern.
    atexit.register(_dump_current)
    _atexit_registered = True


def _sigterm_handler(signum, frame) -> None:
    """Dump, then hand the signal on: a chained previous handler runs
    as before; a process that deliberately IGNORED SIGTERM keeps
    ignoring it (installing a recorder must not change signal
    semantics); otherwise the default disposition is restored and the
    signal re-raised so SIGTERM still terminates the process."""
    import signal

    try:
        _dump_current()
    except Exception as e:  # noqa: BLE001 — a dump failure must not mask the signal
        logger.warning("flight dump on SIGTERM failed: %s: %s",
                       type(e).__name__, e)
    prev = _prev_sigterm
    if prev is signal.SIG_IGN:
        return
    if callable(prev):
        prev(signum, frame)
    else:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _install_sigterm() -> None:
    global _prev_sigterm, _sigterm_installed
    if _sigterm_installed:
        return
    import signal

    if threading.current_thread() is not threading.main_thread():
        return  # signal handlers can only be installed from the main thread
    try:
        _prev_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _sigterm_handler)
        _sigterm_installed = True
    except (ValueError, OSError):  # non-main interpreter contexts
        _sigterm_installed = False


def configure(enabled: bool = True, out_dir: Optional[str] = None,
              capacity: int = 4096) -> Optional[FlightRecorder]:
    """Replace the process recorder programmatically (tests, bench).
    ``enabled=False`` disables emission outright (and stops consulting
    the env).  With an ``out_dir``, the atexit and SIGTERM dump hooks
    are installed (once per process)."""
    global _recorder
    with _recorder_lock:
        _recorder = (FlightRecorder(out_dir=out_dir, capacity=capacity)
                     if enabled else None)
        recorder = _recorder
    if recorder is not None and out_dir:
        _register_atexit()
        _install_sigterm()
    return recorder


def configure_from_env() -> Optional[FlightRecorder]:
    """(Re-)configure the process recorder from ``SPARKDL_BLACKBOX``."""
    enabled, out_dir = blackbox_from_env()
    return configure(enabled=enabled, out_dir=out_dir)
