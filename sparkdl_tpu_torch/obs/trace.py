"""Low-overhead span tracing for the scoring stack (port of
``sparkdl_tpu/obs/trace.py``).

A :class:`Tracer` issues trace and span IDs that propagate serving request
-> batcher micro-batch -> engine call -> engine dispatch -> pipeline stage,
recording parent/child spans (wall clock on the profiler's timeline, plus
device time where a stage must wait for the card anyway) into a bounded
ring (a ``deque(maxlen)`` whose lock guards only the O(1) append and the
snapshot copy, never span construction).

Clock: a span's ``t0``/``t1`` are Unix seconds, as Kineto stamps the
records of a ``torch.profiler`` trace, kept monotonic by running them off
``perf_counter`` from one anchor taken at import.  The exported
``ts_us`` (and the Chrome trace's ``ts``) are Unix microseconds: a span
lies at a profiler record's ``ts`` + ``baseTimeNanoseconds`` / 1e3.

Device time, two ways: :meth:`Span.block_until_ready` records an event on
the current CUDA stream, waits for that event (never for the whole
device) and credits the wait to ``device_s``, as the JAX span credits
``jax.block_until_ready``; and the engine brackets each replay (or eager
forward) with a pair of timing events while tracing is on and annotates
their elapsed time as ``device_ms`` on the span that forces the result
(:mod:`sparkdl_tpu_torch.parallel.engine`).

Gate: ``SPARKDL_TRACE``
  * ``""``/``0``/``false``/``off``/``no``: DISABLED (default).  Every
    instrumentation site does one check and receives the shared no-op
    :data:`NULL_SPAN`: no IDs, no timestamps, no ring writes, no profiler
    ranges, no CUDA events, and ``NULL_SPAN.block_until_ready`` never
    blocks.
  * ``1``/``true``/``on``/``yes``: enabled, in-memory ring only (read it
    with :meth:`Tracer.snapshot` / ``obs.export``).
  * anything else: a DIRECTORY; enabled, and an ``atexit`` hook flushes
    ``trace_<pid>.json`` (Chrome trace-event JSON, for Perfetto or
    chrome://tracing) plus ``spans_<pid>.jsonl`` there at interpreter exit
    (or call :meth:`Tracer.flush` yourself).

Under a profiler: while a ``torch.profiler`` collects in the process and
``SPARKDL_TRACE`` is off, spans are recorded into the ring as well, as
*profiled* spans that change nothing of what the host does: no CUDA
timing events (the profiler's trace has the kernels), and
``block_until_ready`` passes its value through without waiting.  A span
used as a context manager on a thread the profiler records (the thread
that started it) also opens a ``record_function`` range of its name, so
that it appears in the profiler's trace; :meth:`Tracer.start_span` spans
go to the ring only.

Thread model: spans cross threads by design (a serving request is admitted
on the caller's thread, batched on the batcher thread, dispatched on a
worker).  Parenting composes two mechanisms: an explicit ``parent=`` for
cross-thread edges, and a per-thread current-span stack
(``tracer.span(...)`` as a context manager pushes; :meth:`Tracer.use`
re-roots a thread onto a span started elsewhere), so same-thread nesting
is automatic.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from sparkdl_tpu_torch.analysis.lockcheck import named_lock

__all__ = [
    "Span",
    "NULL_SPAN",
    "Tracer",
    "get_tracer",
    "configure",
    "configure_from_env",
    "current_trace_id",
    "tracing_from_env",
]

_OFF = ("", "0", "false", "off", "no")
_ON = ("1", "true", "on", "yes")

# perf_counter + _UNIX_OFFSET: Unix seconds, as Kineto stamps its records
_UNIX_OFFSET = (time.time_ns() - time.perf_counter_ns()) / 1e9


def _now() -> float:
    """Now on the spans' clock (see the module docstring)."""
    return time.perf_counter() + _UNIX_OFFSET


def tracing_from_env():
    """``(enabled, out_dir)`` from ``SPARKDL_TRACE``: the one parser every
    gate shares (``0|1|dir``, see the module docstring)."""
    raw = os.environ.get("SPARKDL_TRACE", "").strip()
    low = raw.lower()
    if low in _OFF:
        return False, None
    if low in _ON:
        return True, None
    return True, raw


def _cuda_wait(x) -> None:
    """Wait for the card to finish ``x``: a ``torch.cuda.Event`` is waited
    on; for a tensor (or a dict / list / tuple of them) an event is
    recorded on the current stream of each CUDA device they live on and
    waited on.  Never ``torch.cuda.synchronize()``; nothing to wait for on
    the CPU."""
    import torch

    if isinstance(x, torch.cuda.Event):
        x.synchronize()
        return
    devices = set()
    stack = [x]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
    for device in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


class _NullSpan:
    """The disabled-path span: a shared, stateless no-op with the whole
    Span surface, so instrumentation sites never branch on enabled beyond
    the one check inside ``tracer.span()``."""

    __slots__ = ()
    name = None
    trace_id = None
    span_id = None
    parent_id = None
    device_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self

    def block_until_ready(self, x):
        # disabled tracing must not change when the host waits: the value
        # passes through without blocking
        return x

    def finish(self, status: str = "ok"):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed operation.  ``t0``/``t1`` are Unix seconds on one
    process-wide monotonic timeline (so spans from different threads order
    correctly, and lie where the profiler's records do); ``device_s``
    accumulates the device waits :meth:`block_until_ready` bracketed
    inside the span.  ``profiled``: recorded because a profiler collects
    (see the module docstring), not because ``SPARKDL_TRACE`` is on."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "thread", "tid", "t0", "t1", "device_s",
                 "status", "profiled", "_range")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: Dict[str, Any], profiled: bool = False):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        t = threading.current_thread()
        self.thread = t.name
        self.tid = t.ident or 0
        self.t0 = _now()
        self.t1: Optional[float] = None
        self.device_s = 0.0
        self.status = "ok"
        self.profiled = profiled
        self._range = None

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def block_until_ready(self, x):
        """Wait for the card to finish ``x`` (a tensor tree or a
        ``torch.cuda.Event``) inside this span, crediting the wait to
        ``device_s``: an event recorded on the current stream and waited on,
        never a whole-device synchronize.  Use only where the stage must
        wait anyway (the gather), never on the dispatch path.  A profiled
        span passes ``x`` through without waiting."""
        if self.profiled:
            return x
        t0 = time.perf_counter()
        _cuda_wait(x)
        self.device_s += time.perf_counter() - t0
        return x

    def finish(self, status: str = "ok") -> "Span":
        """Close the span and record it.  Idempotent under races: the claim
        (t1 check-and-set) and the ring append happen in one ring-lock
        hold, so concurrent finishers (a worker's demux and the stall
        watchdog settling the same batch) record the span exactly once;
        the first caller's timestamp and status win."""
        t1 = _now()
        tracer = self.tracer
        with tracer._ring_lock:
            if self.t1 is not None:
                return self
            self.t1 = t1
            if status != "ok":
                self.status = status
            tracer._ring.append(self)
        return self

    # -- context-manager form: push/pop the thread-current stack -------
    def __enter__(self) -> "Span":
        self.tracer._push(self)
        # the profiler records ranges on the thread that started it only;
        # stamped inside the range, as the profiler stamps its start
        if self.profiled and torch._C._autograd._profiler_enabled():
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
            self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.tracer._pop(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.finish("error" if exc_type is not None else "ok")
        return False

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts_us": round(self.t0 * 1e6, 1),
            "dur_us": round(((self.t1 if self.t1 is not None
                              else _now()) - self.t0) * 1e6, 1),
            "thread": self.thread,
            "tid": self.tid,
            "status": self.status,
        }
        if self.device_s > 0.0:
            d["device_us"] = round(self.device_s * 1e6, 1)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class _Use:
    """Context manager re-rooting THIS thread's current-span stack onto a
    span started elsewhere (a cross-thread continuation) without finishing
    it on exit."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self.tracer._push(self.span)
        return self.span

    def __exit__(self, *exc):
        self.tracer._pop(self.span)
        return False


class Tracer:
    """Issues IDs, tracks per-thread current spans, and keeps finished
    spans in a bounded ring (oldest evicted first)."""

    def __init__(self, enabled: bool = False,
                 out_dir: Optional[str] = None,
                 capacity: int = 8192):
        self.enabled = bool(enabled)
        self.out_dir = out_dir
        self.capacity = int(capacity)
        # the lock guards only the O(1) append and the snapshot copy:
        # readers (snapshot, exemplar capture under live traffic) would
        # otherwise race iteration against appends
        self._ring: deque = deque(maxlen=self.capacity)
        self._ring_lock = named_lock("obs.trace.ring")
        self._ids = itertools.count(1)  # next() is atomic in CPython
        self._local = threading.local()

    # -- ids / context -------------------------------------------------
    def _next(self) -> int:
        return next(self._ids)

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # tolerate out-of-order exits
            stack.remove(span)

    def current(self) -> Optional[Span]:
        """This thread's innermost open span (None outside any span)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # -- span creation -------------------------------------------------
    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        """A span as a context manager: nests under ``parent`` (or this
        thread's current span; a new trace root when neither exists) and
        records itself on exit.  :data:`NULL_SPAN` when disabled and no
        profiler collects; a profiled span when only a profiler does."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return NULL_SPAN
        return self._make(name, parent, attrs)

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **attrs):
        """A manually finished span for operations that cross threads (a
        serving request: started at submit on the caller's thread, finished
        at settle on a worker).  Not pushed on any thread's stack: pair
        with :meth:`use` to parent same-thread children under it, and call
        :meth:`Span.finish` once.  Gated as :meth:`span`; it opens no
        profiler range."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return NULL_SPAN
        return self._make(name, parent, attrs)

    def _make(self, name, parent, attrs) -> Span:
        if parent is None:
            parent = self.current()
        if parent is None or parent is NULL_SPAN:
            trace_id = f"t{self._next():06x}"
            parent_id = None
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        return Span(self, name, trace_id, f"s{self._next():06x}",
                    parent_id, attrs, profiled=not self.enabled)

    def use(self, span):
        """Make ``span`` this thread's current parent for the ``with``
        block (a no-op for None and the null span)."""
        if span is None or span is NULL_SPAN:
            return NULL_SPAN
        return _Use(self, span)

    # -- ring ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Finished spans, oldest first, as plain dicts (the span JSONL
        schema ``obs.export`` reads)."""
        with self._ring_lock:
            spans = list(self._ring)
        return [s.as_dict() for s in spans]

    def trace_spans(self, trace_id: str) -> List[Dict[str, Any]]:
        """The finished spans of one trace, oldest first: :meth:`snapshot`
        filtered by ``trace_id``, without converting the rest of the ring
        (the exemplar capture's read)."""
        with self._ring_lock:
            spans = [s for s in self._ring if s.trace_id == trace_id]
        return [s.as_dict() for s in spans]

    def clear(self) -> None:
        with self._ring_lock:
            self._ring.clear()

    # -- flush ---------------------------------------------------------
    def flush(self, out_dir: Optional[str] = None) -> List[str]:
        """Write the ring to ``out_dir`` (default: the directory from
        ``SPARKDL_TRACE=<dir>``): Chrome trace-event JSON and span JSONL.
        Returns the written paths ([] when there is nothing to write or no
        directory is configured)."""
        out_dir = out_dir or self.out_dir
        spans = self.snapshot()
        if not out_dir or not spans:
            return []
        from sparkdl_tpu_torch.obs.export import (write_chrome_trace,
                                                  write_spans_jsonl)

        os.makedirs(out_dir, exist_ok=True)
        pid = os.getpid()
        chrome = os.path.join(out_dir, f"trace_{pid}.json")
        jsonl = os.path.join(out_dir, f"spans_{pid}.jsonl")
        write_chrome_trace(chrome, spans)
        write_spans_jsonl(jsonl, spans)
        return [chrome, jsonl]


# -- module singleton ------------------------------------------------------
_tracer: Optional[Tracer] = None
_tracer_lock = named_lock("obs.trace.configure")
_atexit_registered = False


def _register_atexit() -> None:
    global _atexit_registered
    if _atexit_registered:
        return
    import atexit

    # flush whatever tracer is CURRENT at exit (configure() may have
    # replaced the one that registered the hook)
    atexit.register(lambda: _tracer is not None and _tracer.flush())
    _atexit_registered = True


def get_tracer() -> Tracer:
    """The process tracer, configured from ``SPARKDL_TRACE`` on first use.
    Cheap on hot paths: one global read and a None check afterwards."""
    t = _tracer
    if t is not None:
        return t
    return configure_from_env()


def configure(enabled: bool = True, out_dir: Optional[str] = None,
              capacity: int = 8192) -> Tracer:
    """Replace the process tracer (tests, the smoke).  A fresh tracer
    starts with an empty ring."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(enabled=enabled, out_dir=out_dir,
                         capacity=capacity)
        if out_dir:
            _register_atexit()
        return _tracer


def configure_from_env() -> Tracer:
    """(Re-)configure the process tracer from ``SPARKDL_TRACE``."""
    enabled, out_dir = tracing_from_env()
    return configure(enabled=enabled, out_dir=out_dir)


def current_trace_id() -> Optional[str]:
    """The calling thread's current trace id, or None: the hook of the
    trace-id-aware log format and the flight recorder; near-free while
    tracing is off (one global read, no tracer construction)."""
    t = _tracer
    if t is None or not t.enabled:
        return None
    s = t.current()
    return s.trace_id if s is not None else None
