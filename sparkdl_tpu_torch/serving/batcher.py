"""Dynamic micro-batching: bounded admission queue + flush policy (port of
``sparkdl_tpu/serving/batcher.py``).

Single requests accumulate in a bounded FIFO and flush as one micro-batch
when the batch is full (``max_batch_size``) or the OLDEST waiting request
has waited ``max_wait_ms``: light traffic pays at most one wait window of
latency and heavy traffic amortizes dispatch over full batches.

Continuous ragged batching: when the batcher knows the server's bucket
plan, an age/deadline-triggered flush cuts the queue at the largest bucket
boundary the depth covers, so that cut dispatches with zero pad rows and
only the true sub-bucket residual pads.  The residual can still be topped
off by late arrivals right up to dispatch (:meth:`DynamicBatcher.top_off`,
pulled by ``Server._execute`` after it picks the bucket).
``SPARKDL_RAGGED=0`` restores the flush-on-full baseline
(:func:`ragged_enabled_from_env`).

The batcher owns admission (backpressure via ``QueueFullError``), the
flush policy and deadline shedding at flush time; the
:class:`~sparkdl_tpu_torch.serving.server.Server` owns bucketing, dispatch
and demultiplexing.  Given the same arrival script under the same injected
clock, the flush sequence (batch sizes, members, ragged cuts, top-offs,
shed and rejected requests) is the JAX package's.

Observability, as in the JAX package: a flushed micro-batch opens the
``serving.microbatch`` span under its first live request's root span
(the other members' trace ids ride on it as ``member_traces``), and every
queue-full rejection and deadline shed is a ``serving.shed`` flight event,
emitted once the batcher's lock is released.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.analysis.lockcheck import named_condition
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.obs.trace import get_tracer
from sparkdl_tpu_torch.parallel.engine import _tree_leaves
from sparkdl_tpu_torch.serving.errors import (DeadlineExceededError,
                                              QueueFullError,
                                              ServerClosedError)
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)


def ragged_enabled_from_env() -> bool:
    """``SPARKDL_RAGGED`` (default ON).  ``0``/``false``/``off``/``no``
    restore the flush-on-full baseline: an age-triggered flush takes
    everything waiting and pads it into the nearest bucket."""
    raw = os.environ.get("SPARKDL_RAGGED", "").strip().lower()
    return raw not in ("0", "false", "off", "no")


class Request:
    """One admitted example: payload + completion future + queue timing.

    ``deadline`` is absolute seconds on the batcher's clock (None = no
    deadline).  The future settles exactly once: with the model output row,
    or with a serving error (shed / rejected / batch failure).  ``tenant``
    is the cost-attribution identity (which ledger line the request's
    device and queue time land on); anonymous = ``"default"``, as in the
    JAX package.

    Tracing (``SPARKDL_TRACE``): ``span`` is the request's root span
    (opened at submit, closed at settle); ``batch_span`` rides the FIRST
    live request of a flushed micro-batch and carries the batcher ->
    engine segment.  Both stay None with tracing off."""

    __slots__ = ("payload", "future", "enqueued_at", "deadline", "tenant",
                 "span", "batch_span")

    def __init__(self, payload: Any, deadline: Optional[float] = None,
                 now: Optional[float] = None, tenant: str = "default"):
        self.payload = payload
        self.tenant = tenant
        self.future: Future = Future()
        # ``now`` lets a clock-injected caller stamp queue entry on the same
        # (possibly virtual) timeline its deadlines live on
        self.enqueued_at = time.monotonic() if now is None else now
        self.deadline = deadline
        self.span = None
        self.batch_span = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def finish_span(self, status: str = "ok") -> None:
        """Close this request's root span once (the settle paths race: the
        worker's demux, the watchdog, close; ``Span.finish`` is idempotent,
        so the losers are no-ops)."""
        sp = self.span
        if sp is not None:
            self.span = None
            sp.finish(status)


class DynamicBatcher:
    """Bounded request queue with size-or-age flush.

    Thread model: any number of submitter threads call :meth:`submit`; ONE
    dispatcher thread blocks in :meth:`next_batch`.  ``close`` may be
    called from any thread.

    ``align`` is the serving mesh's data-axis size: a raw bucket plan is
    rounded up to multiples of it, as the engine rounds its device batch
    (``effective_device_batch``), so a ragged cut lands on a bucket the
    mesh splits evenly.  A :class:`Server` passes buckets already rounded,
    so there it changes nothing; a bucket rounded above
    ``max_batch_size`` is reached only by a top-off."""

    def __init__(self, *, max_batch_size: int = 64,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 1024,
                 bucket_plan: Optional[Sequence[int]] = None,
                 align: int = 1,
                 metrics: Optional[Metrics] = None,
                 clock: Optional[Callable[[], float]] = None):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got "
                             f"{max_batch_size}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_batch_size = int(max_batch_size)
        self.align = max(1, int(align))
        if bucket_plan is not None:
            bucket_plan = sorted(int(b) for b in bucket_plan)
            if not bucket_plan or bucket_plan[0] < 1:
                raise ValueError(f"bucket_plan must be positive, got "
                                 f"{bucket_plan}")
            if self.align > 1:
                bucket_plan = sorted(
                    {b + (self.align - b % self.align) % self.align
                     for b in bucket_plan})
        self.bucket_plan = bucket_plan
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.max_queue = int(max_queue)
        # flush-early guard: a queued request whose deadline lands inside
        # the wait window flushes this long before expiry, so a timeout
        # shorter than max_wait_ms still dispatches under light load;
        # expiry is then judged at the flush decision (see next_batch)
        self.deadline_guard_s = 10e-3
        self.metrics = metrics if metrics is not None else Metrics()
        # server-maintained estimate of one batch's service time; seeds the
        # retry_after hint before the first batch completes
        self.batch_seconds_hint = max(self.max_wait_s, 1e-3)
        # every flush/age/deadline judgement reads this clock, so a virtual
        # clock drives the wait-window state machine deterministically;
        # condition WAITS still time out on the real clock (a frozen
        # virtual clock re-checks on submit and at each timeout)
        self._clock = clock if clock is not None else time.monotonic
        self._q: deque = deque()
        self._cond = named_condition("serving.batcher")
        self._closed = False

    # -- admission (submitter threads) ------------------------------------
    def submit(self, request: Request) -> None:
        """Admit one request or raise: ``ServerClosedError`` after close,
        ``QueueFullError`` (with a ``retry_after_s`` hint) when the queue
        is at capacity.  Admission never blocks the caller."""
        full = None
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is closed")
            # fault site: a queue-full storm (exc=queue_full) or an
            # admission stall (a sleep holds the batcher lock: a stalled
            # admission path); after the closed check, so injected faults
            # never mask ServerClosedError
            inject("serving.admit")
            if len(self._q) >= self.max_queue:
                self.metrics.incr("serving.rejected_queue_full")
                # capacity frees one batch at a time: full-queue drain time
                # is (depth / batch) service periods
                periods = len(self._q) / self.max_batch_size
                hint = max(1e-3, periods * self.batch_seconds_hint)
                full = (len(self._q), hint)
            else:
                self._q.append(request)
                self.metrics.gauge("serving.queue_depth",
                                   float(len(self._q)))
                self._cond.notify_all()
        if full is not None:
            depth, hint = full
            flight_emit("serving.shed", reason="queue_full", depth=depth,
                        retry_after_s=round(hint, 4))
            raise QueueFullError(
                f"admission queue full ({depth}/{self.max_queue})",
                retry_after_s=hint)

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def wake(self) -> None:
        """Nudge the dispatcher to re-evaluate its flush conditions.

        With an injected clock the age and deadline triggers move only when
        that clock does, and nothing else notifies the condition when it
        moves.  A virtual-time harness advances its clock, then calls this,
        so a wait-window flush fires at the virtual instant it would have
        fired at on the real clock."""
        with self._cond:
            self._cond.notify_all()

    # -- flush (dispatcher thread) ----------------------------------------
    def next_batch(self) -> Optional[List[Request]]:
        """Block until a micro-batch is due; return its LIVE requests.

        Flush triggers: the queue holds ``max_batch_size`` requests, the
        oldest waiting request is ``max_wait_s`` old, a queued request's
        deadline is within ``deadline_guard_s``, or the batcher is closing
        (drain).  Expired deadlines are shed here, after the flush decision
        and before any device work.  May return an empty list (whole batch
        shed); returns None only when closed and fully drained."""
        with self._cond:
            now = self._clock()
            while True:
                if self._q:
                    if self._closed:
                        break  # draining: flush whatever is left
                    now = self._clock()
                    oldest_wait = now - self._q[0].enqueued_at
                    earliest = min(
                        (r.deadline for r in self._q
                         if r.deadline is not None), default=None)
                    if (len(self._q) >= self.max_batch_size
                            or oldest_wait >= self.max_wait_s
                            or (earliest is not None
                                and earliest - now <= self.deadline_guard_s)):
                        break
                    timeout = self.max_wait_s - oldest_wait
                    if earliest is not None:
                        timeout = min(timeout, earliest - now
                                      - self.deadline_guard_s)
                    self._cond.wait(max(timeout, 1e-4))
                elif self._closed:
                    return None
                else:
                    self._cond.wait()
                    now = self._clock()
            take = min(len(self._q), self.max_batch_size)
            if self.bucket_plan is not None:
                take = self._ragged_take(len(self._q), now)
            batch = [self._q.popleft() for _ in range(take)]
            self.metrics.gauge("serving.queue_depth", float(len(self._q)))
        # expiry is judged at the flush DECISION: a request the guard
        # selected while still live dispatches even if the pop itself was
        # delayed past its deadline by scheduling jitter
        live = self._shed_expired(batch, now)
        tracer = get_tracer()
        if tracer.enabled and live:
            # the micro-batch span adopts the FIRST live request's trace
            # (one strict request -> batch -> engine chain); the sibling
            # requests keep their own root spans and are recorded on it
            live[0].batch_span = tracer.start_span(
                "serving.microbatch", parent=live[0].span,
                batch_size=len(live), shed=len(batch) - len(live),
                member_traces=[r.span.trace_id for r in live
                               if r.span is not None])
        return live

    def _ragged_take(self, depth: int, now: float) -> int:
        """How many requests this flush pops (under the condition lock):
        the largest bucket the queue depth covers (zero pad rows), or the
        whole sub-bucket residual.  A deadline about to expire past the cut
        grows it to the smallest bucket covering that request (capped at
        the largest bucket)."""
        buckets = self.bucket_plan
        # the cut never exceeds max_batch_size (a bucket can be larger
        # than the configured batch)
        depth = min(depth, self.max_batch_size)
        take = depth
        for b in reversed(buckets):
            if depth >= b:
                take = b
                break
        else:
            return depth  # sub-bucket residual: pad is the true floor
        if take >= depth:
            return take
        last_urgent = -1
        for i in range(take, depth):
            r = self._q[i]
            if (r.deadline is not None
                    and r.deadline - now <= self.deadline_guard_s):
                last_urgent = i
        if last_urgent >= take:
            for b in buckets:
                if b > last_urgent:
                    return min(depth, b)
        return take

    @staticmethod
    def _payload_signature(payload: Any):
        """(shape, dtype) per leaf: what has to match for two requests to
        stack into one device batch."""
        return tuple((tuple(getattr(leaf, "shape", ())),
                      str(getattr(leaf, "dtype", type(leaf).__name__)))
                     for leaf in _tree_leaves(payload))

    def top_off(self, k: int, like: Any = None) -> List[Request]:
        """Pop up to ``k`` late-arriving requests to top off a forming
        batch right before dispatch.  ``like`` (a payload of the forming
        batch) bounds the pull to stack-compatible requests, stopping at
        the first mismatch (FIFO preserved).  Expired deadlines among the
        pulled requests are shed as a flush sheds them.  Returns the LIVE
        pulled requests; safe from any dispatch worker thread."""
        if k <= 0:
            return []
        sig = (None if like is None
               else self._payload_signature(like))
        with self._cond:
            take = min(int(k), len(self._q))
            if take <= 0:
                return []
            batch: List[Request] = []
            for _ in range(take):
                if sig is not None and self._payload_signature(
                        self._q[0].payload) != sig:
                    break
                batch.append(self._q.popleft())
            if not batch:
                return []
            self.metrics.gauge("serving.queue_depth", float(len(self._q)))
            now = self._clock()
        return self._shed_expired(batch, now)

    def _shed_expired(self, batch: List[Request],
                      now: float) -> List[Request]:
        live: List[Request] = []
        for r in batch:
            if r.expired(now):
                self.metrics.incr("serving.shed_deadline")
                flight_emit("serving.shed", reason="deadline",
                            waited_s=round(now - r.enqueued_at, 4))
                try:
                    r.future.set_exception(DeadlineExceededError(
                        f"deadline expired after "
                        f"{now - r.enqueued_at:.3f}s in queue"))
                except InvalidStateError:
                    pass  # a client cancel() raced us
                r.finish_span("shed")
            else:
                live.append(r)
        if len(live) < len(batch):
            logger.info("shed %d expired request(s) before dispatch",
                        len(batch) - len(live))
        return live

    # -- shutdown ----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop admission.  ``drain=True`` lets the dispatcher flush the
        remaining queue; ``drain=False`` fails every queued future with
        ``ServerClosedError`` immediately."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._q:
                    r = self._q.popleft()
                    try:
                        r.future.set_exception(
                            ServerClosedError("server closed before "
                                              "dispatch"))
                    except InvalidStateError:
                        pass  # a client cancel() raced the close
                    r.finish_span("closed")
                self.metrics.gauge("serving.queue_depth", 0.0)
            self._cond.notify_all()


def ragged_arrival_benchmark(n_bursts: int = 10,
                             max_batch_size: int = 32,
                             bucket_sizes=(8, 16, 32),
                             dispatch_ms: float = 8.0,
                             max_wait_ms: float = 25.0,
                             gap_ms: float = 70.0,
                             seed: int = 0,
                             feature_dim: int = 8):
    """Chip-free proof of the ragged-batching lever: a sleep stands in for
    the device.

    A seeded mixed-size arrival process (``n_bursts`` bursts of
    1..``max_batch_size`` requests, each isolated by ``gap_ms`` >
    ``max_wait_ms``) is replayed through a sleep-wrapped
    :class:`~sparkdl_tpu_torch.serving.server.Server` twice: with
    ``ragged=False`` (each burst pads into the nearest covering bucket) and
    with ``ragged=True`` (bucket-boundary cuts + top-off).  The model is
    row-local elementwise math, so outputs are bit-identical whatever
    micro-batch or bucket a request lands in.  Pad accounting comes from
    the engine's ``engine.rows`` / ``engine.pad_rows`` ledger and the
    ``serving.batch_fill_ratio`` histogram.  The server runs on the
    entry points' default device (:func:`sparkdl_tpu_torch.resolve_device`).
    """
    import torch

    from sparkdl_tpu_torch.serving.server import Server

    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, max_batch_size + 1,
                                          size=n_bursts)]
    n_requests = sum(sizes)

    def fn(module, x):
        # row-local elementwise math: a request's output row depends only
        # on its own input row
        return torch.tanh(x * 2.0 + 0.5)

    payloads = [rng.normal(size=(feature_dim,)).astype(np.float32)
                for _ in range(n_requests)]

    def run(ragged: bool):
        metrics = Metrics()
        srv = Server(fn, torch.nn.Module(), max_batch_size=max_batch_size,
                     max_wait_ms=max_wait_ms,
                     max_queue=n_requests + 16,
                     bucket_sizes=list(bucket_sizes),
                     max_inflight_batches=4,
                     ragged=ragged, cache=False, metrics=metrics)
        try:
            srv.warmup(payloads[0])  # capture BEFORE the sleep wrap
            dispatches = [0]
            for b in srv.bucket_sizes:
                eng = srv._engine_for(b)
                real = eng.run_padded

                def slow(batch, _real=real):  # the synthetic device
                    dispatches[0] += 1
                    time.sleep(dispatch_ms / 1e3)
                    return _real(batch)

                eng.run_padded = slow
            # warmup dispatched one exact-fill batch per bucket: the
            # returned accounting covers the replay only
            warm = dict(metrics.snapshot_raw()["counters"])
            warm_fills = len(metrics.histograms.get(
                "serving.batch_fill_ratio", []))
            futs = []
            t0 = time.perf_counter()
            i = 0
            for s in sizes:
                for _ in range(s):
                    futs.append(srv.submit(payloads[i]))
                    i += 1
                time.sleep(gap_ms / 1e3)
            outs = [np.asarray(f.result(timeout=60)) for f in futs]
            wall_s = time.perf_counter() - t0
        finally:
            srv.close()
        snap = metrics.snapshot_raw()
        counters = {k: v - warm.get(k, 0.0)
                    for k, v in snap["counters"].items()}
        fills = list(metrics.histograms.get(
            "serving.batch_fill_ratio", []))[warm_fills:]
        return {
            "wall_s": round(wall_s, 4),
            "dispatches": dispatches[0],
            "rows": int(counters.get("engine.rows", 0)),
            "pad_rows": int(counters.get("engine.pad_rows", 0)),
            "topoff_rows": int(counters.get("serving.topoff_rows", 0)),
            "batches": int(counters.get("serving.batches", 0)),
            "fill_mean": (round(float(np.mean(fills)), 4)
                          if len(fills) else None),
        }, outs

    flush, flush_out = run(ragged=False)
    ragged, ragged_out = run(ragged=True)
    bit_identical = all(np.array_equal(a, b)
                        for a, b in zip(flush_out, ragged_out))
    total = max(1, flush["rows"] + flush["pad_rows"])
    rtotal = max(1, ragged["rows"] + ragged["pad_rows"])
    return {
        "n_requests": n_requests,
        "n_bursts": n_bursts,
        "burst_sizes": sizes,
        "bucket_sizes": list(bucket_sizes),
        "dispatch_ms": dispatch_ms,
        "flush": flush,
        "ragged": ragged,
        "flush_pad_frac": round(flush["pad_rows"] / total, 4),
        "ragged_pad_frac": round(ragged["pad_rows"] / rtotal, 4),
        "pad_rows_saved": flush["pad_rows"] - ragged["pad_rows"],
        "bit_identical": bit_identical,
    }
