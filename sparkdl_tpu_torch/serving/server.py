"""In-process async inference server over the engine (port of
``sparkdl_tpu/serving/server.py``'s ``Server``).

Single-example requests are admitted into a bounded queue, assembled into
dynamic micro-batches (:mod:`sparkdl_tpu_torch.serving.batcher`), padded
to a small set of BUCKET sizes (one captured CUDA graph per bucket, never
one per request count), dispatched through
:class:`~sparkdl_tpu_torch.parallel.engine.InferenceEngine` and
demultiplexed back to per-request futures.

Production envelope:
  * per-request deadlines: expired requests are shed BEFORE dispatch;
  * bounded admission queue: reject with ``retry_after_s`` when full;
  * per-batch fault isolation: a model fn that raises (after the
    configured ``utils.retry`` budget) or stalls past
    ``dispatch_timeout_ms`` fails only its OWN batch's futures;
  * graceful drain on ``close()`` / context-manager exit, which then gives
    the buckets' graph pool back to the card;
  * ``utils.metrics`` counters, gauges and latency histograms (queue
    depth, batch fill ratio, time in queue, p50/p99 latency).

The buckets' engines are siblings (:meth:`InferenceEngine.sibling`): one
device copy of the weights, one set of fold caches and one graph pool for
every bucket, as the JAX server shares one device copy of the weights and
one jit program.  A micro-batch is one device batch, so it runs through
the engine's single-batch path (no pipelined-runner threads on the latency
path); up to ``max_inflight_batches`` worker threads overlap one batch's
host work and output copy with the next one's replay.

The server resolves its device at construction
(:func:`sparkdl_tpu_torch.resolve_device`): the card unless the CPU was
asked for, and ``RuntimeError`` without a card; it never serves from the
CPU quietly.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
queue A item): ``slos`` and ``cost`` (observability), a ``mesh``,
``partition_rules``, ``param_shardings`` and ``donate_batch=True`` (the
mesh, with the rest of training).  ``varz()`` keeps the JAX package's
keys; its ``cost``, ``sharding`` and ``exemplars`` sections read None.
The head fan-out server (``HeadFanoutServer``) comes with the next
serving slice.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch.nn as nn

from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.parallel.engine import (CircuitOpenError,
                                               InferenceEngine, _tree_map,
                                               effective_device_batch)
from sparkdl_tpu_torch.serving.batcher import (DynamicBatcher, Request,
                                               ragged_enabled_from_env)
from sparkdl_tpu_torch.serving.cache import resolve_cache
from sparkdl_tpu_torch.serving.errors import (DeadlineExceededError,
                                              DispatchTimeoutError,
                                              ServerClosedError,
                                              ServiceUnavailableError)
from sparkdl_tpu_torch.utils.digest import content_digest
from sparkdl_tpu_torch.utils.health import HealthTracker
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics
from sparkdl_tpu_torch.utils.retry import NON_RETRYABLE, with_retries

logger = get_logger(__name__)


def _resolve_model(model, module, featurize: bool):
    """(fn, module, engine_overrides) from the three accepted model forms,
    the port's forms of the JAX package's:

    * a zoo model NAME (str): weights from the shared process cache, the
      model's ImageNet preprocess in front (``featurize`` picks the feature
      cut vs. probabilities), uint8 RGB ``[B, H, W, 3]`` input, and
      ``SPARKDL_ZOO_COMPUTE_DTYPE`` honored as the zoo transformers honor
      it (:func:`~sparkdl_tpu_torch.transformers.named_image.
      zoo_serving_bundle`), so served rows are transformed rows;
    * a :class:`~sparkdl_tpu_torch.graph.function.ModelFunction`;
    * a plain ``fn(module, batch)`` plus its ``nn.Module`` (the JAX
      package's ``fn(variables, batch)`` plus variables).
    """
    from sparkdl_tpu_torch.graph.function import ModelFunction

    if isinstance(model, str):
        if module is not None:
            raise ValueError("module must be None when serving a named "
                             "zoo model")
        from sparkdl_tpu_torch.transformers.named_image import \
            zoo_serving_bundle

        return zoo_serving_bundle(model, featurize)
    if isinstance(model, ModelFunction):
        if module is not None:
            raise ValueError("module must be None when serving a "
                             "ModelFunction (it carries its own)")
        return model.fn, model.module, {}
    if callable(model):
        return model, (nn.Module() if module is None else module), {}
    raise TypeError(f"Cannot serve a {type(model).__name__}; expected a "
                    f"zoo model name, ModelFunction, or callable "
                    f"fn(module, batch)")


def _default_buckets(max_batch_size: int) -> List[int]:
    """Quarter / half / full batch: three captured shapes cover light,
    medium and saturated traffic."""
    b = max(1, int(max_batch_size))
    return sorted({max(1, b // 4), max(1, b // 2), b})


def bucket_plan(max_batch_size: int,
                bucket_sizes: Optional[Sequence[int]] = None) -> List[int]:
    """The bucket set a :class:`Server` builds: requested buckets (default
    quarter/half/full), validated, each the engine's device batch, and
    de-duplicated."""
    max_batch_size = max(1, int(max_batch_size))
    buckets = (list(bucket_sizes) if bucket_sizes is not None
               else _default_buckets(max_batch_size))
    if not buckets or any(int(b) < 1 for b in buckets):
        raise ValueError(f"bucket_sizes must be positive, got {buckets}")
    buckets = sorted(int(b) for b in buckets)
    if buckets[-1] < max_batch_size:
        raise ValueError(
            f"largest bucket ({buckets[-1]}) must cover "
            f"max_batch_size ({max_batch_size})")
    return sorted({effective_device_batch(b) for b in buckets})


class _Once:
    """Run a callback exactly once across racing threads (worker finish
    vs. stall watchdog)."""

    def __init__(self, fn: Callable[[], None]):
        self._fn = fn
        self._lock = threading.Lock()
        self._done = False

    def __call__(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        self._fn()


def _deadline_guard(inner: Future, timeout_s: float) -> Future:
    """Caller-facing view of ``inner`` that fails with
    ``DeadlineExceededError`` after ``timeout_s``: how a coalesced follower
    keeps its own deadline while parked on a leader whose request may have
    none.  One ``threading.Timer`` per deadline-carrying follower,
    cancelled the moment the leader settles."""
    out: Future = Future()

    def _relay(f: Future) -> None:
        timer.cancel()
        try:
            if f.cancelled():
                out.cancel()
                return
            exc = f.exception()
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(f.result())
        except InvalidStateError:  # the deadline timer fired first
            pass

    def _expire() -> None:
        try:
            out.set_exception(DeadlineExceededError(
                f"coalesced request exceeded its "
                f"{timeout_s * 1e3:.0f}ms deadline while waiting on the "
                f"single-flight leader"))
        except InvalidStateError:  # the leader settled first
            pass

    timer = threading.Timer(timeout_s, _expire)
    timer.daemon = True
    timer.start()
    inner.add_done_callback(_relay)
    return out


def _settle_error(requests: Sequence[Request], exc: BaseException) -> None:
    for r in requests:
        if not r.future.done():
            try:
                r.future.set_exception(exc)
            except InvalidStateError:  # lost a race with the watchdog
                pass


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"Server({what}) needs a module the port does not have yet "
        f"(ROADMAP.md queue A, {item})")


class Server:
    """Async dynamic-batching inference service over one model.

    ::

        with serving.Server(fn, module, max_batch_size=64,
                            max_wait_ms=5) as srv:
            fut = srv.submit(example)           # concurrent.futures.Future
            y = fut.result()
            y = srv.predict(example)            # blocking sugar
            y = await srv.predict_async(example)  # asyncio integration

    Requests are single examples WITHOUT the batch axis (arrays or
    pytrees); results are the matching single-example output rows as
    numpy arrays that own their memory, bit-identical to running the same
    inputs through the engine at the same padded shape, whatever the
    arrival order or the micro-batch a request lands in.  Across DIFFERENT
    bucket shapes results agree to a tolerance (another shape may pick
    other convolution algorithms).

    ``model`` is a zoo model name, a ``ModelFunction``, or a plain
    ``fn(module, batch)`` with its ``module`` (see :func:`_resolve_model`).
    ``device`` is resolved once, here.

    Parameters beyond the batcher knobs, as in the JAX package:
      * ``bucket_sizes``: padded dispatch sizes (default quarter/half/full
        ``max_batch_size``); each bucket is one captured graph.
      * ``default_timeout_ms``: deadline of requests that pass no
        ``timeout_ms`` of their own (None = no deadline).
      * ``dispatch_timeout_ms``: stall watchdog; a model-call ATTEMPT past
        it fails its batch with ``DispatchTimeoutError`` and later batches
        proceed.  Re-armed per retry attempt; it excludes a bucket's first
        call (the eager warm-up forward and the graph capture, run untimed
        first) and the host-side demux.
      * ``max_retries`` / ``retry_backoff_s``: the per-batch
        ``utils.retry.with_retries`` budget for transient model failures.
      * ``max_inflight_batches``: dispatch concurrency bound.
      * ``host_preprocess``: per-request host fn run in ``submit`` on the
        CALLER's thread (e.g. image resize).
      * ``dispatch_retries`` / ``breaker_threshold`` /
        ``breaker_cooldown_s``: the engines' failure-domain knobs; while a
        bucket's breaker is OPEN, :meth:`submit` sheds with
        ``ServiceUnavailableError`` + ``retry_after_s``.
      * ``cache`` / ``cache_namespace``: the result cache
        (:mod:`~sparkdl_tpu_torch.serving.cache`; None = the
        ``SPARKDL_CACHE`` default, False = uncached).
      * ``ragged``: continuous ragged batching (default the
        ``SPARKDL_RAGGED`` knob, ON).
      * ``clock``: the monotonic clock deadlines, queue ages and latency
        read (the real clock by default); the drain wait, the watchdog and
        the follower deadline guard stay on the real clock.
    """

    def __init__(self, model, module: Optional[nn.Module] = None, *,
                 featurize: bool = False,
                 max_batch_size: int = 64,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 dispatch_timeout_ms: Optional[float] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 max_inflight_batches: int = 2,
                 max_retries: int = 0,
                 retry_backoff_s: float = 0.0,
                 device: DeviceLike = None,
                 mesh=None,
                 compute_dtype: Optional[Any] = None,
                 output_host_dtype: Optional[Any] = None,
                 host_preprocess: Optional[Callable[[Any], Any]] = None,
                 dispatch_retries: int = 0,
                 breaker_threshold: int = 8,
                 breaker_cooldown_s: float = 30.0,
                 slos: Optional[Sequence[Any]] = None,
                 cache: Any = None,
                 cache_namespace: Optional[Sequence[Any]] = None,
                 ragged: Optional[bool] = None,
                 donate_batch: Optional[bool] = None,
                 partition_rules: Any = None,
                 param_shardings: Any = None,
                 metrics: Optional[Metrics] = None,
                 clock: Optional[Callable[[], float]] = None,
                 cost: Any = None):
        if slos:
            raise _not_ported("slos=", "item 6, observability")
        if cost not in (None, False):
            raise _not_ported("cost=", "item 6, observability")
        if mesh is not None:
            raise _not_ported("mesh=", "item 4, parallel/mesh.py")
        if partition_rules is not None or param_shardings is not None:
            raise _not_ported("partition_rules= / param_shardings=",
                              "item 4, parallel/mesh.py")
        if donate_batch:
            raise _not_ported("donate_batch=True",
                              "item 4, parallel/mesh.py")
        self._device = resolve_device(device)
        self._fn, self._module, overrides = _resolve_model(
            model, module, featurize)
        if compute_dtype is None and output_host_dtype is None:
            compute_dtype = overrides.get("compute_dtype")
            output_host_dtype = overrides.get("output_host_dtype")
        self.metrics = metrics if metrics is not None else Metrics()
        self._clock = clock if clock is not None else time.monotonic
        self.max_batch_size = max(1, int(max_batch_size))
        self._buckets = bucket_plan(self.max_batch_size,
                                    bucket_sizes=bucket_sizes)
        self._default_timeout_s = (None if default_timeout_ms is None
                                   else max(0.0, default_timeout_ms) / 1e3)
        self._dispatch_timeout_s = (None if dispatch_timeout_ms is None
                                    else max(1e-3, dispatch_timeout_ms) / 1e3)
        self._max_retries = max(0, int(max_retries))
        self._retry_backoff_s = max(0.0, float(retry_backoff_s))
        self._compute_dtype = compute_dtype
        self._output_host_dtype = output_host_dtype
        self._host_preprocess = host_preprocess
        self._dispatch_retries = max(0, int(dispatch_retries))
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        # ready <-> degraded: an engine's failed dispatch attempt (even one
        # a retry later absorbs) and a failed batch note degraded, the next
        # served batch notes ready
        self._health = HealthTracker()
        # owned (auto-generated anon) namespaces are reclaimed from the
        # possibly shared store by close()
        self._cache, self._cache_ns, self._cache_ns_owned = resolve_cache(
            cache, cache_namespace, "server")
        self._engines: Dict[int, InferenceEngine] = {}
        self._warm: set = set()  # buckets whose graph is captured
        self._engine_lock = threading.Lock()
        self._ragged = (ragged_enabled_from_env() if ragged is None
                        else bool(ragged))
        self._batcher = DynamicBatcher(
            max_batch_size=self.max_batch_size, max_wait_ms=max_wait_ms,
            max_queue=max_queue,
            bucket_plan=self._buckets if self._ragged else None,
            metrics=self.metrics, clock=self._clock)
        self._closed = False
        self._abandon = threading.Event()
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._inflight_sem = threading.Semaphore(
            max(1, int(max_inflight_batches)))
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="sparkdl-serving-dispatch")
        self._dispatcher.start()

    # -- engines (one per bucket, siblings of the first) -------------------
    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _engine_for(self, bucket: int) -> InferenceEngine:
        with self._engine_lock:
            eng = self._engines.get(bucket)
            if eng is None:
                first = next(iter(self._engines.values()), None)
                if first is not None:
                    # one device copy of the weights, fold caches and
                    # graph pool for every bucket
                    eng = first.sibling(bucket)
                else:
                    eng = InferenceEngine(
                        self._fn, self._module, device=self._device,
                        device_batch_size=bucket,
                        compute_dtype=self._compute_dtype,
                        output_host_dtype=self._output_host_dtype,
                        dispatch_retries=self._dispatch_retries,
                        breaker_threshold=self._breaker_threshold,
                        breaker_cooldown_s=self._breaker_cooldown_s,
                        on_dispatch_error=self._note_failure,
                        metrics=self.metrics)
                self._engines[bucket] = eng
            return eng

    def warmup(self, example: Any) -> None:
        """Capture every bucket's graph ahead of traffic (one dispatch per
        bucket of ``example``, a single request payload, stacked), so first
        requests never pay the warm-up forward and the capture.  The
        largest bucket is captured first: the smaller ones then find its
        freed blocks in the shared pool instead of growing it."""
        if self._host_preprocess is not None:
            example = self._host_preprocess(example)
        example = _tree_map(np.asarray, example)
        for b in sorted(self._buckets, reverse=True):
            eng = self._engine_for(b)
            eng(_tree_map(lambda a: np.stack([a] * b), example))
            self._warm.add(b)

    @property
    def device(self):
        """The device the server's engines run on."""
        return self._device

    @property
    def graph_pool_bytes(self) -> int:
        """The bytes the buckets' one graph pool holds on the card (0
        before the first capture and after :meth:`close`)."""
        with self._engine_lock:
            first = next(iter(self._engines.values()), None)
        return 0 if first is None else first.graph_pool_bytes

    # -- health / failure domain -------------------------------------------
    def _note_failure(self, exc: BaseException) -> None:
        """Record a failed dispatch attempt / batch: state -> degraded.
        Wired as every engine's ``on_dispatch_error`` hook."""
        self._health.note_failure(exc)

    def _note_success(self) -> None:
        self._health.note_success()

    def _breaker_states(self) -> Dict[int, Dict[str, Any]]:
        with self._engine_lock:
            engines = dict(self._engines)
        return {b: eng.breaker_state() for b, eng in sorted(engines.items())}

    def _breaker_retry_after(self) -> Optional[float]:
        """Max remaining cool-down over OPEN bucket breakers, or None when
        none is open (half-open breakers admit the trial traffic)."""
        with self._engine_lock:
            engines = list(self._engines.values())
        worst = None
        for eng in engines:
            remaining = eng.breaker.open_remaining_s()
            if remaining is not None:
                worst = max(worst or 0.0, remaining)
        return worst

    def health(self) -> Dict[str, Any]:
        """Liveness/readiness snapshot (JSON-serializable; also in
        :meth:`varz`), through :meth:`HealthTracker.payload`: ``live``
        (False once closed), ``state`` (``ready``, ``degraded`` while a
        breaker is open or half-open or after a failure with no success
        since, or ``closed``), ``last_error``, the bounded ``transitions``
        history, and ``breaker`` (per-bucket circuit-breaker state)."""
        breakers = self._breaker_states()
        state_override = None
        if any(st["state"] in ("open", "half_open")
               for st in breakers.values()):
            state_override = "degraded"
        if self._closed:
            state_override = "closed"
        return self._health.payload(live=not self._closed,
                                    state_override=state_override,
                                    breaker=breakers)

    # -- request path ------------------------------------------------------
    def submit(self, example: Any,
               timeout_ms: Optional[float] = None) -> Future:
        """Admit one example; returns its ``concurrent.futures.Future``.

        Raises ``ServerClosedError`` after close, ``QueueFullError`` (with
        ``retry_after_s``) under backpressure, and
        ``ServiceUnavailableError`` (with ``retry_after_s``) while a
        dispatch circuit breaker is open.  ``timeout_ms`` overrides the
        server's ``default_timeout_ms``.

        With a result cache the probe runs FIRST (before the breaker shed
        and the queue charge): a hit serves even while the device is
        failing, and N concurrent identical requests cost one dispatch (the
        first becomes the single-flight leader, the rest park on it).  A
        leader failure settles its followers with the same error and
        caches nothing."""
        if self._closed:
            raise ServerClosedError("server is closed")
        if self._cache is not None:
            return self._submit_cached(example, timeout_ms)
        return self._submit_dispatch(example, timeout_ms)

    def _submit_cached(self, example: Any,
                       timeout_ms: Optional[float]) -> Future:
        """The cache-fronted request path; see :meth:`submit`."""
        t0 = self._clock()
        if self._host_preprocess is not None:
            example = self._host_preprocess(example)
        example = _tree_map(np.asarray, example)
        key = self._cache_ns + (content_digest(example),)
        kind, res = self._cache.lookup(key)
        if kind == "hit":
            self.metrics.incr("serving.requests")
            self.metrics.incr("serving.completed")
            self.metrics.incr("serving.cache_hits")
            self.metrics.record_time("serving.request_latency",
                                     self._clock() - t0)
            fut: Future = Future()
            fut.set_result(res)
            return fut
        if kind == "follower":
            self.metrics.incr("serving.requests")
            self.metrics.incr("serving.cache_coalesced")

            def _follower_done(f: Future) -> None:
                if not f.cancelled() and f.exception() is None:
                    self.metrics.incr("serving.completed")
                    self.metrics.record_time("serving.request_latency",
                                             self._clock() - t0)

            # a coalesced follower keeps its OWN deadline: the leader may
            # have none
            timeout_s = (self._default_timeout_s if timeout_ms is None
                         else max(0.0, timeout_ms) / 1e3)
            caller_fut = (res if timeout_s is None
                          else _deadline_guard(res, timeout_s))
            # metrics ride the future the CALLER holds: a follower whose
            # deadline guard failed it does not count as completed
            caller_fut.add_done_callback(_follower_done)
            return caller_fut
        flight = res
        try:
            # the leader's payload must be OURS: the digest describes the
            # original bytes, and a caller refilling its buffer after
            # submit() would otherwise settle the new bytes' output under
            # the old digest.  Inside the try, so a failed copy fails the
            # flight instead of leaking it.
            example = _tree_map(lambda a: np.array(a, copy=True), example)
            # chaos hook: a sleep holds the leader open so follower pile-up
            # is observable; an error is a leader failure every follower
            # must see (and caches nothing)
            inject("cache.stampede")
            fut = self._submit_dispatch(example, timeout_ms,
                                        preprocessed=True)
        except BaseException as e:  # noqa: BLE001 — settled to followers, re-raised
            self._cache.fail(flight, e)
            raise
        # the caller gets a SEPARATE future, resolved only AFTER settle has
        # copied the row: the caller cannot mutate its row while settle
        # copies it
        out: Future = Future()

        def _leader_done(f: Future) -> None:
            try:
                value = f.result()
            except BaseException as e:  # noqa: BLE001 — relayed to followers and caller
                self._cache.fail(flight, e)
                if not out.done():
                    out.set_exception(e)
            else:
                # store=False once closed: close() already reclaimed an
                # owned namespace
                self._cache.settle(
                    flight, value,
                    store=not (self._closed and self._cache_ns_owned))
                if not out.done():
                    out.set_result(value)

        fut.add_done_callback(_leader_done)
        return out

    def _submit_dispatch(self, example: Any,
                         timeout_ms: Optional[float],
                         preprocessed: bool = False) -> Future:
        """The direct dispatch path (the whole request path without a
        cache; the single-flight leader's path with one)."""
        retry_after = self._breaker_retry_after()
        if retry_after is not None:
            # counted in serving.requests too: shed-rate consumers divide
            # rejected_* by requests
            self.metrics.incr("serving.requests")
            self.metrics.incr("serving.rejected_breaker_open")
            raise ServiceUnavailableError(
                f"dispatch circuit breaker open (device failing); "
                f"retry in {retry_after:.2f}s", retry_after_s=retry_after)
        if not preprocessed:
            if self._host_preprocess is not None:
                example = self._host_preprocess(example)
            example = _tree_map(np.asarray, example)
        timeout_s = (self._default_timeout_s if timeout_ms is None
                     else max(0.0, timeout_ms) / 1e3)
        now_m = self._clock()
        deadline = None if timeout_s is None else now_m + timeout_s
        req = Request(example, deadline, now=now_m)
        self.metrics.incr("serving.requests")
        self._batcher.submit(req)
        return req.future

    def predict(self, example: Any,
                timeout_ms: Optional[float] = None) -> Any:
        """Blocking single-request convenience: submit + wait."""
        return self.submit(example, timeout_ms=timeout_ms).result()

    async def predict_async(self, example: Any,
                            timeout_ms: Optional[float] = None) -> Any:
        """Awaitable form for asyncio handlers (wraps the submit future)."""
        import asyncio

        return await asyncio.wrap_future(
            self.submit(example, timeout_ms=timeout_ms))

    # -- dispatch ----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            batch = self._batcher.next_batch()
            if batch is None:
                return  # closed and drained
            if not batch:
                continue  # every request shed at flush
            # interruptible slot wait: if close() abandons a wedged server
            # (no watchdog configured), the batches the dispatcher holds
            # must still settle
            acquired = False
            while not acquired and not self._abandon.is_set():
                acquired = self._inflight_sem.acquire(timeout=0.1)
            if not acquired:
                _settle_error(batch, ServerClosedError(
                    "server close abandoned a wedged dispatch; request "
                    "was never dispatched"))
                continue
            with self._inflight_cond:
                self._inflight += 1
            worker = threading.Thread(
                target=self._run_batch, args=(batch,), daemon=True,
                name="sparkdl-serving-batch")
            worker.start()

    def _finish_batch(self) -> None:
        self._inflight_sem.release()
        with self._inflight_cond:
            self._inflight -= 1
            self._inflight_cond.notify_all()

    def _run_batch(self, requests: List[Request]) -> None:
        finish = _Once(self._finish_batch)
        try:
            self._execute(requests, finish)
        except Exception as e:  # noqa: BLE001 — isolate to this batch
            self.metrics.incr("serving.batch_failures")
            self._note_failure(e)
            _settle_error(requests, e)
            logger.warning("serving batch of %d failed: %s: %s",
                           len(requests), type(e).__name__, e)
        finally:
            finish()

    def _guarded_call(self, eng, stacked, requests: List[Request],
                      finish: _Once):
        """One model-call ATTEMPT under the stall watchdog.  The timer is
        armed per attempt and covers ONLY the engine call (a bucket's first
        call, warm-up forward and capture, ran untimed in ``_execute``; the
        demux runs after the timer is disarmed).  The ``serving.model``
        fault site sits INSIDE the window (a ``sleep`` rule is a wedged
        model the watchdog must catch; an ``error`` rule a per-batch model
        failure)."""
        if self._dispatch_timeout_s is None:
            inject("serving.model")
            return eng(stacked)
        attempt_done = threading.Event()

        def on_stall():
            if attempt_done.is_set():
                return
            self.metrics.incr("serving.dispatch_timeouts")
            self.metrics.incr("serving.batch_failures")
            _settle_error(requests, DispatchTimeoutError(
                f"model call exceeded "
                f"{self._dispatch_timeout_s * 1e3:.0f}ms; batch of "
                f"{len(requests)} abandoned"))
            # free the concurrency slot the wedged worker holds so later
            # batches keep flowing
            finish()

        timer = threading.Timer(self._dispatch_timeout_s, on_stall)
        timer.daemon = True
        timer.start()
        try:
            inject("serving.model")
            return eng(stacked)
        finally:
            attempt_done.set()
            timer.cancel()

    def _top_off(self, gap: int, bucket: int, base: int,
                 like: Any) -> List[Request]:
        """The continuous half of ragged batching: right before a
        sub-bucket batch stacks, pull up to ``gap`` requests that arrived
        since the flush decision.  The ``batch.topoff`` fault site covers
        the pull; an injected failure degrades to the baseline padding
        (the base batch still dispatches)."""
        try:
            inject("batch.topoff")
        except Exception as e:  # noqa: BLE001 — a failed pull degrades to padding
            logger.warning("batch.topoff aborted: %s: %s; dispatching at "
                           "base fill %d/%d", type(e).__name__, e, base,
                           bucket)
            self.metrics.incr("serving.topoff_aborted")
            return []
        extras = self._batcher.top_off(gap, like=like)
        if extras:
            self.metrics.incr("serving.topoffs")
            self.metrics.incr("serving.topoff_rows", len(extras))
        return extras

    def _execute(self, requests: List[Request], finish: _Once) -> None:
        n = len(requests)
        bucket = self._bucket_for(n)
        if self._ragged and n < bucket and len(
                {DynamicBatcher._payload_signature(r.payload)
                 for r in requests}) == 1:
            # top off only when the WHOLE base batch stacks: pulling a
            # healthy late arrival into a batch doomed to fail its own
            # stack would widen the failure
            extras = self._top_off(bucket - n, bucket, n,
                                   requests[0].payload)
            if extras:
                # extend IN PLACE: the error handler and the watchdog hold
                # this same list
                requests.extend(extras)
                n = len(requests)
        now = self._clock()
        for r in requests:
            self.metrics.record_time("serving.time_in_queue",
                                     now - r.enqueued_at)
        stacked = _tree_map(lambda *rows: np.stack(rows, axis=0),
                            *[r.payload for r in requests])
        eng = self._engine_for(bucket)
        if self._dispatch_timeout_s is not None and bucket not in self._warm:
            # capture OUTSIDE the watchdog window: a bucket's first call
            # runs an eager warm-up forward and the capture (seconds for a
            # real model)
            eng(_tree_map(np.zeros_like, stacked))
            self._warm.add(bucket)
        t0 = time.monotonic()  # real: batch_seconds_hint sizes real waits
        # CircuitOpenError is exempt from the batch retry budget: an open
        # breaker fails fast by design
        out = with_retries(
            lambda: self._guarded_call(eng, stacked, requests, finish),
            max_retries=self._max_retries,
            non_retryable=NON_RETRYABLE + (CircuitOpenError,),
            backoff_seconds=self._retry_backoff_s)
        batch_s = time.monotonic() - t0
        self._note_success()  # a served batch flips health back to ready
        self._batcher.batch_seconds_hint = batch_s
        self.metrics.incr("serving.batches")
        self.metrics.record_time("serving.batch_latency", batch_s)
        self.metrics.observe("serving.batch_fill_ratio",
                             n / eng.device_batch_size)
        done = self._clock()
        for i, r in enumerate(requests):
            if r.future.done():
                continue  # the watchdog raced us; result discarded
            # copy, don't view: a retained row pins O(row), not the whole
            # [bucket, ...] batch output
            row = _tree_map(lambda a: np.array(a[i], copy=True), out)
            try:
                r.future.set_result(row)
                self.metrics.incr("serving.completed")
                self.metrics.record_time("serving.request_latency",
                                         done - r.enqueued_at)
            except InvalidStateError:
                pass

    # -- lifecycle ---------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def queue_depth(self) -> int:
        return self._batcher.depth()

    @property
    def bucket_sizes(self) -> List[int]:
        """The bucket plan (de-duplicated device batches)."""
        return list(self._buckets)

    @property
    def cache(self):
        """The result cache this server probes (None when uncached)."""
        return self._cache

    @property
    def cache_namespace(self) -> tuple:
        """The key prefix this server's entries live under."""
        return self._cache_ns

    def stats(self) -> Dict[str, float]:
        """Snapshot of the serving metrics (counters, gauges, latency
        p50/p99; see ``utils.metrics.Metrics.summary``), plus any
        ``engine_*`` / ``pipeline.*`` metrics the engines recorded."""
        summary = self.metrics.summary()
        return {k: v for k, v in summary.items()
                if k.startswith(("serving.", "engine_", "pipeline."))}

    def varz(self) -> Dict[str, Any]:
        """The ``/varz``-shaped structured form of :meth:`stats`, with the
        JAX package's keys: server config/state, health, ``serving.*``
        counters, latency p50/p99 in ms, the full metrics snapshot
        (``obs.export.metrics_snapshot``) and the cache section.  ``cost``,
        ``sharding`` and ``exemplars`` read None until their modules are
        ported.  JSON-serializable throughout."""
        from sparkdl_tpu_torch.obs.export import metrics_snapshot

        m = self.metrics

        def dist_ms(name: str) -> Dict[str, float]:
            out: Dict[str, float] = {}
            for q, key in ((50, "p50_ms"), (99, "p99_ms")):
                v = m.percentile(name, q, kind="timing")
                if v is not None:
                    out[key] = round(v * 1e3, 3)
            return out

        snap = metrics_snapshot(m)
        return {
            "server": {
                "closed": self._closed,
                "max_batch_size": self.max_batch_size,
                "bucket_sizes": list(self._buckets),
                "ragged": self._ragged,
                "queue_depth": self.queue_depth(),
                "inflight_batches": self._inflight,
            },
            "health": self.health(),
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith("serving.")},
            "latency_ms": {
                "request": dist_ms("serving.request_latency"),
                "batch": dist_ms("serving.batch_latency"),
                "queue": dist_ms("serving.time_in_queue"),
            },
            "metrics": snap,
            "cache": (self._cache.info() if self._cache is not None
                      else None),
            "cost": None,
            "sharding": None,
            "exemplars": None,
        }

    def close(self, drain: bool = True,
              timeout_s: Optional[float] = 30.0) -> None:
        """Stop the server.  ``drain=True`` (graceful): stop admission,
        serve everything already queued, wait for in-flight batches.
        ``drain=False``: queued requests fail with ``ServerClosedError``;
        in-flight batches are still awaited.  Idempotent.  Once nothing is
        in flight, the buckets' graphs are released and their pool goes
        back to the card (after the card has finished with it).

        If the drain cannot complete within ``timeout_s`` (a wedged model
        call with no ``dispatch_timeout_ms``), the wait is abandoned, every
        request NOT in the wedged batch settles with ``ServerClosedError``,
        and the graphs are left to the wedged call."""
        if self._closed:
            self._batcher.close(drain=drain)
            return
        self._closed = True
        try:
            self._batcher.close(drain=drain)
            self._dispatcher.join(timeout=timeout_s)
            if self._dispatcher.is_alive():
                logger.warning(
                    "close(): dispatcher still busy after %ss; abandoning "
                    "— undispatched requests fail with ServerClosedError",
                    timeout_s)
                self._abandon.set()
                self._dispatcher.join(timeout=5.0)
                self._batcher.close(drain=False)  # settle anything queued
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            with self._inflight_cond:
                while self._inflight > 0:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        logger.warning(
                            "close(): %d batch(es) still in flight "
                            "after %.1fs; abandoning wait",
                            self._inflight, timeout_s)
                        return
                    self._inflight_cond.wait(remaining)
            with self._engine_lock:
                engines = list(self._engines.values())
            for eng in engines:
                eng.release_graphs()
        finally:
            if self._cache is not None and self._cache_ns_owned:
                # this server's anon namespace is unreachable once closed:
                # reclaim the bytes from the shared store
                self._cache.invalidate(self._cache_ns)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)
