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
    depth, batch fill ratio, time in queue, p50/p99 latency);
  * observability (:mod:`sparkdl_tpu_torch.obs`), as in the JAX package:
    a ``serving.request`` root span per request, the micro-batch span and
    the engine's spans under it, the slowest requests' span trees as
    exemplars, ``serving.shed`` / ``serving.drain`` / ``batch.topoff``
    flight events, declarative ``slos=`` evaluated in
    ``health()["slo"]``, and ``cost=`` attribution of every settled batch
    and cache hit to its tenants.

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

The mesh, as JAX's: ``mesh=`` (this process's one device,
:func:`~sparkdl_tpu_torch.parallel.engine.resolve_engine_mesh`; buckets
rounded to its data axis by :func:`bucket_plan`), ``partition_rules`` /
``param_shardings`` (zoo models default to
``mesh.default_partition_rules``, which resolve all-replicated on one
card) and ``donate_batch`` reach every bucket engine; ``varz()
["sharding"]`` is :meth:`Server.sharding_info`.  A policy that really
splits a weight, and a mesh of more than one device, raise
``NotImplementedError`` (one card per process, ROADMAP.md §C).

:class:`HeadFanoutServer` serves many tenants' heads over one backbone
``Server`` at the feature cut: a warm content digest costs a head pass
only.
"""

from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch.nn as nn

from sparkdl_tpu_torch.analysis.lockcheck import named_condition, named_lock
from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.obs.exemplar import ExemplarReservoir
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.obs.trace import get_tracer
from sparkdl_tpu_torch.parallel.engine import (CircuitOpenError,
                                               InferenceEngine, _tree_leaves,
                                               _tree_map,
                                               effective_device_batch,
                                               resolve_engine_mesh,
                                               precision_flags)
from sparkdl_tpu_torch.parallel.mesh import DATA_AXIS
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
                bucket_sizes: Optional[Sequence[int]] = None,
                mesh=None) -> List[int]:
    """The bucket set a :class:`Server` builds: requested buckets (default
    quarter/half/full), validated, rounded up to the mesh's data-axis
    multiple (the engine's device batch) and de-duplicated."""
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
    mesh = resolve_engine_mesh(mesh)
    return sorted({effective_device_batch(b, mesh) for b in buckets})


class _Once:
    """Run a callback exactly once across racing threads (worker finish
    vs. stall watchdog)."""

    def __init__(self, fn: Callable[[], None]):
        self._fn = fn
        self._lock = named_lock("serving.once")
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
        r.finish_span("error")
    if requests:
        bs = requests[0].batch_span
        if bs is not None:
            requests[0].batch_span = None
            bs.finish("error")


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
      * ``slos``: declarative :class:`~sparkdl_tpu_torch.obs.slo.SLO`
        objectives over this server's metrics, evaluated on every
        :meth:`health` poll; a breach degrades health and names the
        objective, and the evaluation rides ``health()["slo"]``.
      * ``mesh``: this process's one-device mesh (default
        :func:`~sparkdl_tpu_torch.parallel.mesh.get_mesh` over ``device``);
        ``partition_rules`` / ``param_shardings``: the weight policy every
        bucket engine resolves (zoo models default to
        ``mesh.default_partition_rules``; explicit ones win); a real
        split raises.  ``donate_batch``: recorded in
        :meth:`sharding_info`; on the card it changes nothing, the
        captured graph already owning its input slot (zoo models
        override it to False, as JAX's do).
      * ``cost``: the :class:`~sparkdl_tpu_torch.obs.cost.CostLedger`
        every settled batch and cache hit is charged to (None = the
        ``SPARKDL_COST`` default, False = unmetered); ``model_desc`` is
        the model name its lines carry (default the zoo name or the fn's
        name).
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
                 cost: Any = None,
                 model_desc: Optional[str] = None):
        self._mesh = resolve_engine_mesh(mesh, device)
        self._device = resolve_device(self._mesh.devices.flat[0])
        self._fn, self._module, overrides = _resolve_model(
            model, module, featurize)
        if donate_batch is None:
            donate_batch = overrides.get("donate_batch")
        self._donate_batch = bool(donate_batch)
        if partition_rules is None and param_shardings is None:
            partition_rules = overrides.get("partition_rules")
        self._partition_rules = partition_rules
        self._param_shardings = param_shardings
        # the model name the cost ledger's lines carry
        self.model_desc = (model_desc if model_desc is not None
                           else (model if isinstance(model, str)
                                 else getattr(model, "__name__",
                                              type(model).__name__)))
        if compute_dtype is None and output_host_dtype is None:
            compute_dtype = overrides.get("compute_dtype")
            output_host_dtype = overrides.get("output_host_dtype")
        self.metrics = metrics if metrics is not None else Metrics()
        self._clock = clock if clock is not None else time.monotonic
        self.max_batch_size = max(1, int(max_batch_size))
        self._buckets = bucket_plan(self.max_batch_size,
                                    bucket_sizes=bucket_sizes,
                                    mesh=self._mesh)
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
        self._health = HealthTracker("serving.health")
        # cost attribution: None resolves SPARKDL_COST, False is unmetered,
        # a CostLedger may be shared; the first health binder wins
        from sparkdl_tpu_torch.obs.cost import resolve_cost

        self._cost = resolve_cost(cost)
        if self._cost is not None:
            self._cost.bind_health(self._health)
        self._cost_hbm: Dict[int, float] = {}
        # declarative objectives over this server's metrics, evaluated on
        # every health() poll; a breach degrades the same tracker
        self._slo_engine = None
        if slos:
            from sparkdl_tpu_torch.obs.slo import SLOEngine

            self._slo_engine = SLOEngine(self.metrics, slos,
                                         health=self._health,
                                         clock=self._clock)
        # owned (auto-generated anon) namespaces are reclaimed from the
        # possibly shared store by close()
        self._cache, self._cache_ns, self._cache_ns_owned = resolve_cache(
            cache, cache_namespace, "server")
        self._engines: Dict[int, InferenceEngine] = {}
        self._warm: set = set()  # buckets whose graph is captured
        # bucket -> (input signature, precision flags) of its last dispatch
        self._programs: Dict[int, tuple] = {}
        self._engine_lock = named_lock("serving.engines")
        self._ragged = (ragged_enabled_from_env() if ragged is None
                        else bool(ragged))
        self._batcher = DynamicBatcher(
            max_batch_size=self.max_batch_size, max_wait_ms=max_wait_ms,
            max_queue=max_queue,
            bucket_plan=self._buckets if self._ragged else None,
            align=int(self._mesh.shape[DATA_AXIS]),
            metrics=self.metrics, clock=self._clock)
        # the slowest requests' span trees (inert while tracing is off)
        self.exemplars = ExemplarReservoir(k=4)
        self._closed = False
        self._abandon = threading.Event()
        self._inflight = 0
        self._inflight_cond = named_condition("serving.inflight")
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
                        self._fn, self._module, mesh=self._mesh,
                        device_batch_size=bucket,
                        partition_rules=self._partition_rules,
                        param_shardings=self._param_shardings,
                        donate_batch=self._donate_batch,
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
            stacked = _tree_map(lambda a: np.stack([a] * b), example)
            self._note_program(b, stacked)
            eng(stacked)
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

    def breaker_retry_after(self) -> Optional[float]:
        """Public form of the per-submit breaker query: the remaining
        cool-down of the worst OPEN bucket breaker, or None when admission
        is open.  The fleet's front door reads it to shed lower-priority
        tenants first while the model's device is failing."""
        return self._breaker_retry_after()

    def health(self) -> Dict[str, Any]:
        """Liveness/readiness snapshot (JSON-serializable; also in
        :meth:`varz`), through :meth:`HealthTracker.payload`: ``live``
        (False once closed), ``state`` (``ready``, ``degraded`` while a
        breaker is open or half-open or after a failure with no success
        since, or ``closed``), ``last_error``, the bounded ``transitions``
        history, ``breaker`` (per-bucket circuit-breaker state), and
        ``slo``, the objectives' evaluation when ``slos=`` were given (each
        poll takes one burn-rate sample, before the snapshot, so a breach
        crossing on this poll already shows as degraded)."""
        extra: Dict[str, Any] = {}
        if self._slo_engine is not None:
            extra["slo"] = self._slo_engine.evaluate()
        breakers = self._breaker_states()
        state_override = None
        if any(st["state"] in ("open", "half_open")
               for st in breakers.values()):
            state_override = "degraded"
        if self._closed:
            state_override = "closed"
        return self._health.payload(live=not self._closed,
                                    state_override=state_override,
                                    breaker=breakers, **extra)

    # -- request path ------------------------------------------------------
    def submit(self, example: Any,
               timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Admit one example; returns its ``concurrent.futures.Future``.

        ``tenant`` is the cost-attribution identity: it changes nothing
        about scheduling or admission, only which ledger line the
        request's device and queue time land on (None charges
        ``"default"``).

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
            return self._submit_cached(example, timeout_ms, tenant)
        return self._submit_dispatch(example, timeout_ms, tenant=tenant)

    def _charge_hit(self, tenant: Optional[str], kind: str) -> None:
        """The ledger's zero-device-second charge for a cache-absorbed
        request.  Attribution is observability: any failure (the
        ``cost.attr`` fault site included) degrades to an error counter,
        never a failed request."""
        if self._cost is None:
            return
        try:
            self._cost.record_hit(tenant=tenant or "default",
                                  model=self.model_desc, kind=kind)
        except Exception as e:  # noqa: BLE001 — attribution never fails a request
            self.metrics.incr("serving.cost_attr_errors")
            self._cost.record_error()
            logger.warning("cost attribution (%s) failed: %s: %s", kind,
                           type(e).__name__, e)

    def _submit_cached(self, example: Any, timeout_ms: Optional[float],
                       tenant: Optional[str] = None) -> Future:
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
            self._charge_hit(tenant, "hit")
            fut: Future = Future()
            fut.set_result(res)
            return fut
        if kind == "follower":
            self.metrics.incr("serving.requests")
            self.metrics.incr("serving.cache_coalesced")
            self._charge_hit(tenant, "coalesced")

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
                                        preprocessed=True, tenant=tenant)
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
            # graftlint: allow=SDL003 reason=the leader error is relayed to every follower via cache.fail and the caller future; re-raising in a done-callback would only hit the executor
            except BaseException as e:  # noqa: BLE001
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
                         preprocessed: bool = False,
                         tenant: Optional[str] = None) -> Future:
        """The direct dispatch path (the whole request path without a
        cache; the single-flight leader's path with one)."""
        retry_after = self._breaker_retry_after()
        if retry_after is not None:
            # counted in serving.requests too: shed-rate consumers divide
            # rejected_* by requests
            self.metrics.incr("serving.requests")
            self.metrics.incr("serving.rejected_breaker_open")
            flight_emit("serving.shed", reason="breaker_open",
                        retry_after_s=round(retry_after, 4))
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
        req = Request(example, deadline, now=now_m,
                      tenant=tenant if tenant is not None else "default")
        tracer = get_tracer()
        if tracer.enabled:
            # the root span of this request's trace: submit -> settle
            req.span = tracer.start_span(
                "serving.request",
                timeout_ms=None if timeout_s is None else timeout_s * 1e3)
        self.metrics.incr("serving.requests")
        try:
            self._batcher.submit(req)
        except BaseException:
            req.finish_span("rejected")
            raise
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

    @staticmethod
    def _metered_kwargs(eng, on_metered) -> Dict[str, Any]:
        """``{"on_metered": ...}`` only when ``eng`` takes it: a plain
        ``fn(batch)`` substituted for the engine (tests, embedders) still
        serves, it just does not feed the ledger's device-time meter (nor
        the engine's ``engine.device_time_s``, so conservation holds).  The
        signature probe is cached on the callable."""
        if on_metered is None:
            return {}
        cached = getattr(eng, "_sdl_accepts_on_metered", None)
        if cached is None:
            try:
                params = inspect.signature(eng).parameters
                cached = ("on_metered" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()))
            except (TypeError, ValueError):
                cached = False
            try:
                eng._sdl_accepts_on_metered = cached
            except AttributeError:
                pass
        return {"on_metered": on_metered} if cached else {}

    def _guarded_call(self, eng, stacked, requests: List[Request],
                      finish: _Once, on_metered=None):
        """One model-call ATTEMPT under the stall watchdog.  The timer is
        armed per attempt and covers ONLY the engine call (a bucket's first
        call, warm-up forward and capture, ran untimed in ``_execute``; the
        demux runs after the timer is disarmed).  The ``serving.model``
        fault site sits INSIDE the window (a ``sleep`` rule is a wedged
        model the watchdog must catch; an ``error`` rule a per-batch model
        failure).  ``on_metered`` receives the attempt's metered engine
        seconds (the cost ledger's device time)."""
        meter_kw = self._metered_kwargs(eng, on_metered)
        if self._dispatch_timeout_s is None:
            inject("serving.model")
            return eng(stacked, **meter_kw)
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
            return eng(stacked, **meter_kw)
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
            flight_emit("batch.topoff", rows=len(extras), base=base,
                        bucket=bucket)
        return extras

    def _execute(self, requests: List[Request], finish: _Once) -> None:
        n = len(requests)
        bucket = self._bucket_for(n)
        extras: List[Request] = []
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
        queue_by: Dict[str, float] = {}
        for r in requests:
            waited = now - r.enqueued_at
            self.metrics.record_time("serving.time_in_queue", waited)
            queue_by[r.tenant] = queue_by.get(r.tenant, 0.0) + waited
        stacked = _tree_map(lambda *rows: np.stack(rows, axis=0),
                            *[r.payload for r in requests])
        eng = self._engine_for(bucket)
        self._note_program(bucket, stacked)
        if self._dispatch_timeout_s is not None and bucket not in self._warm:
            # capture OUTSIDE the watchdog window: a bucket's first call
            # runs an eager warm-up forward and the capture (seconds for a
            # real model)
            eng(_tree_map(np.zeros_like, stacked))
            self._warm.add(bucket)
        tracer = get_tracer()
        batch_span = requests[0].batch_span
        if batch_span is not None:
            batch_span.annotate(bucket=bucket)
            if extras:
                # the late arrivals ride this batch too: their traces join
                # its members (the JAX batch span leaves them out)
                batch_span.annotate(
                    batch_size=n, topped_off=len(extras),
                    member_traces=batch_span.attrs["member_traces"] + [
                        r.span.trace_id for r in extras
                        if r.span is not None])
        t0 = time.monotonic()  # real: batch_seconds_hint sizes real waits
        # per-attempt metered engine seconds, the ledger's device time: a
        # retried batch is charged what every attempt burned
        metered: List[float] = []
        # this worker re-roots on the micro-batch span, so the engine's
        # spans (engine.call -> engine.dispatch) nest under it
        with tracer.use(batch_span):
            # CircuitOpenError is exempt from the batch retry budget: an
            # open breaker fails fast by design
            out = with_retries(
                lambda: self._guarded_call(eng, stacked, requests, finish,
                                           on_metered=metered.append),
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
        # charge the settled batch BEFORE its futures resolve, so a caller
        # that reads the ledger after its result sees it charged
        if self._cost is not None:
            self._charge_batch(eng, bucket, requests, metered, queue_by)
        done = self._clock()
        slowest: Optional[Request] = None
        slowest_s = 0.0
        for i, r in enumerate(requests):
            if r.future.done():
                continue  # the watchdog raced us; result discarded
            # copy, don't view: a retained row pins O(row), not the whole
            # [bucket, ...] batch output
            row = _tree_map(lambda a: np.array(a[i], copy=True), out)
            try:
                r.future.set_result(row)
                self.metrics.incr("serving.completed")
                latency_s = done - r.enqueued_at
                self.metrics.record_time("serving.request_latency",
                                         latency_s)
                if latency_s >= slowest_s:
                    slowest, slowest_s = r, latency_s
            except InvalidStateError:
                pass
        # close the micro-batch span BEFORE the request roots, so every
        # child sits inside its parent, then offer the slowest request's
        # trace to the exemplars (a float compare unless it is a new top-K
        # outlier; a no-op with tracing off)
        if batch_span is not None:
            requests[0].batch_span = None
            batch_span.finish()
        slow_trace = (slowest.span.trace_id
                      if slowest is not None and slowest.span is not None
                      else None)
        for r in requests:
            r.finish_span()
        if slow_trace is not None:
            self.exemplars.offer(slowest_s, slow_trace, tracer)

    def _charge_batch(self, eng, bucket: int, requests: List[Request],
                      metered: List[float],
                      queue_by: Dict[str, float]) -> None:
        """Attribute one settled batch: each tenant's real rows, the pad
        rows, the metered engine seconds summed over the attempts, the
        queue seconds per tenant, and the bucket engine's parameter bytes
        on the card.  Degrade, not fail: the batch served, so an
        attribution failure (``cost.attr``) is an error counter."""
        try:
            tenant_rows: Dict[str, int] = {}
            for r in requests:
                tenant_rows[r.tenant] = tenant_rows.get(r.tenant, 0) + 1
            hbm = self._cost_hbm.get(bucket)
            if hbm is None:
                hbm = self._cost_hbm[bucket] = float(eng.param_bytes)
            self._cost.record_batch(
                model=self.model_desc, bucket=bucket,
                tenant_rows=tenant_rows, device_s=sum(metered),
                queue_s_by_tenant=queue_by, pad_rows=bucket - len(requests),
                hbm_bytes=hbm)
        except Exception as e:  # noqa: BLE001 — the batch served; attribution degrades
            self.metrics.incr("serving.cost_attr_errors")
            self._cost.record_error()
            logger.warning("cost attribution failed for batch of %d "
                           "(bucket %d): %s: %s", len(requests), bucket,
                           type(e).__name__, e)

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
    def max_queue(self) -> int:
        return self._batcher.max_queue

    def queue_pressure(self) -> float:
        """Queue occupancy in [0, 1]: the pressure the fleet's admission
        sheds lower-priority tenants against."""
        return self._batcher.depth() / max(1, self._batcher.max_queue)

    def wake(self) -> None:
        """Re-evaluate the batcher's flush conditions: how a virtual-time
        harness tells the dispatcher that the injected clock moved
        (:meth:`DynamicBatcher.wake`)."""
        self._batcher.wake()

    @property
    def cache(self):
        """The result cache this server probes (None when uncached)."""
        return self._cache

    @property
    def cache_namespace(self) -> tuple:
        """The key prefix this server's entries live under."""
        return self._cache_ns

    def executable_state(self) -> Dict[int, Dict[str, Any]]:
        """Per-bucket compiled-program identity, the port's form of the
        JAX server's: ``jit_id`` is the ``id`` of the bucket's captured
        graph (``InferenceEngine.bucket_graph``; None before its capture)
        and ``executables`` the bucket's count of captures.  A head
        mutation, or anything else that truly reuses the captured forward,
        leaves both unchanged (``serving.fleet.rollout.head_swap_report``).
        An engine that captures nothing (the CPU, ``capture=False``)
        reports the ``id`` of the bucket engine and 0."""
        with self._engine_lock:
            engines = dict(self._engines)
        out: Dict[int, Dict[str, Any]] = {}
        for b, eng in sorted(engines.items()):
            if not eng.capture:
                out[b] = {"jit_id": id(eng), "executables": 0}
                continue
            g = eng.bucket_graph()
            out[b] = {"jit_id": None if g is None else id(g),
                      "executables": eng.captures}
        return out

    def _note_program(self, bucket: int, stacked: Any) -> None:
        """Record the bucket's input signature (each leaf's padded shape
        and dtype) and the precision flags of this dispatch."""
        sig = tuple(((bucket,) + tuple(a.shape[1:]), str(a.dtype))
                    for a in _tree_leaves(stacked))
        self._programs[bucket] = (sig, precision_flags())

    def program_state(self) -> Dict[int, Dict[str, Any]]:
        """Per bucket, what a fleet rollout's no-recompile report holds
        two weight versions' servers to (``serving.fleet.rollout``):
        ``fn_id``, the ``id`` of the model fn (one object for every
        version of a fleet entry); ``signature``, the bucket's input shapes
        and dtypes, and ``precision``, the ``precision_flags()``, both as
        of its last dispatch; ``captures``, the bucket engine's count of
        graph captures (0 on the CPU, which captures nothing).  Buckets
        with no dispatch yet are left out."""
        with self._engine_lock:
            engines = dict(self._engines)
        out: Dict[int, Dict[str, Any]] = {}
        for b, eng in sorted(engines.items()):
            prog = self._programs.get(b)
            if prog is None:
                continue
            out[b] = {"fn_id": id(self._fn),
                      "signature": [[list(shape), dtype]
                                    for shape, dtype in prog[0]],
                      "precision": list(prog[1]),
                      "captures": eng.captures}
        return out

    def stats(self) -> Dict[str, float]:
        """Snapshot of the serving metrics (counters, gauges, latency
        p50/p99; see ``utils.metrics.Metrics.summary``), plus any
        ``engine_*`` / ``pipeline.*`` metrics the engines recorded."""
        summary = self.metrics.summary()
        return {k: v for k, v in summary.items()
                if k.startswith(("serving.", "engine_", "pipeline."))}

    def sharding_info(self) -> Optional[Dict[str, Any]]:
        """The bucket engines' weight layout (mesh shape, total vs
        per-device param bytes, sharded leaf count, policy digest,
        ``donate_batch``): every bucket shares one device module and one
        policy, so the first engine speaks for the server; None until a
        bucket engine exists."""
        with self._engine_lock:
            first = next(iter(self._engines.values()), None)
        return None if first is None else first.sharding_info()

    def varz(self) -> Dict[str, Any]:
        """The ``/varz``-shaped structured form of :meth:`stats`, with the
        JAX package's keys: server config/state, health, ``serving.*``
        counters, latency p50/p99 in ms, the full metrics snapshot
        (``obs.export.metrics_snapshot``), the cache section, the cost
        ledger's snapshot (None when unmetered) and the slow-request
        exemplars (full span trees of the slowest requests; filled only
        while tracing is on) and ``sharding`` (:meth:`sharding_info`).
        JSON-serializable throughout."""
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
            "cost": (self._cost.snapshot() if self._cost is not None
                     else None),
            "sharding": self.sharding_info(),
            "exemplars": self.exemplars.snapshot(),
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
        flight_emit("serving.drain", drain=drain,
                    queued=self._batcher.depth())
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


class HeadFanoutServer:
    """Featurize ONCE, serve many per-tenant heads (port of the JAX
    package's ``HeadFanoutServer``).

    One backbone :class:`Server` at the FEATURE cut, fronted by the
    feature-cut cache namespace (``serving.cache.feature_namespace``, keyed
    on the backbone's program fingerprint and weight digest, so a hot
    content digest pays the backbone once and head churn keeps entries
    warm), fanned out through a
    :class:`~sparkdl_tpu_torch.parallel.engine.HeadBank` whose one fan-out
    callable serves every tenant's head by gather-by-tenant-index (kernel
    H1 for the zoo's dense head).  A request on a warm digest costs no
    backbone dispatch and no backbone queue slot, only a head pass.

    ``model`` takes the port's forms, as :class:`Server` does (a zoo model
    name, a ``ModelFunction``, or ``fn(module, batch)`` with its
    ``module``); a zoo name serves its featurizer cut with
    :func:`~sparkdl_tpu_torch.parallel.engine.dense_head_row` heads.
    ``device`` is resolved once, here, for the backbone and the bank.
    Other keyword arguments go to the backbone :class:`Server`.

    :meth:`add_head` / :meth:`swap_head` / :meth:`remove_head` return a
    ``serving.fleet.rollout.head_swap_report``: the backbone buckets'
    captured graphs and capture counts (:meth:`Server.executable_state`)
    and the bank's fan-out callable are unchanged.  The bank mutates
    atomically under its lock, so in-flight requests settle with the old
    head's row or the new one.

    ``cost``: one :class:`~sparkdl_tpu_torch.obs.cost.CostLedger` for the
    tier (None = the ``SPARKDL_COST`` default, False = unmetered): the
    backbone's batches and hits and this tier's feature hits land on the
    same ledger, under ``model_desc``.  A warm request is a
    ``cache.feature_hit`` flight event; the bank's mutations are
    ``head.swap`` events.

    Differences from the JAX package: the weight digest is the port's own
    digest of the backbone module's state
    (``utils.digest.module_digest``), and the fingerprint is the port's
    program lockfile's (``PROGRAMS_TORCH.lock.json``; ``"unpinned"`` for a
    backbone it does not audit), so the namespaces differ between the
    packages.  ``mesh=`` reaches the
    backbone ``Server`` and the :class:`HeadBank` (this process's one
    device, as an engine's)."""

    def __init__(self, model, module: Optional[nn.Module] = None, *,
                 head_fn: Optional[Callable] = None,
                 mesh=None,
                 hbm_budget_bytes: Optional[int] = None,
                 cache: Any = None,
                 cost: Any = None,
                 metrics: Optional[Metrics] = None,
                 model_desc: Optional[str] = None,
                 device: DeviceLike = None,
                 **server_kwargs):
        from sparkdl_tpu_torch.parallel.engine import HeadBank
        from sparkdl_tpu_torch.serving.cache import (
            feature_namespace, lockfile_model_fingerprint)
        from sparkdl_tpu_torch.utils.digest import module_digest

        mesh = resolve_engine_mesh(mesh, device)
        self._device = resolve_device(mesh.devices.flat[0])
        if isinstance(model, str):
            if module is not None:
                raise ValueError("module must be None when serving a named "
                                 "zoo model")
            from sparkdl_tpu_torch.transformers.named_image import \
                zoo_serving_bundle

            fn, module, overrides, zoo_head = zoo_serving_bundle(
                model, featurize=True, feature_cut=True)
            if head_fn is None:
                head_fn = zoo_head
            desc = model
        else:
            fn, module, overrides = _resolve_model(model, module,
                                                   featurize=True)
            desc = getattr(model, "__name__", type(model).__name__)
        self.model_desc = model_desc if model_desc is not None else desc
        self.metrics = metrics if metrics is not None else Metrics()
        # the backbone's identity, pinned once: its program fingerprint
        # (None in the port) and its weight digest key the feature-cut
        # namespace; head churn touches neither
        self._fingerprint = lockfile_model_fingerprint(self.model_desc)
        self._weights_digest = module_digest(module)
        self._feature_ns = feature_namespace(
            self.model_desc, self._fingerprint, self._weights_digest)
        # zoo engine overrides ride along (caller kwargs win, and the dtype
        # pair travels together)
        dtype_keys = ("compute_dtype", "output_host_dtype")
        caller_set_dtype = any(k in server_kwargs for k in dtype_keys)
        for k, v in overrides.items():
            if k in dtype_keys and caller_set_dtype:
                continue
            server_kwargs.setdefault(k, v)
        resolved_cache, _, _ = resolve_cache(cache, self._feature_ns,
                                             "headfanout")
        # one ledger for the tier: the feature hits charged here and the
        # backbone's batches land on the same instance
        from sparkdl_tpu_torch.obs.cost import resolve_cost

        self._cost = resolve_cost(cost)
        self._backbone = Server(fn, module, mesh=mesh,
                                cache=(resolved_cache if resolved_cache
                                       is not None else False),
                                cache_namespace=self._feature_ns,
                                metrics=self.metrics,
                                cost=(self._cost if self._cost is not None
                                      else False),
                                model_desc=self.model_desc,
                                **server_kwargs)
        self._bank = HeadBank(head_fn=head_fn, mesh=mesh,
                              hbm_budget_bytes=hbm_budget_bytes,
                              metrics=self.metrics)
        self.last_head_swap_report: Optional[Dict[str, Any]] = None
        self._swap_lock = named_lock("serving.headfanout.swap")

    # -- head management (the no-backbone-recompile surface) --------------
    @property
    def bank(self):
        """The :class:`HeadBank` serving this tier's head pass."""
        return self._bank

    @property
    def backbone(self) -> Server:
        """The feature-cut backbone server."""
        return self._backbone

    @property
    def feature_namespace(self) -> tuple:
        """The feature-cut cache namespace (backbone identity only)."""
        return self._feature_ns

    @property
    def device(self):
        """The device the backbone and the bank run on."""
        return self._device

    def tenants(self) -> List[str]:
        return self._bank.tenants()

    def _head_mutation(self, op: str, tenant: str, weights) -> Dict[str, Any]:
        from sparkdl_tpu_torch.serving.cache import lockfile_model_fingerprint
        from sparkdl_tpu_torch.serving.fleet.rollout import head_swap_report

        with self._swap_lock:
            exec_before = self._backbone.executable_state()
            bank_before = self._bank.jit_info()
            fp_before = self._fingerprint
            if op == "add":
                self._bank.add_head(tenant, weights)
            elif op == "swap":
                self._bank.swap_head(tenant, weights)
            else:
                self._bank.remove_head(tenant)
            report = head_swap_report(
                self.model_desc, tenant, op,
                exec_before, self._backbone.executable_state(),
                bank_before, self._bank.jit_info(),
                fp_before, lockfile_model_fingerprint(self.model_desc))
            self.last_head_swap_report = report
            return report

    def add_head(self, tenant: str, weights) -> Dict[str, Any]:
        """Register a new tenant's head; returns the no-backbone-recompile
        report (``head_swap_report``)."""
        return self._head_mutation("add", tenant, weights)

    def swap_head(self, tenant: str, weights) -> Dict[str, Any]:
        """Hot-swap an existing tenant's head under load; returns the
        report."""
        return self._head_mutation("swap", tenant, weights)

    def remove_head(self, tenant: str) -> Dict[str, Any]:
        """Evict a departed tenant's head; returns the report."""
        return self._head_mutation("remove", tenant, None)

    # -- request path ------------------------------------------------------
    def _feature_probe(self, example: Any):
        """The digest-keyed feature row from the feature-cut cache, or
        None: ``host_preprocess``, then ``content_digest``, then
        ``InferenceCache.get``, which has no side effect on a miss (miss
        accounting stays with the backbone's single-flight lookup)."""
        cache = self._backbone.cache
        if cache is None:
            return None
        probe = example
        if self._backbone._host_preprocess is not None:
            probe = self._backbone._host_preprocess(probe)
        probe = _tree_map(np.asarray, probe)
        return cache.get(self._feature_ns + (content_digest(probe),))

    def _head_row(self, feats, tenant: str):
        return self._bank.dispatch(np.asarray(feats)[None], [tenant])[0]

    def submit(self, example: Any, tenant: str,
               timeout_ms: Optional[float] = None) -> Future:
        """Admit one (example, tenant) request; returns a Future of the
        tenant's head output row.

        A warm content digest short-circuits BEFORE the backbone server:
        no backbone queue slot, no dispatch, a head pass only.  A cold one
        rides the backbone's cached submit path (single-flight leaders:
        N concurrent identical payloads cost ONE backbone dispatch), and
        the head pass runs when the features settle."""
        tenant = str(tenant)
        self.metrics.incr("headfanout.requests")
        feats_value = self._feature_probe(example)
        if feats_value is not None:
            self.metrics.incr("headfanout.feature_hits")
            flight_emit("cache.feature_hit", tenant=tenant)
            self._charge_feature_hit(tenant)
            out: Future = Future()
            try:
                row = self._head_row(feats_value, tenant)
            # graftlint: allow=SDL003 reason=the error is the future's result; the caller decides
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)
            else:
                out.set_result(row)
            return out
        feats_fut = self._backbone.submit(example, timeout_ms=timeout_ms,
                                          tenant=tenant)
        out = Future()

        def _features_done(f: Future) -> None:
            try:
                row = self._head_row(f.result(), tenant)
            # graftlint: allow=SDL003 reason=relayed to the caller's future; raising in a done-callback would only hit the executor's swallow
            except BaseException as e:  # noqa: BLE001
                if not out.done():
                    out.set_exception(e)
            else:
                if not out.done():
                    out.set_result(row)

        feats_fut.add_done_callback(_features_done)
        return out

    def predict(self, example: Any, tenant: str,
                timeout_ms: Optional[float] = None):
        """Blocking single-request form of :meth:`submit`."""
        return self.submit(example, tenant, timeout_ms=timeout_ms).result()

    def predict_batch(self, examples: Sequence[Any],
                      tenants: Sequence[str],
                      timeout_ms: Optional[float] = None) -> List[Any]:
        """K tenants' rows, ONE head pass: every row's features (warm
        digests from the cache, cold ones through the backbone, which
        batches and coalesces them), stacked and dispatched as one
        mixed-tenant batch through the bank."""
        tenants = [str(t) for t in tenants]
        if len(tenants) != len(examples):
            raise ValueError(f"{len(examples)} examples but "
                             f"{len(tenants)} tenants")
        self.metrics.incr("headfanout.requests", len(tenants))
        rows: List[Any] = [None] * len(tenants)
        pending: List[tuple] = []
        for i, ex in enumerate(examples):
            feats = self._feature_probe(ex)
            if feats is not None:
                self.metrics.incr("headfanout.feature_hits")
                flight_emit("cache.feature_hit", tenant=tenants[i])
                self._charge_feature_hit(tenants[i])
                rows[i] = np.asarray(feats)
            else:
                pending.append(
                    (i, self._backbone.submit(ex, timeout_ms=timeout_ms,
                                              tenant=tenants[i])))
        for i, fut in pending:
            rows[i] = np.asarray(fut.result())
        out = self._bank.dispatch(np.stack(rows), tenants)
        self.metrics.incr("headfanout.head_passes")
        return [out[i] for i in range(len(tenants))]

    def _charge_feature_hit(self, tenant: str) -> None:
        """The ledger's charge for a feature-cut short-circuit, with
        ``Server._charge_hit``'s degrade-not-fail contract."""
        if self._cost is None:
            return
        try:
            self._cost.record_hit(tenant=tenant, model=self.model_desc,
                                  kind="feature_hit")
        except Exception as e:  # noqa: BLE001 — attribution never fails a request
            self.metrics.incr("serving.cost_attr_errors")
            self._cost.record_error()
            logger.warning("cost attribution (feature_hit) failed: "
                           "%s: %s", type(e).__name__, e)

    # -- proof / observability surfaces -----------------------------------
    def executable_state(self) -> Dict[int, Dict[str, Any]]:
        """The BACKBONE's per-bucket captured-graph identity (the half the
        no-recompile proof pins; the head side is :meth:`head_state`)."""
        return self._backbone.executable_state()

    def head_state(self) -> Dict[str, Any]:
        """The head bank's fan-out identity (``HeadBank.jit_info``)."""
        return self._bank.jit_info()

    def head_stats(self) -> Dict[str, Any]:
        """The bank's bytes, capacity and mode (``HeadBank.stats``)."""
        return self._bank.stats()

    def warmup(self, example: Any) -> None:
        """Capture the backbone's bucket graphs (no cache writes)."""
        self._backbone.warmup(example)

    def warm_head(self, features_row) -> None:
        """One head pass of a zeroed feature row for the first tenant, so
        that a measurement never charges the head's first call (the
        kernel library's load on the card)."""
        ts = self._bank.tenants()
        if not ts:
            return
        row = np.zeros_like(np.asarray(features_row))
        self._bank.dispatch(row[None], [ts[0]])

    def health(self) -> Dict[str, Any]:
        return self._backbone.health()

    def queue_depth(self) -> int:
        return self._backbone.queue_depth()

    def queue_pressure(self) -> float:
        return self._backbone.queue_pressure()

    def breaker_retry_after(self) -> Optional[float]:
        return self._backbone.breaker_retry_after()

    def wake(self) -> None:
        self._backbone.wake()

    @property
    def cache(self):
        return self._backbone.cache

    @property
    def cost(self):
        """The tier's cost ledger (None when unmetered)."""
        return self._cost

    @property
    def bucket_sizes(self) -> List[int]:
        return self._backbone.bucket_sizes

    @property
    def graph_pool_bytes(self) -> int:
        """The backbone buckets' graph pool bytes (0 after :meth:`close`)."""
        return self._backbone.graph_pool_bytes

    def stats(self) -> Dict[str, float]:
        summary = self.metrics.summary()
        return {k: v for k, v in summary.items()
                if k.startswith(("serving.", "engine_", "pipeline.",
                                 "headfanout.", "headbank."))}

    def varz(self) -> Dict[str, Any]:
        """The backbone's ``/varz`` body plus the fan-out's ``headfanout``
        section (bank stats, fan-out identity, namespace, feature-hit
        counters, the last swap report), with the fan-out's counters also
        in the cache section as ``cache.feature_hits`` /
        ``cache.feature_requests`` (the JAX package's schema), and the
        tier's cost ledger snapshot as ``cost``."""
        doc = self._backbone.varz()
        snap = doc.get("metrics", {}).get("counters", {})
        doc["headfanout"] = {
            "tenants": len(self._bank),
            "bank": self._bank.stats(),
            "head_state": self._bank.jit_info(),
            "feature_namespace": list(self._feature_ns),
            "requests": snap.get("headfanout.requests", 0),
            "feature_hits": snap.get("headfanout.feature_hits", 0),
            "head_passes": snap.get("headfanout.head_passes", 0),
            "last_head_swap_report": self.last_head_swap_report,
        }
        if doc.get("cache") is not None:
            counters = doc["cache"].setdefault("counters", {})
            counters["cache.feature_hits"] = snap.get(
                "headfanout.feature_hits", 0)
            counters["cache.feature_requests"] = snap.get(
                "headfanout.requests", 0)
        if self._cost is not None:
            doc["cost"] = self._cost.snapshot()
        return doc

    def close(self, drain: bool = True,
              timeout_s: Optional[float] = 30.0) -> None:
        """Close the backbone server (its graph pool goes back to the
        card).  Feature entries stay: the namespace is the backbone's
        identity, not this object's, so a later server over the same
        backbone serves them warm."""
        self._backbone.close(drain=drain, timeout_s=timeout_s)

    def __enter__(self) -> "HeadFanoutServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)
