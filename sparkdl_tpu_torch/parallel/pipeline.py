"""Pipelined host/device execution for the engine (port of
``sparkdl_tpu/parallel/pipeline.py``).

A bounded stage graph

    host prepare (decode, pad into pinned buffers)  ->  upload + dispatch
                                                     ->  fetch + trim

runs on three threads with backpressure queues, so batch k+1 decodes while
batch k computes and batch k-1 is fetched.  CUDA launches are asynchronous,
which gives the device-side overlap; this layer gives the host-side one.

Contracts:
  * outputs bit-identical to the serial path, in the same order: the stages
    call the engine's own methods (``_iter_pieces``, ``run_padded``,
    ``_dispatch_group``, ``_force_parts``) in the serial path's order;
  * bounded residency: every queue is bounded, so prepare runs at most
    ``depth`` pieces ahead of the dispatch and at most ``window``
    dispatches (groups under ``batches_per_dispatch``) are in flight;
  * every hand-over of device work between threads goes through a CUDA
    event: the dispatch stage records one after each dispatch, and the
    gather stage's fetch waits on it;
  * stage stalls and queue depths land in the engine's metrics under
    ``pipeline.*``.

Failure domain: each stage loop has a fault site (``pipeline.prepare`` /
``pipeline.dispatch`` / ``pipeline.gather``); a stage crash cancels the
graph, joins every worker with a bounded timeout and re-raises on the
consumer side as :class:`PipelineStageError` naming the stage and piece,
with the cause chained.

Tracing (``SPARKDL_TRACE``): one ``pipeline.run`` span brackets the stage
graph (parented to the consumer thread's current span, e.g.
``engine.call``) and each stage records one child span per piece
(``pipeline.prepare`` / ``pipeline.dispatch`` / ``pipeline.gather``).  The
gather span waits for the dispatch's event inside itself
(``block_until_ready``, credited to its ``device_s``) and carries the
dispatch's CUDA-event ``device_ms``.  With tracing off each stage pays one
enabled-check per piece.

``SPARKDL_PIPELINE=0`` runs the serial path everywhere.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np

from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.obs.trace import get_tracer
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)

_DONE = object()    # end-of-stream marker flowing through every queue
_ABORT = object()   # returned by the queue helpers when the run was cancelled


class PipelineStageError(RuntimeError):
    """A pipeline worker stage crashed: ``stage`` (``prepare`` /
    ``dispatch`` / ``gather``) and ``piece`` (the 0-based piece index the
    stage was working on; -1 before the first).  The cause is chained as
    ``__cause__`` and echoed in the message; every stage thread has exited
    before this raises."""

    def __init__(self, stage: str, piece: int, cause: BaseException):
        super().__init__(
            f"pipeline {stage} stage failed at piece {piece}: "
            f"{type(cause).__name__}: {cause}")
        self.stage = stage
        self.piece = piece


class PipelineStageFatalError(PipelineStageError, ValueError):
    """The deterministic variant, raised when the cause is in
    ``utils.retry.NON_RETRYABLE``: a ``ValueError``, so retry wrappers still
    fail fast."""


def wrap_stage_error(stage: str, piece: int,
                     cause: BaseException) -> BaseException:
    """The consumer-side re-raise policy: wrap into the
    :class:`PipelineStageError` family, except the engine's
    ``CircuitOpenError``, which callers must see unwrapped."""
    # runtime import: the engine imports this module
    from sparkdl_tpu_torch.parallel.engine import CircuitOpenError
    from sparkdl_tpu_torch.utils.retry import NON_RETRYABLE

    if isinstance(cause, CircuitOpenError):
        return cause
    cls = (PipelineStageFatalError if isinstance(cause, NON_RETRYABLE)
           else PipelineStageError)
    return cls(stage, piece, cause)


def pipeline_enabled_from_env() -> bool:
    """``SPARKDL_PIPELINE`` (default on); ``0``/``false``/``off``/``no``
    select the serial path."""
    raw = os.environ.get("SPARKDL_PIPELINE", "").strip().lower()
    return raw not in ("0", "false", "off", "no")


class PipelinedRunner:
    """Runs an :class:`~sparkdl_tpu_torch.parallel.engine.InferenceEngine`
    over an iterator of host batches with prepare, dispatch and gather on
    three threads.

    ``window`` bounds dispatched-but-ungathered dispatches (scaled to groups
    under ``batches_per_dispatch``, as the serial path does); ``depth``
    bounds how far prepare runs ahead of dispatch and how many gathered
    outputs wait for the consumer."""

    def __init__(self, engine, window: int = 2, depth: int = 2,
                 metrics: Optional[Metrics] = None):
        self.engine = engine
        bpd = engine.batches_per_dispatch
        w = max(1, int(window))
        self.window = max(1, w // bpd) if bpd > 1 else w
        self.depth = max(1, int(depth))
        self.metrics = metrics if metrics is not None else engine.metrics

    def _put(self, q: "queue.Queue", item, stop: threading.Event,
             stage: str, qname: str) -> bool:
        """Bounded put with backpressure accounting; False when the run was
        cancelled."""
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
            except queue.Full:
                continue
            stall = time.perf_counter() - t0
            if stall > 1e-4:
                self.metrics.incr(f"pipeline.{stage}_out_stall_s", stall)
            self.metrics.observe(f"pipeline.{qname}_depth", q.qsize())
            return True
        return False

    def _get(self, q: "queue.Queue", stop: threading.Event, stage: str):
        """Bounded get with starvation accounting; ``_ABORT`` on cancel."""
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                item = q.get(timeout=0.05)
            except queue.Empty:
                continue
            stall = time.perf_counter() - t0
            if stall > 1e-4:
                self.metrics.incr(f"pipeline.{stage}_in_stall_s", stall)
            return item
        return _ABORT

    def run(self, batches: Iterable[Any]) -> Iterator[Any]:
        """Yield per-piece host outputs, bit-identical to (and in the same
        order as) the serial path."""
        eng = self.engine
        m = self.metrics
        stop = threading.Event()
        errors: list = []
        tracer = get_tracer()
        run_span = (tracer.start_span("pipeline.run",
                                      parent=tracer.current())
                    if tracer.enabled else None)

        prep_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        disp_q: "queue.Queue" = queue.Queue(maxsize=self.window)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)

        def fail(stage: str, piece: int, e: BaseException) -> None:
            # the first failure wins; the consumer re-raises it
            errors.append((stage, piece, e))
            stop.set()

        def prepare() -> None:
            idx = 0
            try:
                # the engine's own piece iterator, as the serial path's
                src = eng._iter_pieces(batches)
                while True:
                    inject("pipeline.prepare", piece=idx)
                    with tracer.span("pipeline.prepare", parent=run_span,
                                     piece=idx) as sp:
                        item = next(src, _DONE)
                        if item is _DONE:
                            sp.annotate(eos=True)
                    if item is _DONE:
                        self._put(prep_q, _DONE, stop, "prepare", "prep_q")
                        return
                    idx += 1
                    if not self._put(prep_q, item, stop, "prepare",
                                     "prep_q"):
                        return
            # graftlint: allow=SDL003 reason=recorded via fail() and re-raised consumer-side as PipelineStageError
            except BaseException as e:
                fail("prepare", idx, e)

        def dispatch() -> None:
            idx = -1
            try:
                while True:
                    item = self._get(prep_q, stop, "dispatch")
                    if item is _ABORT:
                        return
                    if item is _DONE:
                        break
                    idx += 1
                    kind, ns, host = item
                    inject("pipeline.dispatch", piece=idx)
                    # upload + launch: returns once enqueued
                    with tracer.span("pipeline.dispatch",
                                     parent=run_span, kind=kind):
                        dev = (eng.run_padded(host) if kind == "plain"
                               else eng._dispatch_group(host))
                    timing = eng._take_timing()
                    ready = eng._ready_event()
                    m.incr("pipeline.dispatches")
                    if not self._put(disp_q, (kind, ns, dev, ready, timing),
                                     stop, "dispatch", "inflight_q"):
                        return
                self._put(disp_q, _DONE, stop, "dispatch", "inflight_q")
            # graftlint: allow=SDL003 reason=recorded via fail() and re-raised consumer-side as PipelineStageError
            except BaseException as e:
                fail("dispatch", idx, e)

        def gather() -> None:
            idx = -1
            try:
                while True:
                    item = self._get(disp_q, stop, "gather")
                    if item is _ABORT:
                        return
                    if item is _DONE:
                        break
                    idx += 1
                    kind, ns, dev, ready, timing = item
                    inject("pipeline.gather", piece=idx)
                    # the engine's own force (device wait + fetch + trim),
                    # where force-time device errors charge the breaker;
                    # the span covers the wait, the fetch and the trim,
                    # not the downstream puts
                    with tracer.span("pipeline.gather", parent=run_span,
                                     kind=kind) as sp:
                        parts = eng._force_parts(
                            ns, dev, ready, block=sp.block_until_ready,
                            timing=timing)
                    for part in parts:
                        if not self._put(out_q, part, stop, "gather",
                                         "out_q"):
                            return
                    m.incr("pipeline.gathers")
                self._put(out_q, _DONE, stop, "gather", "out_q")
            # graftlint: allow=SDL003 reason=recorded via fail() and re-raised consumer-side as PipelineStageError
            except BaseException as e:
                fail("gather", idx, e)

        threads = [
            threading.Thread(target=prepare, daemon=True,
                             name="sparkdl-pipeline-prepare"),
            threading.Thread(target=dispatch, daemon=True,
                             name="sparkdl-pipeline-dispatch"),
            threading.Thread(target=gather, daemon=True,
                             name="sparkdl-pipeline-gather"),
        ]
        for t in threads:
            t.start()
        try:
            while True:
                try:
                    item = out_q.get(timeout=0.05)
                except queue.Empty:
                    if stop.is_set():
                        break
                    continue
                if item is _DONE:
                    break
                yield item
        finally:
            # cancel every stage (finished, raised or abandoned), then join
            # with a bounded timeout: threads exit within one queue poll
            stop.set()
            for t in threads:
                t.join(timeout=2.0)
                if t.is_alive():
                    logger.warning("pipeline stage thread %s did not exit "
                                   "within 2s of cancellation", t.name)
            # after the join, so every stage span closes before its parent
            if run_span is not None:
                run_span.finish()
        if errors:
            stage, piece, cause = errors[0]
            self.metrics.incr(f"pipeline.{stage}_crashes")
            err = wrap_stage_error(stage, piece, cause)
            if err is cause:
                raise err  # typed pass-through (CircuitOpenError)
            raise err from cause


def pipeline_stage_summary(metrics: Metrics) -> Dict[str, float]:
    """Per-stage stall and occupancy snapshot: stall-second counters
    (``_in_stall_s``: starved for input; ``_out_stall_s``: blocked on
    downstream), dispatch and gather counts, and mean queue depths."""
    out: Dict[str, float] = {}
    for k, v in metrics.subset("pipeline.").items():
        if k.endswith(("_in_stall_s", "_out_stall_s")) or k.endswith(
                ("dispatches", "gathers")) or k.endswith("_depth.mean"):
            out[k] = round(float(v), 4)
    return out


def synthetic_overlap_benchmark(n_batches: int = 6,
                                dispatch_ms: float = 100.0,
                                prepare_ms: float = 100.0,
                                rows: int = 8,
                                feature_dim: int = 4,
                                metrics: Optional[Metrics] = None
                                ) -> Dict[str, Any]:
    """Deterministic proof of host/device overlap on the CPU: the engine's
    ``run_padded`` is wrapped with a ``dispatch_ms`` sleep (the synthetic
    device) and producing each input batch sleeps ``prepare_ms`` (the
    synthetic decode).  The serial path pays ``n * (prepare + dispatch)``,
    the pipelined one about ``n * max(prepare, dispatch)``: 2x ideal at the
    default point.  Outputs are checked equal between the two paths before
    the timings are reported."""
    import torch

    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    rng = np.random.default_rng(0)
    w = torch.from_numpy(
        rng.normal(size=(feature_dim, feature_dim)).astype(np.float32))

    def fn(_module, x):
        return torch.tanh(x @ w)

    m = metrics if metrics is not None else Metrics()
    eng = InferenceEngine(fn, torch.nn.Module(), device="cpu",
                          device_batch_size=rows, metrics=m)
    real_run = eng.run_padded

    def slow_run(batch):  # the synthetic device: a blocking round trip
        time.sleep(dispatch_ms / 1e3)
        return real_run(batch)

    eng.run_padded = slow_run
    x = rng.normal(size=(eng.device_batch_size, feature_dim)
                   ).astype(np.float32)

    def batches():
        for _ in range(n_batches):
            time.sleep(prepare_ms / 1e3)  # the synthetic host decode
            yield x

    list(eng.map_batches([x], pipeline=False))  # warm outside the timing

    t0 = time.perf_counter()
    serial = list(eng.map_batches(batches(), pipeline=False))
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    piped = list(eng.map_batches(batches(), pipeline=True))
    pipelined_s = time.perf_counter() - t0
    if len(serial) != len(piped) or not all(
            np.array_equal(a, b) for a, b in zip(serial, piped)):
        raise AssertionError(
            "pipelined outputs diverged from the serial path")
    return {
        "n_batches": n_batches,
        "dispatch_ms": dispatch_ms,
        "prepare_ms": prepare_ms,
        "serial_s": round(serial_s, 4),
        "pipelined_s": round(pipelined_s, 4),
        "speedup": round(serial_s / pipelined_s, 4),
        "stages": pipeline_stage_summary(m),
    }
