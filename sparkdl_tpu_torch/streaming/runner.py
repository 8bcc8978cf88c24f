"""Crash-safe continuous scoring: source -> engine -> journal (port of
``sparkdl_tpu/streaming/runner.py``).

:class:`StreamScorer` drives a replayable
:class:`~sparkdl_tpu_torch.streaming.source.StreamSource` through the
engine's ``map_batches`` (pipelined by default) or a ``Server``-shaped sink,
journaling every chunk through intent -> output artifact -> commit, so that
a SIGKILL at any instant resumes to exactly-once output, bit for bit:

* chunk payloads flow through one ``map_batches`` call via a generator, so
  the host side of chunk ``k+1`` overlaps the scoring of ``k`` as on the
  offline path (the generator is pulled on the pipeline's prepare thread
  when ``pipeline=True``);
* each scored chunk's output is written atomically (tmp + fsync + rename)
  to ``out-<chunk_id>.npy`` (content-addressed names make the replay's
  rewrite idempotent), then journaled and committed;
* a restart indexes the journal (torn tail truncated), seeks the source to
  the contiguous committed prefix, replays the uncommitted suffix (counted
  as ``stream.redeliveries``) and suppresses by id any chunk the journal
  already committed (``stream.duplicates_suppressed``);
* a source silent past ``stall_deadline_s`` turns :meth:`health` to
  ``degraded`` (the ``Server.health()`` contract) while the runner keeps
  re-polling with seeded jittered backoff; the next chunk recovers it.

Fault sites: ``stream.source`` fires per poll (a ``sleep`` rule is a
stalled source the watchdog must catch; a transient ``error`` is a flaky
feed the backoff absorbs; other kinds propagate), ``stream.commit`` sits
between the output write and the journal commit (the exactly-once crash
point), and ``stream.resume`` fires when a restart replays a chunk that a
previous run left uncommitted.

Departures from the JAX package's runner, each where it would go wrong:
``map_batches`` yields one output per device-batch piece, so a chunk larger
than the engine's ``device_batch_size`` is committed once all of its pieces
have come back (JAX pairs each piece with a chunk); a chunk without rows,
which gives no piece, is refused with ``ValueError``; and when the run
leaves the engine path (finished, raised or closed), the delivery generator
stops polling and the ``map_batches`` generator is closed at once, so the
pipeline's threads stop and no dispatch stays in flight.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, Optional

import numpy as np

from sparkdl_tpu_torch.faults import InjectedTransientError, inject
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.obs.trace import get_tracer
from sparkdl_tpu_torch.streaming.journal import Journal
from sparkdl_tpu_torch.streaming.source import Chunk, StreamSource
from sparkdl_tpu_torch.utils.digest import array_digest
from sparkdl_tpu_torch.utils.health import HealthTracker
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics
from sparkdl_tpu_torch.utils.retry import backoff_delay

logger = get_logger(__name__)


class StreamStallError(RuntimeError):
    """What ``health()["last_error"]`` records while the source is stalled
    past the watchdog deadline (never raised: the policy is to degrade and
    keep re-polling)."""


def _write_artifact_atomic(path: str, arr: np.ndarray) -> None:
    """tmp + fsync + atomic rename: the artifact exists whole or not at
    all, so a SIGKILL never leaves a torn ``.npy`` behind."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


class StreamScorer:
    """Exactly-once continuous scorer; see the module docstring.

    ``sink`` is an :class:`~sparkdl_tpu_torch.parallel.engine.
    InferenceEngine` (anything with ``map_batches``: the pipelined default)
    or a ``Server``-shaped object (anything with ``submit`` returning one
    future a row; each chunk's rows ride the online queue and are stacked
    back in order).  The scorer runs where its sink runs: the engine's or
    the server's device.  Payloads and outputs are single numpy arrays (one
    ``map_batches`` host batch per chunk)."""

    def __init__(self, sink: Any, source: StreamSource, *,
                 journal_path: str, out_dir: str,
                 stall_deadline_s: float = 5.0,
                 poll_backoff_s: float = 0.005,
                 max_poll_backoff_s: float = 0.25,
                 seed: int = 0,
                 window: int = 2,
                 pipeline: Optional[bool] = None,
                 slos: Optional[Any] = None,
                 cache: Any = None,
                 cache_namespace: Optional[Any] = None,
                 metrics: Optional[Metrics] = None):
        if not (hasattr(sink, "map_batches") or hasattr(sink, "submit")):
            raise TypeError(
                f"sink {type(sink).__name__} has neither map_batches "
                f"(engine) nor submit (server)")
        self._sink = sink
        self._source = source
        self._journal = Journal(journal_path)
        self._out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._stall_deadline_s = float(stall_deadline_s)
        self._poll_backoff_s = float(poll_backoff_s)
        self._max_poll_backoff_s = float(max_poll_backoff_s)
        self._rng = random.Random(f"stream:{seed}")
        self._window = int(window)
        self._pipeline = pipeline
        self.metrics = metrics if metrics is not None else Metrics()
        self._health = HealthTracker("stream.health")
        # declarative objectives, evaluated on every health() poll; a
        # burn-rate breach degrades the tracker the stall watchdog uses
        self._slo_engine = None
        if slos:
            from sparkdl_tpu_torch.obs.slo import SLOEngine

            self._slo_engine = SLOEngine(self.metrics, slos,
                                         health=self._health)
        # result cache: a journal replay of a chunk that this process
        # already scored commits the cached output instead of dispatching
        # again (keyed on the content-addressed chunk id).  None resolves
        # the SPARKDL_CACHE process default, False forces uncached; an anon
        # namespace is owned and reclaimed by close(), an explicit one is
        # shared across scorers (the crash-resume idiom)
        from sparkdl_tpu_torch.serving.cache import resolve_cache

        self._cache, self._cache_ns, self._cache_ns_owned = resolve_cache(
            cache, cache_namespace, "stream")
        self._state_lock = threading.Lock()
        # serialises commits and summary accounting between the consumer
        # thread and the delivery generator's replay short-circuit (on
        # the pipeline's prepare thread when pipelined)
        self._commit_lock = threading.Lock()
        # set when a run leaves its sink loop: the delivery generator stops
        # polling, so no prepare thread outlives the run
        self._halt = threading.Event()
        self._closed = False
        self._finished = False
        self._stalled = False
        self._watermark = 0
        self._last_progress = time.monotonic()

    # -- journal / source plumbing -----------------------------------------
    @property
    def journal(self) -> Journal:
        return self._journal

    def close(self) -> None:
        """Stop the run loop at the next chunk boundary (commits already
        journaled stay committed: close is not rollback)."""
        with self._state_lock:
            first_close = not self._closed
            self._closed = True
        self._journal.close()
        if first_close and self._cache is not None and self._cache_ns_owned:
            self._cache.invalidate(self._cache_ns)

    def _note_progress(self) -> None:
        with self._state_lock:
            self._last_progress = time.monotonic()
            self._stalled = False

    def _lag_s(self) -> float:
        with self._state_lock:
            if self._finished:
                return 0.0
            return time.monotonic() - self._last_progress

    # -- watchdog poll loop ------------------------------------------------
    def _next_chunk(self, begun: int,
                    max_chunks: Optional[int]) -> Optional[Chunk]:
        """Poll until a chunk, clean exhaustion, close or halt.  A source
        silent past ``stall_deadline_s`` degrades health and is re-polled
        with seeded jittered backoff (``utils.retry.backoff_delay``); the
        next chunk turns health back to ready."""
        attempt = 0
        while True:
            with self._state_lock:
                if self._closed:
                    return None
            if self._halt.is_set():
                return None
            if max_chunks is not None and begun >= max_chunks:
                return None
            chunk = None
            try:
                inject("stream.source")
                chunk = self._source.poll()
            except InjectedTransientError as e:
                # a flaky feed: count it, degrade, let the backoff absorb it
                self.metrics.incr("stream.source_errors")
                self._health.note_failure(e)
            if chunk is not None:
                with self._state_lock:
                    recovered = self._stalled
                if recovered:
                    self.metrics.incr("stream.stall_recoveries")
                    flight_emit("stream.stall_recovered",
                                offset=chunk.offset)
                self._note_progress()
                self._health.note_success()
                self.metrics.gauge("stream.lag_seconds", self._lag_s())
                return chunk
            if self._source.exhausted():
                with self._state_lock:
                    self._finished = True
                return None
            lag = self._lag_s()
            self.metrics.gauge("stream.lag_seconds", lag)
            newly_stalled = False
            if lag > self._stall_deadline_s:
                with self._state_lock:
                    newly_stalled = not self._stalled
                    self._stalled = True
            if newly_stalled:
                self.metrics.incr("stream.stalls")
                flight_emit("stream.stall", lag_s=round(lag, 4),
                            deadline_s=self._stall_deadline_s)
                self._health.note_failure(StreamStallError(
                    f"source silent for {lag:.3f}s (deadline "
                    f"{self._stall_deadline_s:.3f}s); re-polling"))
                logger.warning("stream source stalled (%.3fs > %.3fs)",
                               lag, self._stall_deadline_s)
            time.sleep(backoff_delay(
                attempt, self._poll_backoff_s,
                max_backoff_seconds=self._max_poll_backoff_s,
                jitter=0.5, rng=self._rng))
            attempt += 1

    # -- the commit path ---------------------------------------------------
    def _commit_chunk(self, chunk: Chunk, out: Any, t_recv: float,
                      from_cache: bool = False) -> None:
        """Artifact write -> output record -> [crash window] -> commit.
        Artifacts are named by the content-addressed chunk id, so a
        replayed chunk rewrites the identical file instead of adding one."""
        arr = np.asarray(out)
        if self._cache is not None and not from_cache:
            # inserted before the crash-window inject below, so that the
            # replay following an injected commit fault finds it
            self._cache.put(self._cache_ns + (chunk.chunk_id,), arr)
        name = f"out-{chunk.chunk_id}.npy"
        _write_artifact_atomic(os.path.join(self._out_dir, name), arr)
        self._journal.record_output(chunk.chunk_id, chunk.offset, name,
                                    array_digest(arr))
        inject("stream.commit")
        if self._journal.commit(chunk.chunk_id, chunk.offset):
            self.metrics.incr("stream.commits")
            flight_emit("stream.commit", chunk_id=chunk.chunk_id,
                        offset=chunk.offset)
        self._note_progress()
        self._watermark_update()
        self.metrics.record_time("stream.chunk_latency",
                                 time.monotonic() - t_recv)

    def _watermark_update(self) -> None:
        wm = self._journal.resume_offset()
        with self._state_lock:
            self._watermark = wm
        self.metrics.gauge("stream.watermark", wm)
        self.metrics.gauge("stream.lag_seconds", self._lag_s())

    # -- run ---------------------------------------------------------------
    def run(self, max_chunks: Optional[int] = None) -> Dict[str, Any]:
        """Score the stream until the source is exhausted (or ``max_chunks``
        chunks have been scored, or :meth:`close`).

        Resume first: seeks the source to the journal's contiguous committed
        prefix, replays uncommitted chunks (``stream.resume`` fires per
        replayed chunk), suppresses committed duplicates by id, then streams
        new chunks through the sink.  Returns a summary dict; raises on sink
        failure, non-transient source faults, or a journal append that
        cannot reach the disk (a ``PipelineStageError`` naming the prepare
        stage on the pipelined path)."""
        resume_offset = self._journal.resume_offset()
        summary: Dict[str, Any] = {
            "resume_offset": resume_offset,
            "recovered_torn_bytes": self._journal.recovered_torn_bytes,
            "chunks_scored": 0,
            "redeliveries": 0,
            "duplicates_suppressed": 0,
            "cache_hits": 0,
        }
        self._source.seek(resume_offset)
        self._halt.clear()
        with self._state_lock:
            self._watermark = resume_offset
            self._last_progress = time.monotonic()
        self.metrics.gauge("stream.watermark", resume_offset)
        with get_tracer().span("stream.run", resume_offset=resume_offset):
            try:
                if hasattr(self._sink, "map_batches"):
                    self._run_engine(summary, max_chunks)
                else:
                    self._run_serving(summary, max_chunks)
                self._health.note_success()
            except BaseException as e:
                # the crash the journal exists for: record it for health()
                # and post-mortems, then let the caller see it
                self._health.note_failure(e)
                raise
        summary["watermark"] = self._journal.resume_offset()
        summary["committed_total"] = self._journal.committed_count()
        return summary

    def _deliveries(self, summary: Dict[str, Any], pending: deque,
                    max_chunks: Optional[int]) -> Iterator[Any]:
        """The delivery generator both sink paths share: poll (with the
        watchdog), suppress committed duplicates, journal the intent, queue
        the chunk as pending, yield its payload.  Runs on the pipeline's
        prepare thread when the engine path is pipelined."""
        begun = 0
        while True:
            chunk = self._next_chunk(begun, max_chunks)
            if chunk is None:
                return
            if self._journal.is_committed(chunk.chunk_id):
                summary["duplicates_suppressed"] += 1
                self.metrics.incr("stream.duplicates_suppressed")
                continue
            if self._journal.seen(chunk.chunk_id):
                # a previous run began this chunk and died before commit
                summary["redeliveries"] += 1
                self.metrics.incr("stream.redeliveries")
                flight_emit("stream.redelivery", chunk_id=chunk.chunk_id,
                            offset=chunk.offset)
                inject("stream.resume")
                cached = (self._cache.get(self._cache_ns + (chunk.chunk_id,))
                          if self._cache is not None else None)
                if cached is not None:
                    # replay short-circuit: this process already scored
                    # these bytes (the chunk id is their digest), so commit
                    # the cached output now; deferring it to the consumer
                    # would leave a replayed, then quiet stream with
                    # intents and no commits.  _commit_and_count serialises
                    # against the consumer's commits
                    self._journal.begin(chunk.chunk_id, chunk.offset)
                    self.metrics.incr("stream.chunks")
                    self.metrics.incr("stream.cache_hits")
                    begun += 1
                    self._commit_and_count(chunk, cached, time.monotonic(),
                                           summary, cached=True)
                    continue
            rows = np.shape(chunk.payload)[0] if np.ndim(chunk.payload) \
                else 0
            if rows == 0:
                raise ValueError(f"chunk at offset {chunk.offset} has no "
                                 f"rows: nothing to score")
            self._journal.begin(chunk.chunk_id, chunk.offset)
            self.metrics.incr("stream.chunks")
            pending.append((chunk, time.monotonic(), rows))
            begun += 1
            yield chunk.payload

    def _commit_and_count(self, chunk: Chunk, out: Any, t_recv: float,
                          summary: Dict[str, Any],
                          cached: bool = False) -> None:
        """One commit and its summary accounting under the commit lock: the
        consumer thread (live outputs) and the replay short-circuit (the
        pipeline's prepare thread) both come through here."""
        with self._commit_lock:
            with get_tracer().span("stream.chunk", offset=chunk.offset,
                                   chunk_id=chunk.chunk_id, cached=cached):
                # a cached value was just read from its key: putting it
                # back would only pay a second copy and sha256
                self._commit_chunk(chunk, out, t_recv, from_cache=cached)
            if cached:
                summary["cache_hits"] += 1
            summary["chunks_scored"] += 1

    def _run_engine(self, summary: Dict[str, Any],
                    max_chunks: Optional[int]) -> None:
        """One ``map_batches`` call over the delivery generator: chunk
        k+1's poll, journal and prepare overlap chunk k's dispatch and
        gather on the pipelined path, while the outputs, yielded in order
        one device-batch piece at a time, are gathered into their chunk's
        rows and committed on this thread."""
        pending: deque = deque()
        outs = self._sink.map_batches(
            self._deliveries(summary, pending, max_chunks),
            window=self._window, pipeline=self._pipeline)
        parts: list = []
        got = 0
        try:
            for out in outs:
                parts.append(out)
                got += np.shape(out)[0]
                chunk, t_recv, rows = pending[0]
                if got < rows:
                    continue
                pending.popleft()
                arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
                parts, got = [], 0
                self._commit_and_count(chunk, arr, t_recv, summary)
        finally:
            self._halt.set()
            outs.close()

    def _run_serving(self, summary: Dict[str, Any],
                     max_chunks: Optional[int]) -> None:
        """Server-sink path: each chunk's rows ride the online admission
        queue as single requests and are stacked back in row order; the
        journal neither knows nor cares which sink scored a chunk."""
        pending: deque = deque()
        for payload in self._deliveries(summary, pending, max_chunks):
            chunk, t_recv, _ = pending.popleft()
            futs = [self._sink.submit(row) for row in payload]
            out = np.stack([np.asarray(f.result()) for f in futs])
            self._commit_and_count(chunk, out, t_recv, summary)

    # -- health ------------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """``Server.health()``'s live / ready / degraded contract for the
        stream, through the one :meth:`~sparkdl_tpu_torch.utils.health.
        HealthTracker.payload` schema: ``state`` is ``degraded`` while the
        lag exceeds the watchdog deadline (or after an unrecovered failure
        or an SLO breach), with the bounded ``transitions`` history, plus
        ``watermark``, ``lag_s`` and ``source_exhausted`` (and ``slo`` when
        objectives were given: each poll takes one burn-rate sample)."""
        extra: Dict[str, Any] = {}
        if self._slo_engine is not None:
            # before the snapshot: a breach crossing on this poll must
            # already show as degraded
            extra["slo"] = self._slo_engine.evaluate()
        with self._state_lock:
            closed = self._closed
            finished = self._finished
            watermark = self._watermark
            lag = (0.0 if finished
                   else time.monotonic() - self._last_progress)
        state_override = None
        if not finished and lag > self._stall_deadline_s:
            state_override = "degraded"
        if closed:
            state_override = "closed"
        return self._health.payload(
            live=not closed, state_override=state_override,
            watermark=watermark, lag_s=round(lag, 3),
            source_exhausted=finished, **extra)


def assemble_outputs(journal_path: str, out_dir: str) -> np.ndarray:
    """The committed artifacts as one array, in offset order: the stream
    half of the exactly-once check (compare with a batch ``map_batches``
    over the same chunks).

    Verifies each artifact against the journal's digest and that the
    committed offsets are dense (0..n-1): a gap or a duplicate offset is an
    at-most- or at-least-once bug, so both raise."""
    j = Journal(journal_path)
    try:
        ids = j.committed_ids()
        offsets = j.committed_offsets()
        if offsets != list(range(len(offsets))):
            raise ValueError(
                f"committed offsets not dense: {offsets[:10]}... — "
                f"exactly-once violated (gap or duplicate)")
        parts = []
        for cid in ids:
            rec = j.output_record(cid)
            if rec is None:
                raise ValueError(f"committed chunk {cid} has no output "
                                 f"record")
            arr = np.load(os.path.join(out_dir, rec["artifact"]),
                          allow_pickle=False)
            if array_digest(arr) != rec["digest"]:
                raise ValueError(f"artifact {rec['artifact']} digest "
                                 f"mismatch — torn or foreign file")
            parts.append(arr)
    finally:
        j.close()
    if not parts:
        return np.empty((0,), np.float32)
    return np.concatenate(parts, axis=0)
