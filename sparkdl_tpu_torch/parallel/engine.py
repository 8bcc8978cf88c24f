"""Batch inference engine (port of ``sparkdl_tpu/parallel/engine.py``'s
``InferenceEngine`` on one device).

Runs ``fn(module, batch) -> out`` over arbitrarily sized host inputs in
fixed-size device batches: each chunk is sliced into ``device_batch_size``
pieces, the ragged tail is zero-padded up to that bucket (counted in
``engine.rows`` / ``engine.pad_rows``) and trimmed off the output.  Batches
and outputs may be pytrees (dicts, lists, tuples) of arrays sharing the
leading batch axis.

On CUDA the forward is ONE captured CUDA graph per (bucket, group), the
port's counterpart of the JAX engine's one compiled program
(``build_dispatch_jit``): the first dispatch of a bucket runs one eager
forward on a side stream (it fills the models' fold caches, runs each
kernel library's one-time setup and builds cuDNN's plans), then captures
the forward, which later dispatches replay.  The graph reads a static
device input and writes a static output: the upload writes into one of two
device staging slots on a copy stream, the compute stream waits on its
event and copies the slot into the static input, replays, and copies the
output out into a fresh tensor.  A graph is captured again when the
weights change (the ``(data_ptr, _version)`` of every parameter and buffer)
or when the precision flags cuDNN and cuBLAS read at capture change.  A
failed capture or replay raises; nothing falls back to eager.
``capture=False`` runs the eager forward on the same upload path (the
references and the tools use it).  The CPU path is always eager.

Host side: on CUDA each piece is padded into its own pinned host buffer
from PyTorch's caching host allocator, which hands a block out again only
after the event of the copy that read it; the output is
fetched on a second copy stream into pinned memory, then trimmed and
widened (bf16 to f32, since numpy has no bf16; ``output_host_dtype`` casts
float leaves only).  ``map_batches`` / ``__call__`` run host prepare,
dispatch and gather on three threads by default
(:class:`~sparkdl_tpu_torch.parallel.pipeline.PipelinedRunner`,
``SPARKDL_PIPELINE=0`` for the serial path), bit-identically.
``batches_per_dispatch`` = k stacks k pieces into one dispatch (one replay
of k forwards, one fetch).

Failure domain: ``dispatch_retries`` with jittered, capped backoff, a
consecutive-failure :class:`DispatchCircuitBreaker` (its transitions are
the ``breaker.open`` / ``breaker.half_open`` / ``breaker.close`` flight
events), and the fault sites ``engine.dispatch`` (enqueue) and
``engine.gather`` (force).

Tracing (``SPARKDL_TRACE``, :mod:`sparkdl_tpu_torch.obs.trace`), as in the
JAX engine: an ``engine.call`` span around each call and an
``engine.dispatch`` span around each dispatch attempt, which covers the
upload and the replay's launch only.  Device time comes from CUDA events:
while tracing is on, a pair of timing events brackets each replay (or
eager forward) on the compute stream, outside any capture, and their
elapsed time is read after the fetch's own wait on the output copy, so no
synchronization is added; it is added up as ``device_ms`` on the span that
forces the result (``engine.call`` on the serial path, ``pipeline.gather``
in the pipelined runner).  While tracing is off no timing event is made.

:func:`get_cached_engine` keeps one engine per ``ModelFunction`` on the
stage (or other holder) that runs it; the engine and its graphs go with
the holder.

Graph memory: every capture of one engine allocates from ONE memory pool
(``torch.cuda.graph_pool_handle()``, passed as ``pool=``), not a private
pool per capture.  Sharing is safe because the engine never runs two of
its graphs at once and reads nothing a graph wrote after another graph
ran: every replay waits on the event recorded after the previous replay
and its output copy (so replays are serialized whatever stream a caller
is on), each replay's output is cloned out of the pool before that event,
and the static inputs live outside the pool.  A graph may then reuse
another's intermediates, so the pool holds about one forward's memory,
not one per bucket.  ``graph_pool_bytes`` is what the pool reserved;
:meth:`InferenceEngine.release_graphs` drops the graphs (after the card
has finished with them) and returns the pool, and
:func:`graph_pool_bytes_held` sums the pools of every live engine.

Siblings: :meth:`InferenceEngine.sibling` makes an engine for another
batch size (the serving layer's buckets) over the same device module, fold
caches, graph pool, lock, staging slots and streams; only the batch size
and the circuit breaker are its own.  The pool stays safe to share for the
reason above: every graph of every sibling replays under the one lock and
after the one event, so no two replays overlap.

The head half (the JAX engine's ``dense_head_row``,
``build_head_fanout_jit`` and :class:`HeadBank`): per-tenant dense heads
stacked into one device bank and served by one fan-out callable, whose
dense head pass is kernel H1 (:mod:`sparkdl_tpu_torch.ops.head`), so that a
tenant's row from a mixed-tenant batch is its row through its head alone,
bit for bit, in every bank mode.

The mesh (JAX's ``resolve_engine_mesh``, ``effective_device_batch``,
``partition_rules`` / ``param_shardings``, ``sharding_info``): scoring is
per process, on this rank's one device, so an engine's mesh is (1, 1)
(:func:`resolve_engine_mesh`); a mesh of more devices raises
``NotImplementedError`` (ROADMAP.md §C), so no weight policy splits a
weight: the port holds every weight whole on one card.  A policy that
resolves all-replicated collapses, as JAX's does (``sharding_digest``
``"replicated"``).  ``donate_batch=True`` is accepted and recorded (in
``sharding_info()`` and the graph key): it changes nothing on the card,
where the captured graph already owns its static input and every upload
lands in the engine's own staging slot.

Not ported yet: the compile-cache policy (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import copy
import os
import threading
import time as time_lib
import weakref
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn as nn

from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.obs.trace import get_tracer
from sparkdl_tpu_torch.parallel import distributed
from sparkdl_tpu_torch.parallel import mesh as mesh_lib
from sparkdl_tpu_torch.parallel.pipeline import (PipelinedRunner,
                                                 pipeline_enabled_from_env)
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics
from sparkdl_tpu_torch.utils.retry import NON_RETRYABLE, with_retries

logger = get_logger(__name__)


class CircuitOpenError(RuntimeError):
    """The dispatch circuit breaker is OPEN: ``breaker_threshold``
    consecutive device errors tripped it, and dispatches fail fast (with
    the last device error's text).  ``retry_after_s`` is the cool-down left
    before a half-open trial dispatch is admitted."""

    def __init__(self, message: str, retry_after_s: float = 0.0,
                 last_error: Optional[str] = None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.last_error = last_error


class DispatchCircuitBreaker:
    """Consecutive-failure circuit breaker for device dispatch (a copy of
    the JAX package's, with its flight events, emitted outside the lock).

    closed --(threshold consecutive failures)--> open
    open   --(cooldown elapses)-->                half_open (ONE trial)
    half_open --success--> closed; --failure--> open (fresh cooldown)

    Deterministic errors (``utils.retry.NON_RETRYABLE``) never count.
    ``threshold <= 0`` disables the breaker."""

    def __init__(self, threshold: int = 8, cooldown_s: float = 30.0):
        self.threshold = int(threshold)
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._lock = threading.Lock()
        self._consecutive = 0
        self._open_until = 0.0
        self._open = False
        self._trial_inflight = False
        self._last_error: Optional[str] = None
        self._opened_count = 0

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def gate(self) -> None:
        """Fail fast with :class:`CircuitOpenError` while open; admit a
        single trial dispatch once the cool-down elapsed (half-open, a
        ``breaker.half_open`` event)."""
        if self.threshold <= 0:
            return
        trial = False
        with self._lock:
            if self._open:
                remaining = self._open_until - time_lib.monotonic()
                if remaining > 0 or self._trial_inflight:
                    raise CircuitOpenError(
                        f"dispatch circuit breaker open "
                        f"({self._consecutive} consecutive device errors; "
                        f"last: {self._last_error}); failing fast — retry in "
                        f"{max(0.0, remaining):.2f}s",
                        retry_after_s=max(0.0, remaining),
                        last_error=self._last_error)
                self._trial_inflight = True  # half-open: this caller probes
                trial = True
        if trial:
            flight_emit("breaker.half_open")

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            closed_now = self._open
            self._consecutive = 0
            self._open = False
            self._trial_inflight = False
        if closed_now:
            flight_emit("breaker.close")

    def release_trial(self) -> None:
        """Give back a half-open trial slot without judging the device (the
        attempt died on a deterministic caller error)."""
        if self.threshold <= 0:
            return
        with self._lock:
            self._trial_inflight = False

    def record_failure(self, exc: BaseException) -> bool:
        """Count a device error; True when this failure opened (or
        re-opened) the breaker (a ``breaker.open`` event)."""
        if self.threshold <= 0 or isinstance(exc, NON_RETRYABLE):
            return False
        with self._lock:
            self._consecutive += 1
            was_trial = self._trial_inflight
            self._trial_inflight = False
            self._last_error = f"{type(exc).__name__}: {exc}"
            opened = was_trial or (not self._open
                                   and self._consecutive >= self.threshold)
            if opened:
                self._open = True
                self._open_until = time_lib.monotonic() + self.cooldown_s
                self._opened_count += 1
            consecutive = self._consecutive
        if opened:
            flight_emit("breaker.open", consecutive=consecutive,
                        cooldown_s=self.cooldown_s,
                        error=type(exc).__name__)
        return opened

    def open_remaining_s(self) -> Optional[float]:
        """Remaining cool-down if OPEN, else None (half-open reports None
        so trial traffic is admitted)."""
        if self.threshold <= 0:
            return None
        with self._lock:
            if not self._open:
                return None
            remaining = self._open_until - time_lib.monotonic()
            if remaining <= 0 and not self._trial_inflight:
                return None
            return max(0.0, remaining)

    def state(self) -> Dict[str, Any]:
        """JSON-serializable breaker snapshot."""
        with self._lock:
            now = time_lib.monotonic()
            if not self._open:
                st = "closed"
            elif now < self._open_until or self._trial_inflight:
                st = "open"
            else:
                st = "half_open"
            return {
                "state": st,
                "enabled": self.threshold > 0,
                "consecutive_failures": self._consecutive,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "retry_after_s": (round(max(0.0, self._open_until - now), 3)
                                  if st == "open" else 0.0),
                "opened_count": self._opened_count,
                "last_error": self._last_error,
            }


def resolve_engine_mesh(mesh=None, device: DeviceLike = None):
    """The mesh an engine runs on: this process's one device (``device``,
    default :func:`~sparkdl_tpu_torch.resolve_device`), shape (1, 1),
    when ``mesh`` is None.  Scoring is per process, as JAX's is per
    controller: a mesh holding another rank's device raises, as JAX's
    does, and so does a mesh of more than one device of this process (one
    card per process, ROADMAP.md §C) and a ``device`` that is not the
    mesh's."""
    if mesh is None:
        return mesh_lib.get_mesh(devices=[resolve_device(device)])
    if device is not None and torch.device(device) != mesh.devices.flat[0]:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.devices.flat[0]}")
    me = distributed.process_index()
    if any(int(r) != me for r in np.asarray(mesh.ranks).flat):
        raise NotImplementedError(
            "InferenceEngine is single-controller: pass a mesh over this "
            "process's device (mesh.get_mesh(devices=[resolve_device()])) "
            "and shard input rows per rank; multi-process collectives "
            "belong to the TRAIN path (parallel.train / "
            "parallel.distributed).")
    if mesh.size > 1:
        raise NotImplementedError(
            f"an engine mesh of {mesh.size} devices in one process "
            f"({mesh.shape}): the port runs one card per process "
            f"(ROADMAP.md §C, documented deviations)")
    return mesh


def effective_device_batch(device_batch_size: int, mesh=None) -> int:
    """The device batch an engine runs: rounded UP to a multiple of the
    mesh's data-axis size (1 without a mesh), at least 1."""
    dp = 1 if mesh is None else int(mesh.shape[mesh_lib.DATA_AXIS])
    b = max(1, int(device_batch_size))
    rem = b % dp
    return b + (dp - rem) if rem else b


def batches_per_dispatch_from_env() -> int:
    """``SPARKDL_BATCHES_PER_DISPATCH`` (clamped to >= 1), read as the JAX
    package reads it."""
    raw = os.environ.get("SPARKDL_BATCHES_PER_DISPATCH", "") or "1"
    return max(1, int(raw))


def _cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer to ``dtype`` (integer
    buffers such as BatchNorm's ``num_batches_tracked`` stay)."""
    return module.to(dtype=dtype)


# -- pytrees: dicts (leaves in sorted key order, as JAX flattens them),
# lists, tuples and namedtuples; None is an empty subtree -------------------
def _tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    return [tree]


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``) in :func:`_tree_leaves`' order, keeping the
    structure (dicts come back with sorted keys, as JAX rebuilds them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):  # namedtuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def _version(t: torch.Tensor) -> Optional[int]:
    """``t``'s version counter (None for an inference tensor, which keeps
    none)."""
    try:
        return t._version
    except RuntimeError:
        return None


def precision_flags() -> tuple:
    """The flags cuDNN and cuBLAS read when a forward is captured: a graph
    captured under other values would replay the other arithmetic."""
    cuda_mm = torch.backends.cuda.matmul
    return (torch.backends.cudnn.allow_tf32, cuda_mm.allow_tf32,
            torch.get_float32_matmul_precision(),
            cuda_mm.allow_bf16_reduced_precision_reduction,
            cuda_mm.allow_fp16_reduced_precision_reduction)


def fold_entries(owners) -> list:
    """Every entry of the fold caches (``_folds``, filled by
    ``models.layers.cached_fold``) of the modules ``owners``, in order."""
    return [e for m in owners for e in m._folds.values()]


def graph_key(state: List[torch.Tensor], fold_owners=()) -> tuple:
    """What a captured forward depends on beyond its input: the
    ``(data_ptr, _version)`` of every parameter and buffer in ``state``
    (an in-place edit, ``load_state_dict`` or ``.to()`` changes one, as
    ``models.layers.cached_fold`` keys its folds), the identity of every
    fold cache entry of ``fold_owners`` (clearing a cache after a write
    through ``.data``, which moves no version counter, changes it; a graph
    holds the entries it was captured with, so no id is reused while it
    lives) and :func:`precision_flags`."""
    try:
        weights = tuple((t.data_ptr(), t._version) for t in state)
    except RuntimeError:  # an inference tensor keeps no version counter
        weights = tuple((t.data_ptr(), _version(t)) for t in state)
    folds = tuple(map(id, fold_entries(fold_owners)))
    return weights, folds, precision_flags()


# one capture at a time in the process: a capture's pool bytes are the
# growth of the card's reserved memory across it (its launch counts are the
# capturing thread's own, ``ops.sepconv.thread_launch_counts``)
_CAPTURE_LOCK = threading.Lock()

# every engine alive in the process, for graph_pool_bytes_held
_LIVE_ENGINES: "weakref.WeakSet[InferenceEngine]" = weakref.WeakSet()

# the timing events around the last forward each thread dispatched while
# tracing was on, until the caller that forces its result takes them
_TIMING = threading.local()


def _timing_event(stream) -> Optional[torch.cuda.Event]:
    """A timing event recorded on ``stream`` (the current one), or None
    while it is capturing: an event recorded there would become a node of
    the graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _end_timing(start: Optional[torch.cuda.Event], stream) -> None:
    """Close the bracket ``start`` opened on ``stream`` and keep the pair
    for this thread's caller (:meth:`InferenceEngine._take_timing`)."""
    if start is not None:
        end = _timing_event(stream)
        if end is not None:
            _TIMING.events = (start, end)


def graph_pool_bytes_held() -> int:
    """The CUDA-graph pool bytes that every live engine in the process
    holds (``InferenceEngine.graph_pool_bytes`` summed, siblings' shared
    pool once)."""
    cores = {id(e._core): e._core for e in list(_LIVE_ENGINES)}
    return sum(c.pool_bytes for c in cores.values())


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _GraphCore:
    """What an engine shares with its siblings (:meth:`InferenceEngine.
    sibling`): the lock that serialises uploads and dispatches, the
    captured graphs, the device staging slots, the graphs' one memory pool
    and the bytes it reserved, the event after the last replay's output
    copy, and (CUDA) the upload, fetch and capture streams."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.graphs: Dict[tuple, "_Graph"] = {}
        self.slots: Dict[tuple, "_DeviceSlots"] = {}
        self.pool = None
        self.pool_bytes = 0
        self.replayed: Optional[torch.cuda.Event] = None
        if device.type == "cuda":
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
            self.capture_stream = torch.cuda.Stream(device)


class _DeviceSlots:
    """Two device staging buffers of one shape and dtype: upload k+1 goes
    into the other slot while the compute stream still reads slot k.
    ``free[i]`` is the compute-stream event after slot i's last read."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.bufs = [torch.empty(shape, dtype=dtype, device=device)
                     for _ in range(2)]
        self.free: List[Optional[torch.cuda.Event]] = [None, None]
        self.next = 0


class _Graph:
    """One captured forward: its key, the fold cache entries it reads
    (held, so that clearing a cache frees nothing the graph reads), static
    input and output, the kernel launches its capture recorded, and its
    memory pool's size."""

    def __init__(self, key, folds, graph, static_in, static_out, launches,
                 pool_bytes):
        self.key = key
        self.folds = folds
        self.graph = graph
        self.static_in = static_in
        self.in_leaves = _tree_leaves(static_in)
        self.static_out = static_out
        self.launches = launches
        self.pool_bytes = pool_bytes


class InferenceEngine:
    """``fn(module, x)`` over host batches on ``device``.

    ``module`` is copied to the device once (the caller's module is left
    where it is), cast to ``compute_dtype`` when given, and put in eval
    mode.  ``output_host_dtype``: outputs are fetched in the dtype the
    device produced and widened on the host (bit-identical, half the
    device-to-host bytes of widening on the device); float leaves only,
    integer leaves are never cast.  A bf16 output, which numpy cannot hold,
    is widened to float32 on the host in any case (the JAX engine returns
    bf16 host arrays).

    ``batches_per_dispatch``, ``dispatch_retries``, the backoff arguments,
    ``breaker_threshold``, ``breaker_cooldown_s`` and ``on_dispatch_error``
    mean what they mean in the JAX engine, with its defaults.  ``capture``
    (CUDA only): run the forward as a captured CUDA graph (default) or
    eagerly.

    A captured graph is keyed (:func:`graph_key`) on the parameter and
    buffer tensors the module had at construction and on its fold caches:
    replacing a parameter object (``setattr`` of a new ``nn.Parameter``) is
    not seen; edit in place or load a ``state_dict`` instead, and after a
    write through ``.data`` clear the model's ``_folds``.  Concurrent calls
    and runs on one engine are safe: each stages its pieces in its own
    pinned buffers, and a lock serialises the uploads and dispatches on
    CUDA.

    Streams: uploads go on the engine's copy stream, fetches on a second,
    captures on a third (all from PyTorch's stream pool).  A capture runs
    in ``thread_local`` mode, so the runner's other threads (pinned copies,
    fetches, event waits) do not invalidate it, and only one engine in the
    process captures at a time; nothing but the capture enqueues on its
    stream.  The kernels' launch counts a capture takes back are the
    capturing thread's own, whatever other engines launch or replay on
    other threads meanwhile."""

    def __init__(self, fn: Callable[[nn.Module, Any], Any],
                 module: nn.Module, *, device: DeviceLike = None,
                 device_batch_size: int = 64,
                 compute_dtype: Optional[torch.dtype] = None,
                 output_host_dtype: Optional[Any] = None,
                 batches_per_dispatch: int = 1,
                 dispatch_retries: int = 0,
                 dispatch_backoff_s: float = 0.05,
                 dispatch_max_backoff_s: float = 2.0,
                 dispatch_jitter: float = 0.25,
                 breaker_threshold: int = 8,
                 breaker_cooldown_s: float = 30.0,
                 on_dispatch_error: Optional[
                     Callable[[BaseException], None]] = None,
                 capture: bool = True,
                 mesh=None,
                 partition_rules: Any = None,
                 param_shardings: Any = None,
                 donate_batch: bool = False,
                 metrics: Optional[Metrics] = None):
        self.mesh = resolve_engine_mesh(mesh, device)
        self.device = resolve_device(self.mesh.devices.flat[0])
        self.data_parallel = int(self.mesh.shape[mesh_lib.DATA_AXIS])
        self.model_parallel = int(self.mesh.shape[mesh_lib.MODEL_AXIS])
        self.donate_batch = bool(donate_batch)
        self.fn = fn
        self.device_batch_size = effective_device_batch(device_batch_size,
                                                        self.mesh)
        self.compute_dtype = compute_dtype
        self.output_host_dtype = (np.dtype(output_host_dtype)
                                  if output_host_dtype is not None else None)
        self.metrics = metrics if metrics is not None else Metrics()
        self.batches_per_dispatch = max(1, int(batches_per_dispatch))
        self.dispatch_retries = max(0, int(dispatch_retries))
        self.dispatch_backoff_s = max(0.0, float(dispatch_backoff_s))
        self.dispatch_max_backoff_s = float(dispatch_max_backoff_s)
        self.dispatch_jitter = float(dispatch_jitter)
        self.breaker = DispatchCircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s)
        self._on_dispatch_error = on_dispatch_error
        module = copy.deepcopy(module)
        if compute_dtype is not None:
            module = _cast_floating(module, compute_dtype)
        cuda = self.device.type == "cuda"
        if cuda:
            module = module.to(memory_format=torch.channels_last)
        self.module = module.to(self.device).eval()
        self.name = type(self.module).__name__
        self.capture = bool(capture) and cuda
        self._state = [*self.module.parameters(), *self.module.buffers()]
        self._fold_owners = [m for m in self.module.modules()
                             if isinstance(getattr(m, "_folds", None), dict)]
        self._resolve_policy(partition_rules, param_shardings)
        # graphs, staging slots, lock, the graphs' one memory pool (made at
        # the first capture), the bytes it reserved, the event after the
        # last replay's output copy (see the module docstring) and the
        # streams: shared with every sibling
        self._core = _GraphCore(self.device)
        self._init_own()
        _LIVE_ENGINES.add(self)

    def _resolve_policy(self, partition_rules, param_shardings) -> None:
        """The weight-sharding policy over the device module, as JAX's
        engine resolves it: explicit ``param_shardings`` win over
        ``partition_rules``, and an all-replicated resolution collapses to
        no policy."""
        specs = None
        if param_shardings is not None:
            _, specs = mesh_lib.resolve_param_shardings(
                self.module, self.mesh, specs=param_shardings)
        elif partition_rules is not None:
            _, specs = mesh_lib.resolve_param_shardings(
                self.module, self.mesh, partition_rules)
        if specs is not None and mesh_lib.specs_all_replicated(specs):
            specs = None
        # the mesh is one device (resolve_engine_mesh): no spec can split
        self._param_specs = specs
        self.sharding_digest = mesh_lib.partition_digest(specs)
        self._sharding_stats = mesh_lib.param_sharding_stats(
            self.mesh, self.module, specs)
        self.metrics.gauge("engine.mesh_data_axis", float(self.data_parallel))
        self.metrics.gauge("engine.mesh_model_axis",
                           float(self.model_parallel))
        self.metrics.gauge("engine.replicated_param_bytes",
                           float(self._sharding_stats["param_bytes_total"]))
        self.metrics.gauge("engine.param_bytes_per_chip",
                           float(self._sharding_stats["param_bytes_per_chip"]))

    def sharding_info(self) -> Dict[str, Any]:
        """JSON snapshot of the engine's weight layout, as JAX's: mesh
        shape, total vs per-device param bytes, sharded leaf count, the
        policy digest, ``sharded`` (a policy that did not collapse) and
        ``donate_batch``."""
        return dict(self._sharding_stats,
                    sharding_digest=self.sharding_digest,
                    sharded=self._param_specs is not None,
                    donate_batch=self.donate_batch)

    def _graph_key(self) -> tuple:
        return graph_key(self._state, self._fold_owners) + (
            self.donate_batch,)

    def _init_own(self) -> None:
        """What an engine does not share with its siblings besides its
        batch size and breaker: the signature of the last graph it
        captured and its count of captures (``executable_state``)."""
        self._graph_sig = None
        self.captures = 0

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def param_bytes(self) -> int:
        """The bytes of the device module's parameters and buffers on the
        engine's device (one copy, shared with the siblings): the cost
        ledger's per-bucket HBM bytes."""
        return sum(t.numel() * t.element_size() for t in self._state)

    # what a sibling takes from its engine; its batch size and breaker are
    # its own
    _SIBLING_SHARES = ("device", "mesh", "data_parallel", "model_parallel",
                       "donate_batch", "_param_specs", "sharding_digest",
                       "_sharding_stats", "fn", "compute_dtype",
                       "output_host_dtype",
                       "metrics", "batches_per_dispatch", "dispatch_retries",
                       "dispatch_backoff_s", "dispatch_max_backoff_s",
                       "dispatch_jitter", "_on_dispatch_error", "module",
                       "name", "capture", "_state", "_fold_owners", "_core")

    def sibling(self, device_batch_size: int) -> "InferenceEngine":
        """An engine for ``device_batch_size`` rows over this engine's
        device module: it shares the module (one device copy of the
        weights), its fold caches, the graph pool, the lock, the staging
        slots, the streams, the metrics and every setting; it captures its
        own graph for its batch size into the shared pool, and has its own
        circuit breaker."""
        sib = object.__new__(type(self))
        for attr in self._SIBLING_SHARES:
            setattr(sib, attr, getattr(self, attr))
        sib.device_batch_size = effective_device_batch(device_batch_size,
                                                       self.mesh)
        sib.breaker = DispatchCircuitBreaker(
            threshold=self.breaker.threshold,
            cooldown_s=self.breaker.cooldown_s)
        sib._init_own()
        _LIVE_ENGINES.add(sib)
        return sib

    # -- pytrees -----------------------------------------------------------
    @staticmethod
    def _leaves(batch) -> int:
        leaves = _tree_leaves(batch)
        if not leaves:
            raise ValueError("Batch pytree has no array leaves")
        n = leaves[0].shape[0]
        if any(leaf.shape[0] != n for leaf in leaves):
            raise ValueError("All batch leaves must share the leading "
                             "(batch) axis length")
        return n

    @staticmethod
    def _slice(batch, off: int, size: int):
        return _tree_map(lambda a: a[off:off + size], batch)

    # -- failure domain ----------------------------------------------------
    def _attempt_dispatch(self, thunk):
        """ONE gated dispatch attempt: breaker gate -> fault site -> upload
        + launch.  Success is recorded at force time (``_force_parts``):
        a CUDA launch is asynchronous, and a dying device raises there."""
        self.breaker.gate()
        try:
            inject("engine.dispatch")
            return thunk()
        except NON_RETRYABLE:
            # a caller error proves nothing about the device, but a
            # half-open trial slot must be handed back
            self.breaker.release_trial()
            raise
        except BaseException as e:  # noqa: BLE001 — device/runtime error
            self._charge_breaker(e, "engine.dispatch_errors")
            raise

    def _charge_breaker(self, e: BaseException, counter: str) -> None:
        """Failure bookkeeping shared by the enqueue and the force."""
        self.metrics.incr(counter)
        if self.breaker.record_failure(e):
            self.metrics.incr("engine.breaker_opened")
            logger.warning(
                "dispatch circuit breaker OPENED after %d consecutive "
                "device errors (last: %s: %s); failing fast for %.1fs",
                self.breaker.state()["consecutive_failures"],
                type(e).__name__, e, self.breaker.cooldown_s)
        if self._on_dispatch_error is not None:
            self._on_dispatch_error(e)

    def _run_dispatch(self, thunk):
        """Dispatch with the transient-fault retry budget; deterministic
        failures and a breaker that opened mid-budget fail at once."""
        if self.dispatch_retries <= 0:
            return self._attempt_dispatch(thunk)

        def on_retry(attempt, exc):
            self.metrics.incr("engine.dispatch_retries")

        return with_retries(
            lambda: self._attempt_dispatch(thunk),
            max_retries=self.dispatch_retries,
            non_retryable=NON_RETRYABLE + (CircuitOpenError,),
            backoff_seconds=self.dispatch_backoff_s,
            max_backoff_seconds=self.dispatch_max_backoff_s,
            jitter=self.dispatch_jitter,
            on_retry=on_retry)

    def breaker_state(self) -> Dict[str, Any]:
        """The dispatch circuit breaker's JSON-serializable snapshot."""
        return self.breaker.state()

    # -- dispatch ----------------------------------------------------------
    def run_padded(self, batch):
        """Run one already-padded device batch (array or pytree of arrays
        sharing the leading batch axis; numpy, or a pinned tensor from
        :meth:`_pad`); returns the device output, ordered on the caller's
        current stream, not synchronised."""
        n = self._leaves(batch)
        if n != self.device_batch_size:
            raise ValueError(f"run_padded expects batch of "
                             f"{self.device_batch_size}, got {n}")

        # the span covers the upload and the replay's launch only; the
        # device time lands in the span that forces the result
        def attempt():
            with get_tracer().span("engine.dispatch",
                                   rows=self.device_batch_size):
                return self._forward(batch, False)

        return self._run_dispatch(attempt)

    def _dispatch_group(self, stacked):
        """One dispatch of ``batches_per_dispatch`` stacked pieces: one
        replay of k forwards on CUDA; returns the stacked device output."""
        def attempt():
            with get_tracer().span("engine.dispatch",
                                   group=self.batches_per_dispatch):
                return self._forward(stacked, True)

        return self._run_dispatch(attempt)

    @staticmethod
    def _take_timing():
        """The (start, end) timing events around this thread's last forward
        (None while tracing was off, on the CPU, or when taken already):
        handed to whoever forces its result (:meth:`_force_parts`)."""
        events = getattr(_TIMING, "events", None)
        _TIMING.events = None
        return events

    def _eager(self, x, group: bool):
        """The forward, op by op (a group: one forward per piece, stacked,
        as the JAX engine's ``lax.map``)."""
        if not group:
            return self.fn(self.module, x)
        outs = [self.fn(self.module, _tree_map(lambda a, i=i: a[i], x))
                for i in range(self._leaves(x))]
        return _tree_map(lambda *parts: torch.stack(parts), *outs)

    def _forward(self, host, group: bool):
        _TIMING.events = None
        if self.device.type != "cuda":
            x = _tree_map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(self.device), host)
            with torch.inference_mode():
                return self._eager(x, group)
        timed = get_tracer().enabled
        with self._core.lock:
            t0 = time_lib.perf_counter()
            x, slots = self._upload(host)
            cur = torch.cuda.current_stream(self.device)
            with torch.inference_mode():
                if self.capture:
                    out = self._replay(x, group, timed)
                else:
                    start = _timing_event(cur) if timed else None
                    out = self._eager(x, group)
                    _end_timing(start, cur)
            for s, i in slots:  # the forward has read slot i
                s.free[i] = torch.cuda.Event()
                s.free[i].record(cur)
            self.metrics.record_time("engine.replay_host" if self.capture
                                     else "engine.eager_host",
                                     time_lib.perf_counter() - t0)
        return out

    # -- host staging and upload (CUDA) ---------------------------------------
    def _stage(self, parts: list, shape) -> torch.Tensor:
        """The host arrays ``parts`` (each [n<=B, ...]) zero-padded to B
        rows into a new pinned buffer of ``shape`` ([B, ...], or [k, B, ...]
        for a group).  The caching host allocator reuses its block only
        after the event of the non-blocking copy that uploads it."""
        a0 = np.asarray(parts[0])
        buf = torch.empty(shape, dtype=_torch_dtype(a0.dtype),
                          pin_memory=True)
        view = buf.numpy().reshape((len(parts),) + tuple(shape[-a0.ndim:]))
        for dst, src in zip(view, parts):
            n = len(src)
            dst[:n] = src
            dst[n:] = 0
        return buf

    def _upload(self, host):
        """H2D of one host batch tree on the copy stream into device
        staging slots; the current stream waits on its event.  Returns the
        device tree and the (slots, index) the forward reads."""
        pinned = [a if isinstance(a, torch.Tensor)  # a piece _pad staged
                  else torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                  for a in _tree_leaves(host)]
        devs, slots = [], []
        for p in pinned:
            key = (tuple(p.shape), p.dtype)
            if key not in self._core.slots:
                self._core.slots[key] = _DeviceSlots(p.shape, p.dtype, self.device)
        with torch.cuda.stream(self._core.h2d):
            for p in pinned:
                s = self._core.slots[(tuple(p.shape), p.dtype)]
                i = s.next
                s.next ^= 1
                if s.free[i] is not None:
                    self._core.h2d.wait_event(s.free[i])
                s.bufs[i].copy_(p, non_blocking=True)
                devs.append(s.bufs[i])
                slots.append((s, i))
            ev = torch.cuda.Event()
            ev.record(self._core.h2d)
        torch.cuda.current_stream(self.device).wait_event(ev)
        it = iter(devs)
        return _tree_map(lambda _: next(it), host), slots

    # -- the captured forward (CUDA) -------------------------------------------
    def _replay(self, x, group: bool, timed: bool = False):
        """Copy ``x`` into the bucket's graph's static input, replay, and
        copy the output out (the next replay overwrites the static one).
        Captures first when the bucket has no graph or its key moved.
        ``timed``: bracket the replay with timing events (tracing on)."""
        from sparkdl_tpu_torch.ops import sepconv as ops

        leaves = _tree_leaves(x)
        cur = torch.cuda.current_stream(self.device)
        if self._core.replayed is not None:  # one replay at a time: one pool
            cur.wait_event(self._core.replayed)
        sig = (group,) + tuple((tuple(a.shape), a.dtype) for a in leaves)
        g = self._core.graphs.get(sig)
        if g is None or g.key != self._graph_key():
            g = self._capture(x, group, sig)
        for dst, src in zip(g.in_leaves, leaves):
            dst.copy_(src)
        start = _timing_event(cur) if timed else None
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA-graph replay of engine {self.name} "
                               f"bucket {sig} failed: {e}") from e
        _end_timing(start, cur)
        if any(g.launches):
            ops.credit_launches(g.launches)
        out = _tree_map(lambda t: t.clone(), g.static_out)
        self._core.replayed = torch.cuda.Event()
        self._core.replayed.record(cur)
        return out

    def _capture(self, x, group: bool, sig) -> _Graph:
        with _CAPTURE_LOCK:
            return self._capture_locked(x, group, sig)

    def _capture_locked(self, x, group: bool, sig) -> _Graph:
        from sparkdl_tpu_torch.ops import sepconv as ops

        cur = torch.cuda.current_stream(self.device)
        old = self._core.graphs.pop(sig, None)
        if old is not None:
            cur.synchronize()  # its last replay is done before its pool goes
            del old
        static_in = _tree_map(torch.empty_like, x)
        for dst, src in zip(_tree_leaves(static_in), _tree_leaves(x)):
            dst.copy_(src)
        side = self._core.capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # warm-up, eagerly: fold caches, kernel libraries' one-time
            # attributes and cuDNN's plans are made here, outside the graph
            self._eager(static_in, group)
        cur.wait_stream(side)
        # the fold caches are full now; the capture only reads them
        key = self._graph_key()
        folds = fold_entries(self._fold_owners)
        before = ops.thread_launch_counts()
        # torch.cuda.graph empties the allocator's cache on entry: do it
        # here first, so that the growth of reserved memory is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_stats(self.device).get(
            "reserved_bytes.all.current", 0)
        if self._core.pool is None:
            self._core.pool = torch.cuda.graph_pool_handle()
        # keep_graph: the captured cudaGraph_t stays readable
        # (``raw_cuda_graph``), so its kernel nodes can be counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            # thread_local: the runner's other threads (pinned copies, D2H
            # fetches, event waits) do not invalidate this capture; the
            # capture stream is the engine's own; every capture of the
            # engine allocates from its one pool
            with torch.cuda.graph(graph, pool=self._core.pool, stream=side,
                                  capture_error_mode="thread_local"):
                static_out = self._eager(static_in, group)
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"CUDA-graph capture of engine {self.name} "
                               f"bucket {sig} failed: {e}") from e
        finally:
            # the captured launches did not run; each replay credits them.
            # This thread's own: another engine replaying or capturing on
            # another thread meanwhile credits the process-wide counts only
            launches = tuple(a - b for a, b in zip(
                ops.thread_launch_counts(), before))
            ops.credit_launches(tuple(-n for n in launches))
        pool = torch.cuda.memory_stats(self.device).get(
            "reserved_bytes.all.current", 0) - reserved
        g = _Graph(key, folds, graph, static_in, static_out, launches,
                   max(0, pool))
        self._core.graphs[sig] = g
        self._graph_sig = sig
        self.captures += 1
        # the shared pool keeps what it reserved until every graph is gone
        self._core.pool_bytes += g.pool_bytes
        self.metrics.incr("engine.graph_captures")
        self.metrics.gauge("engine.graph_pool_bytes", self._core.pool_bytes)
        return g

    def graphs(self) -> List[Dict[str, Any]]:
        """One entry per captured graph: bucket, kernel launches per
        replay (B1, B3, B2) and the pool bytes its capture added."""
        return [dict(bucket=sig, launches=g.launches,
                     pool_bytes=g.pool_bytes)
                for sig, g in self._core.graphs.items()]

    def bucket_graph(self) -> Optional[_Graph]:
        """The graph this engine captured last, while the engine holds it
        (None before its first capture and after :meth:`release_graphs`):
        a bucket's compiled-program identity, as the JAX server reads its
        bucket's jit object."""
        return self._core.graphs.get(self._graph_sig)

    @property
    def graph_pool_bytes(self) -> int:
        """The bytes the engine's graph pool holds on the card (0 before
        the first capture and after :meth:`release_graphs`); siblings
        report their one shared pool."""
        return self._core.pool_bytes

    def release_graphs(self) -> None:
        """Drop every captured graph (the siblings' too) and give the
        pool's memory back to the card, once the card has finished what was
        enqueued on it (a later dispatch captures again).  Waits for a
        dispatch in flight on another thread."""
        with self._core.lock:
            if not self._core.graphs:
                return
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(self.device)
            self._core.graphs.clear()
            self._core.pool = None
            self._core.pool_bytes = 0
            self._core.replayed = None
            self.metrics.gauge("engine.graph_pool_bytes", 0)
        if cuda:
            torch.cuda.empty_cache()

    # -- host prepare and gather -----------------------------------------------
    def _count_rows(self, n: int) -> None:
        # pad-to-bucket ledger: real vs padded rows per dispatched piece
        self.metrics.incr("engine.rows", n)
        if n != self.device_batch_size:
            self.metrics.incr("engine.pad_rows", self.device_batch_size - n)

    def _pad(self, chunk):
        """One piece padded to the bucket: numpy on the CPU, a new pinned
        host buffer on CUDA."""
        n = self._leaves(chunk)
        self._count_rows(n)
        b = self.device_batch_size
        if self.device.type == "cuda":
            return _tree_map(lambda a: self._stage(
                [a], (b,) + tuple(np.shape(a)[1:])), chunk)
        if n == b:
            return chunk

        def pad_leaf(a):
            return np.pad(a, [(0, b - n)] + [(0, 0)] * (a.ndim - 1))

        return _tree_map(pad_leaf, chunk)

    def _stack_group(self, pieces):
        """Host half of a grouped dispatch: each piece padded and stacked
        on a leading group axis; returns (true row counts, stacked)."""
        ns = tuple(self._leaves(p) for p in pieces)
        if self.device.type != "cuda":
            return ns, _tree_map(lambda *parts: np.stack(parts, axis=0),
                                 *[self._pad(p) for p in pieces])
        for n in ns:
            self._count_rows(n)
        shape = (len(pieces), self.device_batch_size)
        return ns, _tree_map(lambda *parts: self._stage(
            list(parts), shape + tuple(np.shape(parts[0])[1:])), *pieces)

    def _ready_event(self):
        """An event on the current stream after everything enqueued so far
        (None on the CPU): what a gather on another thread waits on."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _fetch(self, out, ready=None):
        """The device output tree as host tensors: on CUDA the copy stream
        waits on ``ready`` (default: now, on the current stream), copies
        into pinned memory, and the host waits for it."""
        if self.device.type != "cuda":
            return out
        if ready is None:
            ready = self._ready_event()
        with torch.cuda.stream(self._core.d2h):
            self._core.d2h.wait_event(ready)
            host = _tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True), out)
            done = torch.cuda.Event()
            done.record(self._core.d2h)
        done.synchronize()
        return host

    def _trim(self, out, n: int):
        """The first ``n`` rows of each host output leaf as numpy: bf16
        widened to f32, float leaves cast to ``output_host_dtype``; integer
        leaves are never cast."""
        def gather(t):
            h = t[:n]
            widened = h.dtype == torch.bfloat16
            if widened:
                h = h.to(torch.float32)  # exact; numpy has no bf16
            host = h.numpy() if widened else h.numpy().copy()
            if (self.output_host_dtype is not None
                    and host.dtype != self.output_host_dtype
                    and np.issubdtype(host.dtype, np.floating)
                    and np.issubdtype(self.output_host_dtype, np.floating)):
                host = host.astype(self.output_host_dtype)
            return host

        return _tree_map(gather, out)

    def _force_parts(self, ns, out, ready=None, block=None, timing=None):
        """Force one in-flight dispatch to host row batch(es): the fetch +
        trim shared by the serial drain and the pipelined gather (``ns``
        int = a plain piece; tuple = a group, fetched once and sliced on
        the host).  The other failure surface of an asynchronous dispatch:
        errors charge the breaker, and a successful force is what records
        breaker success.

        ``block`` (the gather span's ``block_until_ready``) waits for
        ``ready`` first, inside the caller's span.  ``timing`` (the
        dispatch's :meth:`_take_timing`) is read once the fetch has waited
        for the output copy, which the bracketed forward precedes, and
        added to the caller's current span as ``device_ms``."""
        try:
            inject("engine.gather")
            if block is not None:
                block(ready if ready is not None else out)
            host = self._fetch(out, ready)
            if isinstance(ns, int):
                parts = [self._trim(host, ns)]
            else:
                parts = [self._trim(_tree_map(lambda a, i=i: a[i], host), n)
                         for i, n in enumerate(ns)]
        except NON_RETRYABLE:
            self.breaker.release_trial()
            raise
        except BaseException as e:  # noqa: BLE001 — device/runtime error
            self._charge_breaker(e, "engine.gather_errors")
            raise
        self.breaker.record_success()
        if timing is not None:
            span = get_tracer().current()
            if span is not None:
                start, end = timing
                span.annotate(device_ms=span.attrs.get("device_ms", 0.0)
                              + start.elapsed_time(end))
        return parts

    # -- whole-array API ---------------------------------------------------
    def __call__(self, batch, window: int = 2,
                 pipeline: Optional[bool] = None, on_metered=None):
        """Process a full batch (array or pytree); returns the host output
        with the same row count.

        ``on_metered(seconds)`` is called once per call with the metered
        wall time (the ``engine_call`` timing).  The pipelined path
        (``pipeline=True``, the ``SPARKDL_PIPELINE`` default) preallocates
        the output after the first gathered piece and copies every piece
        into it; inputs that fit one device batch skip the worker threads.
        Pipelined outputs are bit-identical to serial ones."""
        batch = _tree_map(np.asarray, batch)
        n = self._leaves(batch)
        if n == 0:
            raise ValueError("Empty input batch")
        use_pipe = (pipeline_enabled_from_env() if pipeline is None
                    else bool(pipeline))
        t0 = time_lib.perf_counter()
        with get_tracer().span("engine.call", rows=n):
            if not use_pipe or n <= self.device_batch_size:
                outs = list(self.map_batches([batch], window=window,
                                             pipeline=False))
                result = _tree_map(
                    lambda *parts: np.concatenate(parts, axis=0), *outs)
            else:
                result = None
                off = 0
                for part in self.map_batches([batch], window=window,
                                             pipeline=True):
                    k = self._leaves(part)
                    if result is None:
                        result = _tree_map(
                            lambda a: np.empty((n,) + a.shape[1:], a.dtype),
                            part)
                        self.metrics.incr("engine_call_prealloc")
                    for dst, src in zip(_tree_leaves(result),
                                        _tree_leaves(part)):
                        dst[off:off + k] = src
                    off += k
        elapsed = time_lib.perf_counter() - t0
        self.metrics.incr("items", n)
        self.metrics.record_time("engine_call", elapsed)
        self.metrics.incr("engine.device_time_s", elapsed)
        if on_metered is not None:
            on_metered(elapsed)
        return result

    # -- streaming API -----------------------------------------------------
    def map_batches(self, batches: Iterable[Any], window: int = 2,
                    pipeline: Optional[bool] = None) -> Iterator[Any]:
        """Map over an iterator of host batches with at most ``window``
        dispatches in flight (``max(1, window // k)`` groups under
        ``batches_per_dispatch`` = k); yields one host output per piece.
        ``pipeline`` (default ``SPARKDL_PIPELINE``, on) runs prepare,
        dispatch and gather on three threads, bit-identically."""
        use_pipe = (pipeline_enabled_from_env() if pipeline is None
                    else bool(pipeline))
        if use_pipe:
            return PipelinedRunner(self, window=window).run(batches)
        return self._map_batches_serial(batches, window)

    def _iter_pieces(self, batches: Iterable[Any]) -> Iterator[tuple]:
        """THE host-prepare sequence, shared by the serial path and the
        runner's prepare stage: slice chunks into device-batch pieces and
        pad them, stacking full ``batches_per_dispatch`` groups; yields
        ``("plain", n_rows, padded)`` / ``("group", n_rows_tuple,
        stacked)`` in dispatch order.  The ragged tail group runs its pieces
        through the plain per-batch path."""
        group: list = []
        for chunk in batches:
            chunk = _tree_map(np.asarray, chunk)
            n = self._leaves(chunk)
            for off in range(0, n, self.device_batch_size):
                piece = self._slice(chunk, off, self.device_batch_size)
                if self.batches_per_dispatch == 1:
                    yield ("plain", self._leaves(piece), self._pad(piece))
                else:
                    group.append(piece)
                    if len(group) == self.batches_per_dispatch:
                        yield ("group",) + self._stack_group(group)
                        group = []
        for piece in group:  # ragged tail: plain path, no zero batches
            yield ("plain", self._leaves(piece), self._pad(piece))

    def _map_batches_serial(self, batches: Iterable[Any],
                            window: int = 2) -> Iterator[Any]:
        """The single-threaded path: the same piece order and dispatches,
        no worker threads."""
        if self.batches_per_dispatch > 1:
            window = max(1, int(window) // self.batches_per_dispatch)
        inflight: deque = deque()

        def drain(limit):
            while len(inflight) > limit:
                ns, out, timing = inflight.popleft()
                yield from self._force_parts(ns, out, timing=timing)

        for kind, ns, host in self._iter_pieces(batches):
            out = (self.run_padded(host) if kind == "plain"
                   else self._dispatch_group(host))
            inflight.append((ns, out, self._take_timing()))
            yield from drain(window)
        yield from drain(0)


def get_cached_engine(holder, model_function, *, device_batch_size: int,
                      **engine_kwargs) -> InferenceEngine:
    """The engine of ``model_function`` (``fn(module, x)`` and its
    module) cached on ``holder`` (typically a pipeline stage), keyed as in
    the JAX package on (model function, batch, batches per dispatch) and
    here also on the device, which :func:`resolve_device` reads at the
    call: repeated ``transform`` calls reuse one copy of the weights on
    the card and its captured graphs.  The entry pins the ModelFunction,
    so that keying on its ``id`` cannot alias a recycled object."""
    engine_kwargs.setdefault("batches_per_dispatch",
                             batches_per_dispatch_from_env())
    device = resolve_device(engine_kwargs.pop("device", None))
    cache = holder.__dict__.setdefault("_engine_cache", {})
    key = (id(model_function), device_batch_size,
           engine_kwargs["batches_per_dispatch"], str(device))
    entry = cache.get(key)
    if entry is None:
        eng = InferenceEngine(model_function.fn, model_function.module,
                              device=device,
                              device_batch_size=device_batch_size,
                              **engine_kwargs)
        cache[key] = (model_function, eng)
        return eng
    return entry[1]


# -- the head fan-out: per-tenant heads over one backbone ------------------
def dense_head_row(head, features):
    """THE per-tenant head: one dense projection of ONE feature row (no
    batch axis).  ``head`` is the per-tenant pytree ``{"kernel": (D, C),
    "bias": (C,)}`` (numpy arrays or tensors), ``features`` a (D,) tensor;
    returns (C,) on ``features``' device.  Module-level on purpose, as in
    the JAX package: :class:`HeadBank`, the zoo's feature-cut bundle and
    the oracles all name this one function object.

    It is the head pass of kernel H1 (:func:`~sparkdl_tpu_torch.ops.head.
    head_pass`) over a bank of one, so the unbatched row sums in the same
    order as any row of a stacked mixed-tenant pass: fan-out outputs equal
    per-tenant oracles bit for bit on the card and (through H1's plain
    version) on the CPU.  The JAX package gets that from a
    broadcast-multiply-reduce spelling, which PyTorch does not keep
    batch-invariant."""
    from sparkdl_tpu_torch.ops.head import head_pass

    f = torch.as_tensor(features)
    kernel = torch.as_tensor(head["kernel"], device=f.device)
    bias = torch.as_tensor(head["bias"], device=f.device)
    idx = torch.zeros(1, dtype=torch.int32, device=f.device)
    return head_pass(f[None], idx, kernel[None], bias[None])[0]


def head_fanout_backbone_fn(module, batch):
    """The chip-free stand-in backbone of the head fan-out's proofs (tests
    and :func:`~sparkdl_tpu_torch.serving.cache.head_fanout_benchmark`): a
    dense tanh featurizer over ``module.backbone`` (D_in, D).  ``x @ W`` is
    spelled as a broadcast multiply and a sum, so that a row's arithmetic
    is the same wherever it sits in a batch (the CPU's GEMM picks its
    micro-kernels by row position)."""
    return torch.tanh((batch[..., :, None] * module.backbone).sum(-2))


def head_fanout_oracle_fn(module, row):
    """The INDEPENDENT per-tenant full-model oracle the fan-out's
    bit-identity proofs compare against: one unbatched row through
    ``module``'s fused weights (``backbone``, ``kernel``, ``bias``), the
    program a dedicated per-tenant deployment would serve, never through
    :func:`build_head_fanout`."""
    feats = head_fanout_backbone_fn(module, row)
    return dense_head_row({"kernel": module.kernel, "bias": module.bias},
                          feats)


def head_fanout_module(variables) -> nn.Module:
    """The port's module of the JAX package's stand-in variables: every
    entry of ``variables`` (``{"backbone": W}``, and for the oracle
    ``"kernel"`` and ``"bias"`` too) a buffer of the same name and
    values."""
    module = nn.Module()
    for name in sorted(variables):
        module.register_buffer(
            name, torch.as_tensor(np.array(variables[name], copy=True)))
    return module


_FANOUT_CACHE: Dict[tuple, Callable] = {}
_FANOUT_LOCK = threading.Lock()


def build_head_fanout(head_fn: Callable, device: DeviceLike = None
                      ) -> Callable:
    """THE stacked-head dispatch callable (the JAX package's
    ``build_head_fanout_jit``): ``fanout(stacked, idx, feats)`` takes the
    head bank (every tenant's head pytree stacked along a leading capacity
    axis, on the device), a per-row int32 tenant-index tensor and the
    feature rows, and returns every row through its own tenant's head, so
    K tenants' rows cost ONE head pass.

    :func:`dense_head_row` runs as kernel H1 over the bank
    (:func:`~sparkdl_tpu_torch.ops.head.head_pass`: one launch a pass on
    the card); any other ``head_fn`` runs as plain PyTorch over the
    gathered heads (``torch.func.vmap``), as JAX runs a caller's head
    through XLA.  One callable per (head_fn, device), shared by every bank
    and server: the head-swap no-recompile proof compares its ``id``."""
    device = resolve_device(device)
    key = (head_fn, str(device))
    with _FANOUT_LOCK:
        fanout = _FANOUT_CACHE.get(key)
        if fanout is None:
            fanout = _make_fanout(head_fn)
            _FANOUT_CACHE[key] = fanout
    return fanout


def _make_fanout(head_fn: Callable) -> Callable:
    if head_fn is dense_head_row:
        from sparkdl_tpu_torch.ops.head import head_pass

        def fanout(stacked, idx, feats):
            return head_pass(feats, idx, stacked["kernel"], stacked["bias"])
    else:
        def fanout(stacked, idx, feats):
            rows = idx.long()
            gathered = _tree_map(lambda leaf: leaf[rows], stacked)
            return torch.func.vmap(head_fn)(gathered, feats)
    return fanout


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _host_copy(a) -> np.ndarray:
    """A host array of its own of one head leaf (numpy or a tensor on any
    device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a, copy=True)


class HeadBank:
    """Per-tenant head weights stacked into ONE device pytree served by ONE
    fan-out callable (:func:`build_head_fanout`), as the JAX package's.

    The bank holds K tenants' head pytrees stacked along a leading
    capacity axis (capacity = the next power of two).  A mixed-tenant
    feature batch dispatches as gather-by-tenant-index: one head pass
    (one H1 launch for :func:`dense_head_row`) whatever the number of
    tenants in it.  Rows are not padded: H1 compiles nothing per shape;
    ``headbank.rows`` counts the real rows.

    Degraded mode instead of a crash: a head whose pytree structure, shapes
    or dtypes cannot stack with the bank ("indivisible"), or a bank whose
    stacked bytes would exceed ``hbm_budget_bytes``, flips the bank to
    per-tenant fallback for good: every tenant's rows go through the SAME
    fan-out callable as a bank of one, uploaded per dispatch, so the
    callable's identity and the rows' bits survive; only the one-pass
    batching is lost.

    On the card the stacked bank lives on the device and is rebuilt on each
    mutation; ``dispatch`` uploads the rows and the int32 tenant index,
    runs the pass and fetches the output, all under the bank's lock, as
    every mutation runs under it: a swap under load sees the old bank or
    the new one, never a torn one.  The fault sites ``head.swap`` and
    ``head.dispatch`` fire under the lock before any state changes; each
    add, swap and remove is a ``head.swap`` flight event (tenant, op, bank
    size, mode), emitted once the lock is released.

    H1 takes f32 heads: on CUDA a :func:`dense_head_row` head of another
    dtype raises ``NotImplementedError`` at :meth:`add_head` (ROADMAP.md
    queue B, H1); nothing is cast.  ``mesh=`` is resolved as an engine's
    (:func:`resolve_engine_mesh`: this process's one device); :meth:`stats`
    and the budget read ``mesh.param_sharding_stats`` of the stacked bank
    (all replicated), as JAX's do."""

    def __init__(self, head_fn: Optional[Callable] = None, mesh=None,
                 hbm_budget_bytes: Optional[int] = None,
                 metrics: Optional[Metrics] = None,
                 device: DeviceLike = None):
        self.mesh = resolve_engine_mesh(mesh, device)
        self.head_fn = head_fn if head_fn is not None else dense_head_row
        self.device = resolve_device(self.mesh.devices.flat[0])
        self.hbm_budget_bytes = (None if hbm_budget_bytes is None
                                 else int(hbm_budget_bytes))
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        self._hosts: Dict[str, Any] = {}    # tenant -> host head pytree
        self._index: Dict[str, int] = {}    # tenant -> row in the bank
        self._order: list = []              # tenants in stacking order
        self._stacked = None                # device pytree (capacity, ...)
        self._capacity = 0
        self._leaf_sig = None               # pinned (structure, shapes, dtypes)
        self._fallback = False
        self._fallback_reason: Optional[str] = None
        self._fanout = build_head_fanout(self.head_fn, self.device)

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    @property
    def mode(self) -> str:
        with self._lock:
            return "fallback" if self._fallback else "stacked"

    def tenants(self) -> list:
        with self._lock:
            return list(self._order)

    def jit_info(self) -> Dict[str, Any]:
        """The head half of the no-recompile proof: the fan-out callable's
        ``id`` (it must never change) and ``executables`` None (H1 compiles
        nothing per bank shape; JAX reports its jit's executable count
        here)."""
        return {"jit_id": id(self._fanout), "executables": None,
                "mode": self.mode}

    def stats(self) -> Dict[str, Any]:
        """The bank's device-memory accounting through
        ``mesh.param_sharding_stats``: the stacked bank at capacity, or
        every tenant's head in fallback."""
        with self._lock:
            if self._fallback or not self._order:
                tree = dict(self._hosts) if self._hosts else None
            else:
                tree = self._stacked_avals(self._capacity)
            if tree is None:
                out = {"param_bytes_total": 0, "param_bytes_per_chip": 0}
            else:
                out = mesh_lib.param_sharding_stats(self.mesh, tree)
            out.update({
                "tenants": len(self._order),
                "capacity": self._capacity,
                "mode": "fallback" if self._fallback else "stacked",
                "fallback_reason": self._fallback_reason,
                "hbm_budget_bytes": self.hbm_budget_bytes,
            })
            return out

    def _stacked_avals(self, capacity: int):
        """The stacked bank's leaves as (shape, dtype) stand-ins, without
        stacking: every head stacks alike."""
        from types import SimpleNamespace

        return _tree_map(
            lambda a: SimpleNamespace(shape=(capacity,) + np.shape(a),
                                      dtype=np.asarray(a).dtype),
            self._hosts[self._order[0]])

    # -- mutation --------------------------------------------------------
    def add_head(self, tenant: str, weights) -> None:
        """Register a NEW tenant's head.  Raises ``ValueError`` if the
        tenant already has one (use :meth:`swap_head`)."""
        self._mutate(tenant, weights, op="add")

    def swap_head(self, tenant: str, weights) -> None:
        """Hot-swap an EXISTING tenant's head.  Raises ``KeyError`` if the
        tenant is unknown (use :meth:`add_head`)."""
        self._mutate(tenant, weights, op="swap")

    def remove_head(self, tenant: str) -> None:
        """Evict a departed tenant: its row leaves the bank and the
        remaining tenants re-stack (capacity may shrink)."""
        self._mutate(tenant, None, op="remove")

    def _mutate(self, tenant: str, weights, op: str) -> None:
        tenant = str(tenant)
        with self._lock:
            # the fault site fires BEFORE any state changes: an injected
            # error aborts the mutation with the bank unchanged
            inject("head.swap")
            if op == "remove":
                if tenant not in self._hosts:
                    raise KeyError(f"head bank has no tenant {tenant!r}")
                del self._hosts[tenant]
                self._order.remove(tenant)
            else:
                if op == "add" and tenant in self._hosts:
                    raise ValueError(
                        f"tenant {tenant!r} already has a head; "
                        "swap_head() replaces it")
                if op == "swap" and tenant not in self._hosts:
                    raise KeyError(f"head bank has no tenant {tenant!r}")
                host = _tree_map(_host_copy, weights)
                self._refuse_dtype(host)
                sig = self._signature(host)
                if self._leaf_sig is None:
                    self._leaf_sig = sig
                elif sig != self._leaf_sig and not self._fallback:
                    self._degrade(
                        f"tenant {tenant!r} head does not stack with the "
                        f"bank (pytree/shape/dtype mismatch)")
                self._hosts[tenant] = host
                if op == "add":
                    self._order.append(tenant)
            if not self._fallback:
                cap = _next_pow2(max(1, len(self._order)))
                over = self._budget_excess(cap)
                if over is not None:
                    self._degrade(
                        f"stacked bank would hold {over} bytes per chip, "
                        f"over hbm_budget_bytes={self.hbm_budget_bytes}")
            self._rebuild()
            self.metrics.incr(f"headbank.{op}")
            tenants = len(self._order)
            mode = "fallback" if self._fallback else "stacked"
        flight_emit("head.swap", tenant=tenant, op=op, tenants=tenants,
                    mode=mode)

    def _refuse_dtype(self, host) -> None:
        if self.head_fn is dense_head_row and self.device.type == "cuda":
            bad = sorted({str(a.dtype) for a in _tree_leaves(host)
                          if a.dtype != np.float32})
            if bad:
                raise NotImplementedError(
                    f"kernel H1 takes float32 heads, not {bad} (ROADMAP.md "
                    f"queue B, H1: other head dtypes); nothing is cast")

    @staticmethod
    def _signature(host):
        from sparkdl_tpu_torch.utils.digest import tree_structure

        leaves = _tree_leaves(host)
        return (tree_structure(host),
                tuple(tuple(np.shape(x)) for x in leaves),
                tuple(str(np.asarray(x).dtype) for x in leaves))

    def _degrade(self, reason: str) -> None:
        self._fallback = True
        self._fallback_reason = reason
        self.metrics.incr("headbank.fallbacks")
        logger.warning("HeadBank degrading to per-tenant dispatch: %s",
                       reason)

    def _budget_excess(self, capacity: int):
        """The bytes the stacked bank would hold at ``capacity`` if over
        the budget, else None."""
        if self.hbm_budget_bytes is None or not self._order:
            return None
        per_chip = int(mesh_lib.param_sharding_stats(
            self.mesh, self._stacked_avals(capacity))["param_bytes_per_chip"])
        return per_chip if per_chip > self.hbm_budget_bytes else None

    def _stack_hosts(self, capacity: int):
        heads = [self._hosts[t] for t in self._order]
        rows = heads + [heads[0]] * (capacity - len(heads))
        return _tree_map(lambda *ls: np.stack(ls), *rows)

    def _upload(self, tree):
        return _tree_map(lambda a: torch.from_numpy(a).to(self.device),
                         tree)

    def _rebuild(self) -> None:
        self._index = {t: i for i, t in enumerate(self._order)}
        if not self._order:
            self._stacked = None
            self._capacity = 0
            return
        if self._fallback:
            self._stacked = None
            return
        cap = _next_pow2(len(self._order))
        self._stacked = self._upload(self._stack_hosts(cap))
        self._capacity = cap

    # -- dispatch --------------------------------------------------------
    def _rows(self, features):
        return torch.from_numpy(np.ascontiguousarray(features)).to(
            self.device)

    def _fetch(self, out) -> np.ndarray:
        return _tree_map(lambda t: t.detach().cpu().numpy(), out)

    def dispatch(self, features, tenants) -> np.ndarray:
        """One head pass over a mixed-tenant feature batch.

        ``features`` is ``(n, ...)`` host rows (a single row is promoted);
        ``tenants`` names each row's head.  Returns host outputs
        row-aligned with the input.  Raises ``KeyError`` for a tenant with
        no registered head (a departed tenant fails loudly, never serves a
        stale row)."""
        features = np.asarray(features)
        if features.ndim == 1:
            features = features[None]
        tenants = [str(t) for t in tenants]
        if len(tenants) != int(features.shape[0]):
            raise ValueError(
                f"{features.shape[0]} feature rows but "
                f"{len(tenants)} tenants")
        with self._lock:
            inject("head.dispatch")
            missing = sorted({t for t in tenants if t not in self._hosts})
            if missing:
                raise KeyError(
                    f"head bank has no head for tenant(s) {missing}")
            self.metrics.incr("headbank.dispatches")
            self.metrics.incr("headbank.rows", len(tenants))
            with torch.inference_mode():
                if self._fallback:
                    return self._dispatch_fallback(features, tenants)
                idx = torch.tensor([self._index[t] for t in tenants],
                                   dtype=torch.int32, device=self.device)
                return self._fetch(self._fanout(self._stacked, idx,
                                                self._rows(features)))

    def _dispatch_fallback(self, features, tenants) -> np.ndarray:
        """The degraded path: each tenant's rows through the SAME fan-out
        callable as a bank of one (same callable, same arithmetic), one
        head pass per tenant instead of one in all."""
        groups: Dict[str, list] = {}
        for i, t in enumerate(tenants):
            groups.setdefault(t, []).append(i)
        out = None
        for t, rows in groups.items():
            sel = np.asarray(rows, dtype=np.int64)
            bank1 = self._upload(_tree_map(lambda leaf: leaf[None],
                                           self._hosts[t]))
            idx = torch.zeros(len(rows), dtype=torch.int32,
                              device=self.device)
            res = self._fetch(self._fanout(bank1, idx,
                                           self._rows(features[sel])))
            if out is None:
                out = np.zeros((len(tenants),) + res.shape[1:],
                               dtype=res.dtype)
            out[sel] = res
        return out
