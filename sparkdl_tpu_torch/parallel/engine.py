"""Batch inference engine (port of ``sparkdl_tpu/parallel/engine.py``'s
``InferenceEngine``).

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

Graph memory: every capture of one engine on one device allocates from
ONE memory pool (``torch.cuda.graph_pool_handle()``, passed as ``pool=``),
not a private pool per capture.  Sharing is safe because the engine never
runs two of its graphs at once and reads nothing a graph wrote after
another graph ran: every replay waits on the event recorded after the
previous replay and its output copy (so replays are serialized whatever
stream a caller is on), each replay's output is cloned out of the pool
before that event, and the static inputs live outside the pool.  A graph
may then reuse another's intermediates, so the pool holds about one
forward's memory, not one per bucket.  ``graph_pool_bytes`` is what the
pools reserved; :meth:`InferenceEngine.release_graphs` drops the graphs
(after the cards have finished with them) and returns the pools, and
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
``partition_rules`` / ``param_shardings``, ``sharding_info``): an engine
scores on a mesh of this process's devices, by default
:func:`~sparkdl_tpu_torch.parallel.mesh.get_mesh` (every visible card), or
the one ``device=`` names.  Mesh entries are *slots*; a device may repeat.
Data group g (row g of the mesh) takes rows ``[g*b/dp, (g+1)*b/dp)`` of
each device batch; the weights are placed by
:func:`~sparkdl_tpu_torch.parallel.mesh.place` under the resolved policy: a
leaf the policy splits is one :class:`~sparkdl_tpu_torch.parallel.shard.
ShardedTensor` per data group over the group's model slots (its ops run
per shard or gather first, :mod:`~sparkdl_tpu_torch.parallel.shard`), a
replicated leaf one copy per distinct device, which the groups on that
device share.  The groups' outputs leave them whole and are gathered in
row order on the mesh's first device (a concatenation there; a copy from
another card first), from which the output is fetched as before.  A
policy that resolves all-replicated collapses, as JAX's does
(``sharding_digest`` ``"replicated"``).  A weight split on the data axis
raises ``NotImplementedError``.

Graphs on a mesh: one :class:`_GraphCore` (lock, pool, streams, staging
slots) per distinct device.  A group whose slots all name one device is
one captured graph; groups with the same slots share it (two half-batch
replays a dispatch for dp2 on one card).  Groups on distinct cards
replay one after the other from the dispatching thread, each under its
own core: the launches are asynchronous, so the cards run them at once.
A group that splits a weight over slots on distinct cards runs eagerly,
chosen at construction (``sharding_info()["split_groups"]`` ``"eager"``,
counter ``engine.split_group_eager`` per forward), never after a failed
capture.  ``donate_batch=True`` is accepted and recorded (in
``sharding_info()`` and the graph key): it changes nothing on the card,
where the captured graph already owns its static input and every upload
lands in the engine's own staging slot.

The persistent compile cache (:mod:`sparkdl_tpu_torch.parallel.
compile_cache`): each engine resolves ``SPARKDL_COMPILE_CACHE`` at
construction with its :meth:`InferenceEngine.compile_policy` (the JAX
engine's string for the same mesh and rules), which keys the cache
manifest's policy set.  The cache holds the kernel libraries nvcc builds;
an engine's captured graphs are made anew in every process.
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

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
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
        self._lock = named_lock("engine.breaker")
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
    """The mesh an engine runs on.  With no ``mesh``: the one device
    ``device`` names, or with no ``device`` either
    :func:`~sparkdl_tpu_torch.parallel.mesh.get_mesh` (every visible card,
    the CPU, or the one card the default device names), as JAX's default
    of every local chip; in a ``torch.distributed`` group this rank's
    device.  Scoring is per process, as JAX's is per controller: a mesh
    holding another rank's device raises, as JAX's does; so do a mesh
    mixing device types and a ``device`` that is not the mesh's first.
    Every slot is resolved, so a CUDA slot without a card raises
    ``RuntimeError``."""
    if mesh is None:
        if device is None and distributed.process_count() == 1:
            return mesh_lib.get_mesh()
        return mesh_lib.get_mesh(devices=[resolve_device(device)])
    if device is not None and torch.device(device) != mesh.devices.flat[0]:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.devices.flat[0]}")
    me = distributed.process_index()
    if any(int(r) != me for r in np.asarray(mesh.ranks).flat):
        raise NotImplementedError(
            "InferenceEngine is single-controller: pass a mesh over this "
            "process's devices (mesh.get_mesh(devices=[resolve_device()])) "
            "and shard input rows per rank; multi-process collectives "
            "belong to the TRAIN path (parallel.train / "
            "parallel.distributed).")
    kinds = {resolve_device(d).type for d in mesh.devices.flat}
    if len(kinds) > 1:
        raise ValueError(f"a mesh mixes device types {sorted(kinds)}")
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
def device_module(module: nn.Module, device: torch.device,
                  compute_dtype: Optional[torch.dtype] = None,
                  channels_last: Optional[bool] = None) -> nn.Module:
    """The engine's own copy of ``module``: deep-copied (the caller's is
    left as it is), cast to ``compute_dtype`` when given, in
    ``channels_last`` memory format (default: on CUDA, where the engine
    runs it so), moved to ``device`` and put in eval mode.  The program
    audit builds its meta modules through it with the card's layout."""
    module = copy.deepcopy(module)
    if compute_dtype is not None:
        module = _cast_floating(module, compute_dtype)
    if channels_last if channels_last is not None else device.type == "cuda":
        module = module.to(memory_format=torch.channels_last)
    return module.to(device).eval()


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


def _fold_tensors(entry) -> list:
    """The tensors one fold-cache entry holds (its result; the sources it
    keeps are the module's own)."""
    return [t for t in _tree_leaves(entry[2]) if isinstance(t, torch.Tensor)]


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
_CAPTURE_LOCK = named_lock("engine.capture")

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
    holds on every device (``InferenceEngine.graph_pool_bytes`` summed,
    siblings' shared pools once)."""
    cores = {id(c): c for e in list(_LIVE_ENGINES)
             for c in e._cores.values()}
    return sum(c.pool_bytes for c in cores.values())


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _GraphCore:
    """What an engine shares with its siblings (:meth:`InferenceEngine.
    sibling`) on one device, one per distinct device of the mesh: the lock
    that serialises uploads and dispatches there, the captured graphs, the
    device staging slots, the graphs' one memory pool and the bytes it
    reserved, the event after the last replay's output copy, and (CUDA)
    the upload, fetch and capture streams."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = named_lock("engine.core")
        self.graphs: Dict[tuple, "_Graph"] = {}
        self.slots: Dict[tuple, "_DeviceSlots"] = {}
        self.pool = None
        self.pool_bytes = 0
        self.replayed: Optional[torch.cuda.Event] = None
        if device.type == "cuda":
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
            self.capture_stream = torch.cuda.Stream(device)


def _device_key(device: torch.device) -> str:
    """One name per physical device: ``cuda`` without an index is the
    current card."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


class _Group:
    """One data group, a row of the mesh: its slots, its first
    device (where its input lands and its output leaves it), its module
    (shared by the groups with the same slots), the parameters and buffers
    and fold-cache owners of that module, the graph core of its first
    device, and whether it runs eagerly (a weight split over slots on
    distinct cards)."""

    def __init__(self, slots: tuple, module: nn.Module, core, eager: bool):
        self.slots = slots
        self.device = slots[0]
        self.key = tuple(str(d) for d in slots)
        self.module = module
        self.state = [*module.parameters(), *module.buffers()]
        self.fold_owners = [m for m in module.modules()
                            if isinstance(getattr(m, "_folds", None), dict)]
        self.core = core
        self.eager = eager


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
        cuda = self.device.type == "cuda"
        base = device_module(module, self.device, compute_dtype)
        self.name = type(base).__name__
        self.capture = bool(capture) and cuda
        self._resolve_policy(base, partition_rules, param_shardings)
        # the persistent compile cache resolves once per process; this
        # engine's policy joins its manifest's policy set
        from sparkdl_tpu_torch.parallel import compile_cache

        compile_cache.ensure_from_env(policy=self.compile_policy())
        # one graph core per distinct device: graphs, staging slots, lock,
        # the graphs' one memory pool (made at the first capture), the
        # bytes it reserved, the event after the last replay's output copy
        # (see the module docstring) and the streams; shared with every
        # sibling
        self._cores: Dict[str, _GraphCore] = {}
        for d in self.mesh.devices.flat:
            d = torch.device(d)
            if _device_key(d) not in self._cores:
                self._cores[_device_key(d)] = _GraphCore(d)
        self._core = self._cores[_device_key(self.device)]
        self._place(base)
        self._init_own()
        _LIVE_ENGINES.add(self)

    def _resolve_policy(self, module, partition_rules,
                        param_shardings) -> None:
        """The weight-sharding policy over the device module, as JAX's
        engine resolves it: explicit ``param_shardings`` win over
        ``partition_rules``, and an all-replicated resolution collapses to
        no policy."""
        specs = None
        if param_shardings is not None:
            _, specs = mesh_lib.resolve_param_shardings(
                module, self.mesh, specs=param_shardings)
        elif partition_rules is not None:
            _, specs = mesh_lib.resolve_param_shardings(
                module, self.mesh, partition_rules)
        if specs is not None and mesh_lib.specs_all_replicated(specs):
            specs = None
        self._param_specs = specs
        self.sharding_digest = mesh_lib.partition_digest(specs)
        self._sharding_stats = mesh_lib.param_sharding_stats(
            self.mesh, module, specs)
        self.metrics.gauge("engine.mesh_data_axis", float(self.data_parallel))
        self.metrics.gauge("engine.mesh_model_axis",
                           float(self.model_parallel))
        self.metrics.gauge("engine.replicated_param_bytes",
                           float(self._sharding_stats["param_bytes_total"]))
        self.metrics.gauge("engine.param_bytes_per_chip",
                           float(self._sharding_stats["param_bytes_per_chip"]))

    def _place(self, base: nn.Module) -> None:
        """The data groups: each mesh row's module, with the weights placed
        by ``mesh.place`` under the policy (a split leaf a
        ``ShardedTensor`` over the row's model slots, a replicated one the
        row's device's copy).  Rows with the same slots share one module;
        a one-device mesh keeps ``base`` itself."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        rows = [tuple(torch.device(d) for d in self.mesh.devices[g])
                for g in range(self.data_parallel)]
        leaves = mesh_lib._module_leaves(base)
        specs = ({k: mesh_lib.P() for k in leaves}
                 if self._param_specs is None else self._param_specs)
        dims = {k: mesh_lib.model_split_dim(self.mesh, specs[k])
                for k in leaves}
        self._split = any(d is not None for d in dims.values())
        modules: Dict[tuple, nn.Module] = {}
        if self.mesh.size == 1:
            modules[rows[0]] = base
        else:
            placed = mesh_lib.place(leaves, {
                k: mesh_lib.NamedSharding(self.mesh, specs[k])
                for k in leaves})
            for g, row in enumerate(rows):
                if row in modules:
                    continue
                memo = {}
                for k, leaf in leaves.items():
                    p = placed[k]
                    memo[id(leaf)] = (
                        p.slot(g, 0) if dims[k] is None else ShardedTensor(
                            [p.slot(g, m) for m in range(len(row))],
                            dims[k]))
                for buf in base.buffers():
                    if id(buf) not in memo:  # num_batches_tracked
                        memo[id(buf)] = buf.to(row[0])
                modules[row] = copy.deepcopy(base, memo)
        self._groups: List[_Group] = []
        for row in rows:
            eager = (self._split and self.capture
                     and len({_device_key(d) for d in row}) > 1)
            self._groups.append(_Group(row, modules[row],
                                       self._cores[_device_key(row[0])],
                                       eager))
        first = self._groups[0]
        self.module = first.module
        self._state = first.state
        self._fold_owners = first.fold_owners
        # what a captured graph of this engine also depends on: the slot
        # layout and the policy
        self._layout = (tuple(str(d) for d in self.mesh.devices.flat),
                        tuple(self.mesh.devices.shape), self.sharding_digest)

    def compile_policy(self) -> str:
        """The mesh and partition-rule policy string keying the persistent
        compile cache's manifest (``parallel.compile_cache``), equal to the
        JAX engine's for the same mesh and rules."""
        return (f"mesh={self.data_parallel}x{self.model_parallel}"
                f"|params={self.sharding_digest}")

    def sharding_info(self) -> Dict[str, Any]:
        """JSON snapshot of the engine's weight layout.  JAX's keys with
        JAX's arithmetic: mesh shape, total vs per-device param bytes,
        sharded leaf count, the policy digest, ``sharded`` (a policy that
        did not collapse); and ``donate_batch``.  Measured beside them:
        ``slots`` (the mesh's devices in flat order),
        ``param_bytes_per_slot`` (the most any slot reads: its shards and
        the replicated leaves), ``bytes_per_device`` (each tensor once,
        however many slots share it), ``fold_bytes_per_device`` (the fold
        caches' entries, which hold a split weight's folds whole on its
        group's first device) and ``split_groups`` (``None``, ``"captured"``
        or ``"eager"``: how the groups that split a weight run)."""
        split = None
        if self._split:
            split = ("eager" if any(g.eager for g in self._groups)
                     else "captured" if self.capture else "eager")
        return dict(self._sharding_stats,
                    sharding_digest=self.sharding_digest,
                    sharded=self._param_specs is not None,
                    donate_batch=self.donate_batch,
                    slots=[str(d) for d in self.mesh.devices.flat],
                    param_bytes_per_slot=self.param_bytes,
                    bytes_per_device=self._bytes_per_device(
                        t for g in self._groups for t in g.state),
                    fold_bytes_per_device=self._bytes_per_device(
                        t for g in self._groups
                        for e in fold_entries(g.fold_owners)
                        for t in _fold_tensors(e)),
                    split_groups=split)

    @staticmethod
    def _bytes_per_device(tensors) -> Dict[str, int]:
        """``{device: bytes}`` of ``tensors``, each storage once (a
        ``ShardedTensor`` by its shards)."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        seen: Dict[tuple, int] = {}
        for t in tensors:
            for p in (t.shards if isinstance(t, ShardedTensor) else [t]):
                seen[(_device_key(p.device), p.data_ptr())] = (
                    p.numel() * p.element_size())
        out: Dict[str, int] = {}
        for (dev, _), n in seen.items():
            out[dev] = out.get(dev, 0) + n
        return dict(sorted(out.items()))

    def leaf_shards(self, name: str) -> List[mesh_lib.Shard]:
        """The slots' pieces of parameter or buffer ``name`` (its
        ``state_dict`` name, ``.`` or ``/`` separated), in the mesh's flat
        order, as JAX's ``addressable_shards``: each slot's device, its
        index into the whole leaf and its data."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        name = name.replace("/", ".")
        out = []
        for g in self._groups:
            t = dict(g.module.state_dict(keep_vars=True))[name]
            for m, dev in enumerate(g.slots):
                if isinstance(t, ShardedTensor):
                    b = t.bounds()
                    index = tuple(slice(b[m], b[m + 1]) if d == t.split_dim
                                  else slice(None) for d in range(t.dim()))
                    out.append(mesh_lib.Shard(dev, index, t.shards[m]))
                else:
                    out.append(mesh_lib.Shard(
                        dev, (slice(None),) * t.dim(), t))
        return out

    def _graph_key(self, gr: "_Group") -> tuple:
        return graph_key(gr.state, gr.fold_owners) + (
            self.donate_batch, self._layout)

    def _init_own(self) -> None:
        """What an engine does not share with its siblings besides its
        batch size and breaker: the signature of the last graph it
        captured and its count of captures (``executable_state``)."""
        self._graph_sig = None
        self.captures = 0

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def param_bytes(self) -> int:
        """The bytes of parameters and buffers the fullest slot reads (its
        shards of the split leaves and every replicated leaf; on one
        device, the device module's): the cost ledger's per-bucket HBM
        bytes."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        most = 0
        for g in self._groups:
            for m in range(len(g.slots)):
                n = 0
                for t in g.state:
                    p = t.shards[m] if isinstance(t, ShardedTensor) else t
                    n += p.numel() * p.element_size()
                most = max(most, n)
        return most

    # what a sibling takes from its engine; its batch size and breaker are
    # its own
    _SIBLING_SHARES = ("device", "mesh", "data_parallel", "model_parallel",
                       "donate_batch", "_param_specs", "sharding_digest",
                       "_sharding_stats", "fn", "compute_dtype",
                       "output_host_dtype",
                       "metrics", "batches_per_dispatch", "dispatch_retries",
                       "dispatch_backoff_s", "dispatch_max_backoff_s",
                       "dispatch_jitter", "_on_dispatch_error", "module",
                       "name", "capture", "_state", "_fold_owners", "_core",
                       "_cores", "_groups", "_split", "_layout")

    def sibling(self, device_batch_size: int) -> "InferenceEngine":
        """An engine for ``device_batch_size`` rows over this engine's
        device modules: it shares the modules (one placement of the
        weights), their fold caches, the graph cores (pools, locks, staging
        slots, streams), the metrics and every setting; it captures its
        own graphs for its batch size into the shared pools, and has its
        own circuit breaker."""
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

    def _eager(self, gr: _Group, x, group: bool):
        """Group ``gr``'s forward, op by op (a group of pieces: one forward
        per piece, stacked, as the JAX engine's ``lax.map``); its output
        leaves it whole."""
        if not group:
            out = self.fn(gr.module, x)
        else:
            outs = [self.fn(gr.module, _tree_map(lambda a, i=i: a[i], x))
                    for i in range(self._leaves(x))]
            out = _tree_map(lambda *parts: torch.stack(parts), *outs)
        if self._split:
            from sparkdl_tpu_torch.parallel.shard import gather

            out = _tree_map(gather, out)
        return out

    def _rows(self, a, g: int, axis: int):
        """Data group ``g``'s rows of one batch leaf (``axis`` 1 for a
        stacked group of pieces); the leaf itself on a one-row mesh."""
        if self.data_parallel == 1:
            return a
        n = a.shape[axis] // self.data_parallel
        return a[g * n:(g + 1) * n] if axis == 0 else a[:, g * n:(g + 1) * n]

    def _join(self, outs: list, axis: int):
        """The groups' outputs in row order on the mesh's first device."""
        if len(outs) == 1:
            return outs[0]
        return _tree_map(lambda *parts: torch.cat(
            [p.to(self.device) for p in parts], dim=axis), *outs)

    def _dispatch_rows(self, group: bool) -> int:
        """The rows of one dispatch, padding included (a span's ``rows``)."""
        return self.device_batch_size * (self.batches_per_dispatch if group
                                         else 1)

    def _forward(self, host, group: bool):
        _TIMING.events = None
        axis = 1 if group else 0
        if self.device.type != "cuda":
            x = _tree_map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)), host)
            with get_tracer().span("engine.replay",
                                   rows=self._dispatch_rows(group)), \
                    torch.inference_mode():
                return self._join([self._eager(gr, _tree_map(
                    lambda a, g=g: self._rows(a, g, axis).to(gr.device), x),
                    group) for g, gr in enumerate(self._groups)], axis)
        timed = get_tracer().enabled
        outs, start = [], None
        for g, gr in enumerate(self._groups):
            outs.append(self._forward_group(
                gr, _tree_map(lambda a, g=g: self._rows(a, g, axis), host),
                group, timed))
            if g == 0 and _TIMING.events is not None:
                start = _TIMING.events[0]
        out = self._join(outs, axis)
        if len(outs) > 1:
            # one bracket from the first group's start to the join on the
            # first device, which waits for every group
            _TIMING.events = None
            _end_timing(start, torch.cuda.current_stream(self.device))
        return out

    def _forward_group(self, gr: _Group, host, group: bool, timed: bool):
        """Group ``gr``'s forward on CUDA under its core's lock: upload,
        then replay (or the eager forward), on its first device."""
        core = gr.core
        tracer = get_tracer()
        rows = self._dispatch_rows(group)
        with torch.cuda.device(gr.device), core.lock:
            t0 = time_lib.perf_counter()
            with tracer.span("engine.upload", rows=rows):
                x, slots = self._upload(gr, host)
            cur = torch.cuda.current_stream(gr.device)
            with torch.inference_mode():
                if self.capture and not gr.eager:
                    out = self._replay(gr, x, group, timed)
                else:
                    if gr.eager:
                        self.metrics.incr("engine.split_group_eager")
                    with tracer.span("engine.replay", rows=rows):
                        start = _timing_event(cur) if timed else None
                        out = self._eager(gr, x, group)
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

    def _upload(self, gr: _Group, host):
        """H2D of one host batch tree (group ``gr``'s rows) on its core's
        copy stream into device staging slots; the current stream waits on
        its event.  Returns the device tree and the (slots, index) the
        forward reads."""
        core = gr.core
        pinned = [a if isinstance(a, torch.Tensor)  # a piece _pad staged
                  else torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                  for a in _tree_leaves(host)]
        devs, slots = [], []
        for p in pinned:
            key = (tuple(p.shape), p.dtype)
            if key not in core.slots:
                core.slots[key] = _DeviceSlots(p.shape, p.dtype, gr.device)
        with torch.cuda.stream(core.h2d):
            for p in pinned:
                s = core.slots[(tuple(p.shape), p.dtype)]
                i = s.next
                s.next ^= 1
                if s.free[i] is not None:
                    core.h2d.wait_event(s.free[i])
                s.bufs[i].copy_(p, non_blocking=True)
                devs.append(s.bufs[i])
                slots.append((s, i))
            ev = torch.cuda.Event()
            ev.record(core.h2d)
        torch.cuda.current_stream(gr.device).wait_event(ev)
        it = iter(devs)
        return _tree_map(lambda _: next(it), host), slots

    # -- the captured forward (CUDA) -------------------------------------------
    def _replay(self, gr: _Group, x, group: bool, timed: bool = False):
        """Copy ``x`` into the bucket's graph's static input, replay, and
        copy the output out (the next replay overwrites the static one).
        Captures first when the bucket has no graph for ``gr``'s slots or
        its key moved.  ``timed``: bracket the replay with timing events
        (tracing on)."""
        from sparkdl_tpu_torch.ops import sepconv as ops

        core = gr.core
        tracer = get_tracer()
        rows = self._dispatch_rows(group)
        leaves = _tree_leaves(x)
        cur = torch.cuda.current_stream(gr.device)
        if core.replayed is not None:  # one replay at a time: one pool
            cur.wait_event(core.replayed)
        sig = (gr.key, group) + tuple((tuple(a.shape), a.dtype)
                                      for a in leaves)
        g = core.graphs.get(sig)
        if g is None or g.key != self._graph_key(gr):
            with tracer.span("engine.capture", rows=rows):
                g = self._capture(gr, x, group, sig)
        with tracer.span("engine.replay", rows=rows):
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
            core.replayed = torch.cuda.Event()
            core.replayed.record(cur)
        return out

    def _capture(self, gr: _Group, x, group: bool, sig) -> _Graph:
        with _CAPTURE_LOCK:
            return self._capture_locked(gr, x, group, sig)

    def _capture_locked(self, gr: _Group, x, group: bool, sig) -> _Graph:
        from sparkdl_tpu_torch.ops import sepconv as ops

        core = gr.core
        cur = torch.cuda.current_stream(gr.device)
        old = core.graphs.pop(sig, None)
        if old is not None:
            cur.synchronize()  # its last replay is done before its pool goes
            del old
        static_in = _tree_map(torch.empty_like, x)
        for dst, src in zip(_tree_leaves(static_in), _tree_leaves(x)):
            dst.copy_(src)
        side = core.capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # warm-up, eagerly: fold caches, kernel libraries' one-time
            # attributes and cuDNN's plans are made here, outside the graph
            self._eager(gr, static_in, group)
        cur.wait_stream(side)
        # the fold caches are full now; the capture only reads them
        key = self._graph_key(gr)
        folds = fold_entries(gr.fold_owners)
        before = ops.thread_launch_counts()
        # torch.cuda.graph empties the allocator's cache on entry: do it
        # here first, so that the growth of reserved memory is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_stats(gr.device).get(
            "reserved_bytes.all.current", 0)
        if core.pool is None:
            core.pool = torch.cuda.graph_pool_handle()
        # keep_graph: the captured cudaGraph_t stays readable
        # (``raw_cuda_graph``), so its kernel nodes can be counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            # thread_local: the runner's other threads (pinned copies, D2H
            # fetches, event waits) do not invalidate this capture; the
            # capture stream is the core's own; every capture on the core
            # allocates from its one pool
            with torch.cuda.graph(graph, pool=core.pool, stream=side,
                                  capture_error_mode="thread_local"):
                static_out = self._eager(gr, static_in, group)
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
        pool = torch.cuda.memory_stats(gr.device).get(
            "reserved_bytes.all.current", 0) - reserved
        g = _Graph(key, folds, graph, static_in, static_out, launches,
                   max(0, pool))
        core.graphs[sig] = g
        if gr.key == self._groups[0].key:
            self._graph_sig = sig
        self.captures += 1
        # the shared pool keeps what it reserved until every graph is gone
        core.pool_bytes += g.pool_bytes
        self.metrics.incr("engine.graph_captures")
        self.metrics.gauge("engine.graph_pool_bytes", self.graph_pool_bytes)
        return g

    def graphs(self) -> List[Dict[str, Any]]:
        """One entry per captured graph, on every device: bucket (input
        signature), the group's slots, kernel launches per replay (B1, B3,
        B2) and the pool bytes its capture added."""
        return [dict(bucket=sig[1:], group=sig[0], launches=g.launches,
                     pool_bytes=g.pool_bytes)
                for core in self._cores.values()
                for sig, g in core.graphs.items()]

    def bucket_graph(self) -> Optional[_Graph]:
        """The graph this engine captured last for its first data group,
        while the engine holds it (None before its first capture and after
        :meth:`release_graphs`): a bucket's compiled-program identity, as
        the JAX server reads its bucket's jit object."""
        return self._core.graphs.get(self._graph_sig)

    @property
    def graph_pool_bytes(self) -> int:
        """The bytes the engine's graph pools hold on the cards (0 before
        the first capture and after :meth:`release_graphs`); siblings
        report their shared pools."""
        return sum(c.pool_bytes for c in self._cores.values())

    def pool_bytes_per_device(self) -> Dict[str, int]:
        """:attr:`graph_pool_bytes` by device."""
        return {k: c.pool_bytes for k, c in self._cores.items()}

    def release_graphs(self) -> None:
        """Drop every captured graph (the siblings' too) on every device
        and give the pools' memory back to the cards, once the cards have
        finished what was enqueued on them (a later dispatch captures
        again).  Waits for a dispatch in flight on another thread."""
        cuda = self.device.type == "cuda"
        released = False
        for core in self._cores.values():
            with core.lock:
                if not core.graphs:
                    continue
                if cuda:
                    torch.cuda.synchronize(core.device)
                core.graphs.clear()
                core.pool = None
                core.pool_bytes = 0
                core.replayed = None
                released = True
        if released:
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
        with get_tracer().span("engine.pad", rows=n):
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
        with get_tracer().span("engine.pad", rows=sum(ns)):
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
        tracer = get_tracer()
        rows = ns if isinstance(ns, int) else sum(ns)
        try:
            inject("engine.gather")
            if block is not None:
                block(ready if ready is not None else out)
            with tracer.span("engine.fetch", rows=rows):
                host = self._fetch(out, ready)
            with tracer.span("engine.trim", rows=rows):
                if isinstance(ns, int):
                    parts = [self._trim(host, ns)]
                else:
                    parts = [self._trim(_tree_map(lambda a, i=i: a[i], host),
                                        n) for i, n in enumerate(ns)]
        except NON_RETRYABLE:
            self.breaker.release_trial()
            raise
        except BaseException as e:  # noqa: BLE001 — device/runtime error
            self._charge_breaker(e, "engine.gather_errors")
            raise
        self.breaker.record_success()
        if timing is not None:
            span = tracer.current()
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
        self.metrics.incr("engine.call_host_s", elapsed)
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


def default_placement(device: DeviceLike = None, mesh=None) -> dict:
    """The ``device=`` / ``mesh=`` an entry point's engine takes: ``mesh``
    when given; the default mesh (:func:`resolve_engine_mesh`: every
    visible card) when neither is given and it holds more than one device;
    else the one device :func:`resolve_device` gives."""
    if mesh is None and device is None:
        default = resolve_engine_mesh()
        if default.size > 1:
            mesh = default
    if mesh is not None:
        return {"mesh": mesh}
    return {"device": resolve_device(device)}


def placement_key(where: dict) -> tuple:
    """A hashable key of a :func:`default_placement`."""
    if "mesh" in where:
        mesh = where["mesh"]
        return (tuple(str(d) for d in mesh.devices.flat),
                tuple(mesh.devices.shape))
    return (str(where["device"]),)


def get_cached_engine(holder, model_function, *, device_batch_size: int,
                      **engine_kwargs) -> InferenceEngine:
    """The engine of ``model_function`` (``fn(module, x)`` and its
    module) cached on ``holder`` (typically a pipeline stage), keyed as in
    the JAX package on (model function, batch, batches per dispatch) and
    here also on the devices, which :func:`resolve_device` and
    :func:`resolve_engine_mesh` read at the call: with neither ``device``
    nor ``mesh`` given, the default mesh (every visible card) when it
    holds more than one device, else the one device.  Repeated
    ``transform`` calls reuse one copy of the weights on the card and its
    captured graphs.  The entry pins the ModelFunction, so that keying on
    its ``id`` cannot alias a recycled object."""
    engine_kwargs.setdefault("batches_per_dispatch",
                             batches_per_dispatch_from_env())
    where = default_placement(engine_kwargs.pop("device", None),
                              engine_kwargs.pop("mesh", None))
    cache = holder.__dict__.setdefault("_engine_cache", {})
    key = (id(model_function), device_batch_size,
           engine_kwargs["batches_per_dispatch"], placement_key(where))
    entry = cache.get(key)
    if entry is None:
        eng = InferenceEngine(model_function.fn, model_function.module,
                              device_batch_size=device_batch_size,
                              **where, **engine_kwargs)
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
    batch-invariant.  A bf16 head (a tensor, or a numpy array of
    ml_dtypes' bfloat16) stays bf16; bf16 features are widened to f32, as
    :meth:`HeadBank.dispatch` widens them."""
    from sparkdl_tpu_torch.ops.head import head_pass

    f = _leaf_tensor(features)
    if f.dtype == torch.bfloat16:
        f = f.float()
    kernel = _leaf_tensor(head["kernel"]).to(f.device)
    bias = _leaf_tensor(head["bias"]).to(f.device)
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
_FANOUT_LOCK = named_lock("engine.fanout_cache")


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


def _is_bf16_array(a) -> bool:
    """A numpy array of bfloat16: ml_dtypes' type, in which the JAX
    package's bf16 heads arrive, told by its name (the port never imports
    ml_dtypes)."""
    return isinstance(a, np.ndarray) and a.dtype.name == "bfloat16"


def _leaf_tensor(a) -> torch.Tensor:
    """One head leaf or feature batch as a tensor: a tensor as it is, a
    numpy array of bfloat16 as a bf16 tensor of its own (its bits through
    int16), anything else through ``torch.as_tensor``."""
    if isinstance(a, torch.Tensor):
        return a
    if _is_bf16_array(a):
        return torch.from_numpy(
            np.array(a, copy=True).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def _host_copy(a):
    """A host copy of its own of one head leaf (numpy or a tensor on any
    device): a numpy array, or a CPU bf16 tensor for a bf16 leaf, which
    numpy cannot hold."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.detach().to("cpu", copy=True).contiguous()
        return a.detach().cpu().numpy().copy()
    if _is_bf16_array(a):
        return _leaf_tensor(a)
    return np.array(a, copy=True)


def _dtype_name(a) -> str:
    """A host leaf's dtype by the name both packages give it
    ("float32", "bfloat16", ...)."""
    return str(a.dtype).replace("torch.", "")


def _host_rows(features) -> np.ndarray:
    """Feature rows as a host array; bf16 rows (a tensor, or a numpy array
    of ml_dtypes' bfloat16) widened to f32, exactly."""
    if isinstance(features, torch.Tensor):
        if features.dtype == torch.bfloat16:
            features = features.float()
        return features.detach().cpu().numpy()
    features = np.asarray(features)
    if _is_bf16_array(features):
        return (features.view(np.uint16).astype(np.uint32)
                << 16).view(np.float32)
    return features


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

    Heads are float32 or bfloat16 (torch tensors, or numpy arrays of
    ml_dtypes' bfloat16 as the JAX package's arrive), kernel and bias of
    one type; a bf16 head is held and stacked as bf16, counted at 2 bytes a
    weight, and its feature rows stay f32 (bf16 rows are widened on the
    host, exactly).  A head whose dtypes differ from the bank's degrades it
    to fallback, as JAX's signature check does.  On CUDA a
    :func:`dense_head_row` head of another dtype raises
    ``NotImplementedError`` at :meth:`add_head` (ROADMAP.md queue B, H1);
    nothing is cast.  ``mesh=`` is resolved as an engine's
    (:func:`resolve_engine_mesh`); :meth:`stats` and the budget read
    ``mesh.param_sharding_stats`` of the stacked bank (all replicated), as
    JAX's do.  On a mesh whose data axis is dp > 1 the stacked bank is
    replicated on each data group's first device, a pass's rows are padded
    to a multiple of dp (zero rows on the first tenant's head, as JAX's
    ``_row_bucket`` pads) and split over the groups in row order, and the
    pass runs once in each group (one H1 launch a group)."""

    def __init__(self, head_fn: Optional[Callable] = None, mesh=None,
                 hbm_budget_bytes: Optional[int] = None,
                 metrics: Optional[Metrics] = None,
                 device: DeviceLike = None):
        self.mesh = resolve_engine_mesh(mesh, device)
        self.head_fn = head_fn if head_fn is not None else dense_head_row
        self.device = resolve_device(self.mesh.devices.flat[0])
        # each data group's first device, where its rows and bank live
        self._devices = [resolve_device(self.mesh.devices[g, 0]) for g in
                         range(int(self.mesh.shape[mesh_lib.DATA_AXIS]))]
        self.hbm_budget_bytes = (None if hbm_budget_bytes is None
                                 else int(hbm_budget_bytes))
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = named_lock("engine.headbank")
        self._hosts: Dict[str, Any] = {}    # tenant -> host head pytree
        self._index: Dict[str, int] = {}    # tenant -> row in the bank
        self._order: list = []              # tenants in stacking order
        self._stacked = None                # device -> pytree (cap, ...)
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
            lambda a: SimpleNamespace(shape=(capacity,) + tuple(a.shape),
                                      dtype=a.dtype),
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
            names = {_dtype_name(a) for a in _tree_leaves(host)}
            if names not in ({"float32"}, {"bfloat16"}):
                raise NotImplementedError(
                    f"kernel H1 takes float32 or bfloat16 heads, kernel and "
                    f"bias of one type, not {sorted(names)} (ROADMAP.md "
                    f"queue B, H1: other head dtypes); nothing is cast")

    @staticmethod
    def _signature(host):
        from sparkdl_tpu_torch.utils.digest import tree_structure

        leaves = _tree_leaves(host)
        return (tree_structure(host),
                tuple(tuple(x.shape) for x in leaves),
                tuple(_dtype_name(x) for x in leaves))

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
        return _tree_map(lambda *ls: (torch.stack(ls) if isinstance(
            ls[0], torch.Tensor) else np.stack(ls)), *rows)

    def _upload(self, tree):
        """``tree`` on each data group's device: ``{device: tree}``."""
        return {str(d): _tree_map(lambda a: _leaf_tensor(a).to(d), tree)
                for d in self._devices}

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
    def _fetch(self, out) -> np.ndarray:
        return _tree_map(lambda t: t.detach().cpu().numpy(), out)

    def _pass(self, banks, idx: np.ndarray, features: np.ndarray):
        """One head pass of the fan-out callable over ``banks`` (``{device:
        stacked}``): the rows padded to the data axis and split over the
        data groups, one pass in each; host rows in input order."""
        n = len(idx)
        dp = len(self._devices)
        if dp > 1 and n % dp:
            pad = dp - n % dp
            features = np.concatenate([features, np.zeros(
                (pad,) + features.shape[1:], features.dtype)])
            idx = np.concatenate([idx, np.zeros(pad, np.int32)])
        per = len(idx) // dp
        outs = []  # every group's pass is enqueued before any fetch
        for g, dev in enumerate(self._devices):
            rows = slice(g * per, (g + 1) * per)
            outs.append(self._fanout(
                banks[str(dev)], torch.from_numpy(idx[rows]).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    features[rows])).to(dev)))
        outs = [self._fetch(o) for o in outs]
        if dp == 1:
            return outs[0]
        return _tree_map(lambda *ps: np.concatenate(ps)[:n], *outs)

    def dispatch(self, features, tenants) -> np.ndarray:
        """One head pass over a mixed-tenant feature batch.

        ``features`` is ``(n, ...)`` host rows (a single row is promoted);
        ``tenants`` names each row's head; bf16 rows are widened to f32.
        Returns host outputs row-aligned with the input.  Raises
        ``KeyError`` for a tenant with no registered head (a departed
        tenant fails loudly, never serves a stale row)."""
        features = _host_rows(features)
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
                idx = np.asarray([self._index[t] for t in tenants],
                                 dtype=np.int32)
                return self._pass(self._stacked, idx, features)

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
            res = self._pass(bank1, np.zeros(len(rows), np.int32),
                             features[sel])
            if out is None:
                out = np.zeros((len(tenants),) + res.shape[1:],
                               dtype=res.dtype)
            out[sel] = res
        return out
