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
consecutive-failure :class:`DispatchCircuitBreaker`, and the fault sites
``engine.dispatch`` (enqueue) and ``engine.gather`` (force).

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

Not ported yet: the device mesh and weight sharding and ``donate_batch``
(ROADMAP.md queue A item 4), the head bank (item 5, serving's next slice),
the ``engine.dispatch`` / ``engine.call`` spans and flight events (item
6), and the compile-cache policy (item 7).
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
    the JAX package's, without its flight events).

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
        single trial dispatch once the cool-down elapsed (half-open)."""
        if self.threshold <= 0:
            return
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

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._consecutive = 0
            self._open = False
            self._trial_inflight = False

    def release_trial(self) -> None:
        """Give back a half-open trial slot without judging the device (the
        attempt died on a deterministic caller error)."""
        if self.threshold <= 0:
            return
        with self._lock:
            self._trial_inflight = False

    def record_failure(self, exc: BaseException) -> bool:
        """Count a device error; True when this failure opened (or
        re-opened) the breaker."""
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


def effective_device_batch(device_batch_size: int) -> int:
    """The device batch the engine runs (single device: at least 1)."""
    return max(1, int(device_batch_size))


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


# one capture at a time in the process: the launch counts a capture takes
# back must be its own
_CAPTURE_LOCK = threading.Lock()

# every engine alive in the process, for graph_pool_bytes_held
_LIVE_ENGINES: "weakref.WeakSet[InferenceEngine]" = weakref.WeakSet()


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
    stream.  The kernels' launch counts a capture takes back are its own
    unless another thread launches a kernel eagerly meanwhile."""

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
                 metrics: Optional[Metrics] = None):
        self.device = resolve_device(device)
        self.fn = fn
        self.device_batch_size = effective_device_batch(device_batch_size)
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
        # graphs, staging slots, lock, the graphs' one memory pool (made at
        # the first capture), the bytes it reserved, the event after the
        # last replay's output copy (see the module docstring) and the
        # streams: shared with every sibling
        self._core = _GraphCore(self.device)
        _LIVE_ENGINES.add(self)

    @property
    def num_devices(self) -> int:
        return 1

    # what a sibling takes from its engine; its batch size and breaker are
    # its own
    _SIBLING_SHARES = ("device", "fn", "compute_dtype", "output_host_dtype",
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
        sib.device_batch_size = effective_device_batch(device_batch_size)
        sib.breaker = DispatchCircuitBreaker(
            threshold=self.breaker.threshold,
            cooldown_s=self.breaker.cooldown_s)
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
        return self._run_dispatch(lambda: self._forward(batch, False))

    def _dispatch_group(self, stacked):
        """One dispatch of ``batches_per_dispatch`` stacked pieces: one
        replay of k forwards on CUDA; returns the stacked device output."""
        return self._run_dispatch(lambda: self._forward(stacked, True))

    def _eager(self, x, group: bool):
        """The forward, op by op (a group: one forward per piece, stacked,
        as the JAX engine's ``lax.map``)."""
        if not group:
            return self.fn(self.module, x)
        outs = [self.fn(self.module, _tree_map(lambda a, i=i: a[i], x))
                for i in range(self._leaves(x))]
        return _tree_map(lambda *parts: torch.stack(parts), *outs)

    def _forward(self, host, group: bool):
        if self.device.type != "cuda":
            x = _tree_map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(self.device), host)
            with torch.inference_mode():
                return self._eager(x, group)
        with self._core.lock:
            t0 = time_lib.perf_counter()
            x, slots = self._upload(host)
            with torch.inference_mode():
                out = (self._replay(x, group) if self.capture
                       else self._eager(x, group))
            cur = torch.cuda.current_stream(self.device)
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
    def _replay(self, x, group: bool):
        """Copy ``x`` into the bucket's graph's static input, replay, and
        copy the output out (the next replay overwrites the static one).
        Captures first when the bucket has no graph or its key moved."""
        from sparkdl_tpu_torch.ops import sepconv as ops

        leaves = _tree_leaves(x)
        cur = torch.cuda.current_stream(self.device)
        if self._core.replayed is not None:  # one replay at a time: one pool
            cur.wait_event(self._core.replayed)
        sig = (group,) + tuple((tuple(a.shape), a.dtype) for a in leaves)
        g = self._core.graphs.get(sig)
        if g is None or g.key != graph_key(self._state, self._fold_owners):
            g = self._capture(x, group, sig)
        for dst, src in zip(g.in_leaves, leaves):
            dst.copy_(src)
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA-graph replay of engine {self.name} "
                               f"bucket {sig} failed: {e}") from e
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
        key = graph_key(self._state, self._fold_owners)
        folds = fold_entries(self._fold_owners)
        before = ops.launch_counts()
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
            # the captured launches did not run; each replay credits them
            launches = tuple(a - b for a, b in zip(ops.launch_counts(),
                                                   before))
            ops.credit_launches(tuple(-n for n in launches))
        pool = torch.cuda.memory_stats(self.device).get(
            "reserved_bytes.all.current", 0) - reserved
        g = _Graph(key, folds, graph, static_in, static_out, launches,
                   max(0, pool))
        self._core.graphs[sig] = g
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

    def _force_parts(self, ns, out, ready=None):
        """Force one in-flight dispatch to host row batch(es): the fetch +
        trim shared by the serial drain and the pipelined gather (``ns``
        int = a plain piece; tuple = a group, fetched once and sliced on
        the host).  The other failure surface of an asynchronous dispatch:
        errors charge the breaker, and a successful force is what records
        breaker success."""
        try:
            inject("engine.gather")
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
        if not use_pipe or n <= self.device_batch_size:
            outs = list(self.map_batches([batch], window=window,
                                         pipeline=False))
            result = _tree_map(lambda *parts: np.concatenate(parts, axis=0),
                               *outs)
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
                ns, out = inflight.popleft()
                yield from self._force_parts(ns, out)

        for kind, ns, host in self._iter_pieces(batches):
            inflight.append((ns, self.run_padded(host) if kind == "plain"
                             else self._dispatch_group(host)))
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
