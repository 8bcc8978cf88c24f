"""Batch inference engine (port of the single-device core of
``sparkdl_tpu/parallel/engine.py``'s ``InferenceEngine``).

Runs ``fn(module, batch) -> out`` over arbitrarily sized host inputs in
fixed-size device batches on one device: each chunk is sliced into
``device_batch_size`` pieces, the ragged tail is zero-padded up to that
bucket (counted in ``engine.rows`` / ``engine.pad_rows``) and trimmed off
the output.  A bounded window of pieces is in flight at once: CUDA runs
asynchronously, so piece k+1 is enqueued before piece k is fetched.

Not ported yet (later slices): the device mesh and weight sharding, grouped
dispatch (``batches_per_dispatch``), the dispatch retry budget and circuit
breaker, the head bank and the pipelined runner.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.nn as nn

from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)


def effective_device_batch(device_batch_size: int) -> int:
    """The device batch the engine runs (single device: at least 1)."""
    return max(1, int(device_batch_size))


def _cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer to ``dtype`` (integer
    buffers such as BatchNorm's ``num_batches_tracked`` stay)."""
    return module.to(dtype=dtype)


class InferenceEngine:
    """``fn(module, x)`` over host batches on ``device``.

    ``module`` is copied to the device once (the caller's module is left
    where it is), cast to ``compute_dtype`` when given, and put in eval
    mode.  ``output_host_dtype``: outputs are fetched in the dtype the
    device produced and widened on the host (half the device-to-host bytes
    of widening on the device; bit-identical).  A bf16 output, which numpy
    cannot hold, is widened to float32 on the host in any case."""

    def __init__(self, fn: Callable[[nn.Module, torch.Tensor], Any],
                 module: nn.Module, *, device: DeviceLike = None,
                 device_batch_size: int = 64,
                 compute_dtype: Optional[torch.dtype] = None,
                 output_host_dtype: Optional[Any] = None,
                 metrics: Optional[Metrics] = None):
        self.device = resolve_device(device)
        self.fn = fn
        self.device_batch_size = effective_device_batch(device_batch_size)
        self.compute_dtype = compute_dtype
        self.output_host_dtype = (np.dtype(output_host_dtype)
                                  if output_host_dtype is not None else None)
        self.metrics = metrics if metrics is not None else Metrics()
        module = copy.deepcopy(module)
        if compute_dtype is not None:
            module = _cast_floating(module, compute_dtype)
        if self.device.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        self.module = module.to(self.device).eval()

    @property
    def num_devices(self) -> int:
        return 1

    # -- low level ---------------------------------------------------------
    def run_padded(self, batch: np.ndarray) -> torch.Tensor:
        """Run one already-padded host batch; returns the device output
        (not yet synchronised)."""
        if len(batch) != self.device_batch_size:
            raise ValueError(
                f"run_padded expects batch of {self.device_batch_size}, "
                f"got {len(batch)}")
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        with torch.inference_mode():
            return self.fn(self.module, x)

    def _pad(self, chunk: np.ndarray) -> np.ndarray:
        n = len(chunk)
        # pad-to-bucket ledger: real vs padded rows per dispatched piece
        self.metrics.incr("engine.rows", n)
        if n == self.device_batch_size:
            return chunk
        self.metrics.incr("engine.pad_rows", self.device_batch_size - n)
        pad = [(0, self.device_batch_size - n)] + [(0, 0)] * (chunk.ndim - 1)
        return np.pad(chunk, pad)

    def _trim(self, out: torch.Tensor, n: int) -> np.ndarray:
        host = out[:n].cpu()
        if host.dtype == torch.bfloat16:
            host = host.to(torch.float32)  # exact widening, on the host
        host = host.numpy()
        if (self.output_host_dtype is not None
                and host.dtype != self.output_host_dtype
                and np.issubdtype(host.dtype, np.floating)
                and np.issubdtype(self.output_host_dtype, np.floating)):
            host = host.astype(self.output_host_dtype)
        return host

    # -- whole-array API ---------------------------------------------------
    def __call__(self, batch, window: int = 2) -> np.ndarray:
        """Process a full host batch; returns the host output with the same
        row count."""
        batch = np.asarray(batch)
        if len(batch) == 0:
            raise ValueError("Empty input batch")
        return np.concatenate(list(self.map_batches([batch], window)), axis=0)

    # -- streaming API -----------------------------------------------------
    def _iter_pieces(self, batches: Iterable[Any]) -> Iterator[tuple]:
        """Slice chunks into device-batch pieces and pad them; yields
        ``(n_rows, padded_piece)`` in dispatch order."""
        for chunk in batches:
            chunk = np.asarray(chunk)
            for off in range(0, len(chunk), self.device_batch_size):
                piece = chunk[off:off + self.device_batch_size]
                yield len(piece), self._pad(piece)

    def map_batches(self, batches: Iterable[Any], window: int = 2
                    ) -> Iterator[np.ndarray]:
        """Map over an iterator of host batches with at most ``window``
        device batches in flight; yields one host output per piece."""
        inflight: deque = deque()

        def drain(limit):
            while len(inflight) > limit:
                n, out = inflight.popleft()
                yield self._trim(out, n)

        for n, host in self._iter_pieces(batches):
            inflight.append((n, self.run_padded(host)))
            yield from drain(window)
        yield from drain(0)
