"""Named counters, gauges and bounded series, the step timer and the
throughput shape (port of ``sparkdl_tpu/utils/metrics.py``).

The engine records its pad-to-bucket ledger (``engine.rows``,
``engine.pad_rows``), its failure domain (``engine.dispatch_errors``, ...),
its CUDA-graph gauges (``engine.graph_pool_bytes``) and the ``engine_call``
timing here; the pipelined runner its ``pipeline.*`` stalls and queue
depths; the serving layer its ``serving.*`` and ``cache.*`` counters,
latencies and fill ratios (read through :meth:`Metrics.snapshot_raw` by
``obs.export.metrics_snapshot``).  Every mutation takes one lock, so concurrent writers (the runner's
three stage threads) stay exact.

Series are bounded: each timing or histogram list keeps at most
``max_samples`` recent samples (the oldest half is dropped on overflow), so
percentiles and means describe the recent window while counters stay
cumulative.

Timers that must not let asynchronous CUDA work fake a speed-up
(:meth:`Metrics.profile`, :class:`StepTimer`) wait for a ``block_on``
tensor the way the JAX package calls ``jax.block_until_ready``: an event
recorded on the current stream of its device, and waited on (never a
whole-device synchronize).
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.analysis.lockcheck import named_lock


def _block(x) -> None:
    # the span's wait (obs.trace), imported here: obs imports this module
    from sparkdl_tpu_torch.obs.trace import _cuda_wait

    _cuda_wait(x)


@dataclass
class Metrics:
    """Named counters + gauges + timing lists + unitless observation
    histograms (queue depths, fill ratios)."""

    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    timings_s: Dict[str, List[float]] = field(default_factory=dict)
    histograms: Dict[str, List[float]] = field(default_factory=dict)
    max_samples: int = 16384
    _lock: Any = field(default_factory=lambda: named_lock("utils.metrics"),
                       init=False, repr=False, compare=False)

    def incr(self, name: str, value: float = 1.0) -> None:
        # float(): numpy scalars never enter the registry
        value = float(value)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        value = float(value)
        with self._lock:
            self.gauges[name] = value

    def _append_bounded(self, series: List[float], value: float) -> None:
        series.append(value)
        if self.max_samples and len(series) > self.max_samples:
            del series[:len(series) // 2]

    def record_time(self, name: str, seconds: float) -> None:
        seconds = float(seconds)
        with self._lock:
            self._append_bounded(self.timings_s.setdefault(name, []),
                                 seconds)

    def observe(self, name: str, value: float) -> None:
        """Append one sample to the unitless histogram ``name``."""
        with self._lock:
            self._append_bounded(self.histograms.setdefault(name, []),
                                 float(value))

    def reset_series(self) -> None:
        """Drop every timing and histogram sample; counters and gauges
        stay.  A measurement window that starts here reads its own samples
        whole, which a slice of a bounded series would not once it drops
        its oldest half."""
        with self._lock:
            self.timings_s.clear()
            self.histograms.clear()

    @staticmethod
    def _percentile(values: List[float], q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
        vs = sorted(values)
        k = max(0, min(len(vs) - 1, math.ceil(q / 100.0 * len(vs)) - 1))
        return vs[k]

    def percentile(self, name: str, q: float,
                   kind: Optional[str] = None) -> Optional[float]:
        """Percentile of a timing or histogram series; None when the series
        is absent or empty.  ``kind`` ("timing" / "histogram") picks the
        family; with None a name present in ``timings_s`` resolves to the
        timing series even when that series is empty."""
        with self._lock:
            if kind == "timing":
                series = self.timings_s.get(name)
            elif kind == "histogram":
                series = self.histograms.get(name)
            elif kind is not None:
                raise ValueError(f"kind must be 'timing', 'histogram', "
                                 f"or None, got {kind!r}")
            elif name in self.timings_s:
                series = self.timings_s[name]
            else:
                series = self.histograms.get(name)
            series = list(series) if series else None
        if not series:
            return None
        return self._percentile(series, q)

    def snapshot_raw(self) -> Dict[str, Dict]:
        """Consistent copies of every family under one lock hold, the raw
        shape ``obs.export.metrics_snapshot`` aggregates from:
        ``{"counters", "gauges", "timings_s", "histograms"}``."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings_s": {k: list(v) for k, v in self.timings_s.items()},
                "histograms": {k: list(v)
                               for k, v in self.histograms.items()},
            }

    def subset(self, prefix: str) -> Dict[str, float]:
        """:meth:`summary` filtered to keys starting with ``prefix``."""
        return {k: v for k, v in self.summary().items()
                if k.startswith(prefix)}

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            out.update(self.gauges)
            timings = {k: list(v) for k, v in self.timings_s.items()}
            hists = {k: list(v) for k, v in self.histograms.items()}
        for k, v in timings.items():
            if v:
                out[f"{k}.mean_s"] = sum(v) / len(v)
                out[f"{k}.total_s"] = sum(v)
                out[f"{k}.count"] = len(v)
                out[f"{k}.p50_s"] = self._percentile(v, 50)
                out[f"{k}.p99_s"] = self._percentile(v, 99)
        for k, v in hists.items():
            if v:
                out[f"{k}.mean"] = sum(v) / len(v)
                out[f"{k}.count"] = len(v)
                out[f"{k}.p50"] = self._percentile(v, 50)
                out[f"{k}.p99"] = self._percentile(v, 99)
        return out

    @contextlib.contextmanager
    def profile(self, trace_dir: str, block_on=None):
        """``torch.profiler`` around a section (the JAX package's
        ``jax.profiler.trace`` context): writes a trace under
        ``trace_dir`` (``*.pt.trace.json``, for TensorBoard or Perfetto),
        with CUDA activity when a card is present; ``block_on`` (a tensor
        tree or a CUDA event) is waited for inside the window, on its
        stream, so asynchronous work does not hide the compute.  The
        section's wall time lands in the ``profile`` timing."""
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    trace_dir)):
            try:
                yield self
            finally:
                if block_on is not None:
                    _block(block_on)
        self.record_time("profile", time.perf_counter() - t0)


class StepTimer:
    """Wall-clock timer that waits for the device's work before stopping."""

    def __init__(self, metrics: Optional[Metrics] = None, name: str = "step"):
        self.metrics = metrics
        self.name = name
        self.elapsed_s = 0.0

    @contextlib.contextmanager
    def time(self, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            self.elapsed_s = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.record_time(self.name, self.elapsed_s)


def throughput_counter(num_items: int, seconds: float,
                       num_devices: int = 1) -> Dict[str, float]:
    """items/sec and items/sec/chip: the baseline metric shape."""
    ips = num_items / seconds if seconds > 0 else float("inf")
    return {
        "items_per_sec": ips,
        "items_per_sec_per_chip": ips / max(1, num_devices),
        "seconds": seconds,
        "num_items": float(num_items),
    }


def profiled_kernels(fn, trace_path: Optional[str] = None):
    """Kernels on the card in one ``fn()``, from ``torch.profiler``'s
    trace: ``(total launches, launches by kernel name, wall ms)``.

    The profiler loses the first kernel records of its window, more as the
    process ages (1-20 of a forward's, late in a process), so ``fn()``
    runs twice in one window and only the kernels of the second call
    count: those whose correlation id is a launch (a runtime or driver
    call, a graph launch included) made inside that call's annotated range
    (``sparkdl.counted``), which also gives the wall ms of the call, the
    card's work included.  ``trace_path`` keeps the window's Chrome trace
    there.  Without a card the profiler sees the CPU only: no kernel
    counts."""
    import json
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        fn()
        sync()
        with record_function("sparkdl.counted"):
            fn()
            sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "sparkdl.counted")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    launches = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}
    names: Dict[str, int] = {}
    for e in events:
        if (e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in launches):
            names[e["name"]] = names.get(e["name"], 0) + 1
    return sum(names.values()), names, float(span["dur"]) / 1e3
