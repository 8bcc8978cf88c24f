"""Named counters, gauges and bounded series (port of
``sparkdl_tpu/utils/metrics.py`` without its ``jax.profiler`` context and
step timer).

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
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Metrics:
    """Named counters + gauges + timing lists + unitless observation
    histograms (queue depths, fill ratios)."""

    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    timings_s: Dict[str, List[float]] = field(default_factory=dict)
    histograms: Dict[str, List[float]] = field(default_factory=dict)
    max_samples: int = 16384
    _lock: threading.Lock = field(default_factory=threading.Lock,
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
