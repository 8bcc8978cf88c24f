"""Metrics snapshot under stable key names (port of
``sparkdl_tpu/obs/export.py``'s :func:`metrics_snapshot`; its Chrome-trace,
span and Prometheus exporters wait for the tracer).

The :class:`~sparkdl_tpu_torch.utils.metrics.Metrics` registry aggregated
as the JAX package aggregates it: counters and gauges verbatim; timing
series as ``{count, total_s, mean_s, p50_s, p99_s}``; unitless histograms
as ``{count, mean, p50, p99}``.
"""

from __future__ import annotations

from typing import Any, Dict

from sparkdl_tpu_torch.utils.metrics import Metrics

__all__ = ["metrics_snapshot"]


def metrics_snapshot(metrics: Metrics) -> Dict[str, Any]:
    """The registry as a stable nested dict, the JAX package's shape:
    ``Server.varz`` embeds it.  Every number is a Python float (the JSON
    boundary)."""
    raw = metrics.snapshot_raw()
    out: Dict[str, Any] = {
        "counters": {k: float(v) for k, v in raw["counters"].items()},
        "gauges": {k: float(v) for k, v in raw["gauges"].items()},
        "timings_s": {},
        "histograms": {},
    }
    for name, series in raw["timings_s"].items():
        if not series:
            continue
        out["timings_s"][name] = {
            "count": len(series),
            "total_s": float(round(sum(series), 6)),
            "mean_s": float(round(sum(series) / len(series), 6)),
            "p50_s": float(round(Metrics._percentile(series, 50), 6)),
            "p99_s": float(round(Metrics._percentile(series, 99), 6)),
        }
    for name, series in raw["histograms"].items():
        if not series:
            continue
        out["histograms"][name] = {
            "count": len(series),
            "mean": float(round(sum(series) / len(series), 6)),
            "p50": float(round(Metrics._percentile(series, 50), 6)),
            "p99": float(round(Metrics._percentile(series, 99), 6)),
        }
    return out
