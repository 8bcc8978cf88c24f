"""Exporters (port of ``sparkdl_tpu/obs/export.py``): Chrome trace-event
JSON, span JSONL, Prometheus text exposition, and JSONL snapshots of the
:class:`~sparkdl_tpu_torch.utils.metrics.Metrics` registry.

* **Chrome trace JSON** (:func:`to_chrome_trace` /
  :func:`write_chrome_trace`): the tracer ring as complete ("ph": "X")
  events on the shared ``perf_counter`` timeline, one track per thread,
  for Perfetto or chrome://tracing.  Span lineage (trace/span/parent ids)
  and the device-time split ride in ``args``.
* **Span JSONL** (:func:`write_spans_jsonl` / :func:`load_spans`): one span
  dict per line.  ``load_spans`` also reads the Chrome form back, and a
  directory of flushed artifacts.
* **Metrics snapshot** (:func:`metrics_snapshot` /
  :func:`write_metrics_jsonl`) and **Prometheus text**
  (:func:`prometheus_text`): the registry under stable key names.
  Counters and gauges verbatim; timing series as ``{count, total_s,
  mean_s, p50_s, p99_s}``; unitless histograms as ``{count, mean, p50,
  p99}``.

Given the same span dicts and a registry fed the same calls, every output
is the JAX package's, byte for byte.
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.utils.metrics import Metrics

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "write_spans_jsonl",
    "load_spans",
    "metrics_snapshot",
    "write_metrics_jsonl",
    "prometheus_text",
]


def _spans(spans_or_tracer) -> List[Dict[str, Any]]:
    if hasattr(spans_or_tracer, "snapshot"):
        return spans_or_tracer.snapshot()
    return list(spans_or_tracer)


# -- Chrome trace-event JSON ----------------------------------------------

def to_chrome_trace(spans_or_tracer) -> Dict[str, Any]:
    """Span dicts -> the Chrome trace-event JSON object (Perfetto /
    chrome://tracing).  Spans become complete events ("ph": "X", ``ts``/
    ``dur`` in microseconds); each thread gets a named track via a
    ``thread_name`` metadata event."""
    spans = _spans(spans_or_tracer)
    events: List[Dict[str, Any]] = []
    named_tids = set()
    for s in spans:
        tid = int(s.get("tid") or 0)
        if tid not in named_tids:
            named_tids.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid,
                           "args": {"name": s.get("thread", f"t{tid}")}})
        args = {"trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "status": s.get("status", "ok")}
        if s.get("device_us") is not None:
            args["device_ms"] = round(s["device_us"] / 1e3, 3)
        args.update(s.get("attrs") or {})
        events.append({"ph": "X", "name": s["name"], "cat": "sparkdl",
                       "pid": 0, "tid": tid, "ts": s["ts_us"],
                       "dur": s["dur_us"], "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans_or_tracer) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans_or_tracer), f)
    return path


# -- span JSONL ------------------------------------------------------------

def write_spans_jsonl(path: str, spans_or_tracer) -> str:
    with open(path, "w") as f:
        for s in _spans(spans_or_tracer):
            f.write(json.dumps(s) + "\n")
    return path


def load_spans(path: str) -> List[Dict[str, Any]]:
    """Read spans back from any artifact form the system writes: span
    JSONL (one dict per line), Chrome trace JSON (events converted back to
    span dicts; metadata events dropped), or a DIRECTORY of flushed
    artifacts (``SPARKDL_TRACE=<dir>``: every ``spans_*.jsonl`` inside, or
    failing that every ``trace_*.json``, folded together)."""
    import glob
    import os

    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "spans_*.jsonl")))
        if not files:
            files = sorted(glob.glob(os.path.join(path, "trace_*.json")))
        spans: List[Dict[str, Any]] = []
        for f in files:
            spans.extend(load_spans(f))
        return spans
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return []
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        spans = []
        for ev in doc["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            args = ev.get("args") or {}
            s = {"name": ev["name"], "ts_us": ev["ts"],
                 "dur_us": ev["dur"], "tid": ev.get("tid", 0),
                 "trace_id": args.get("trace_id"),
                 "span_id": args.get("span_id"),
                 "parent_id": args.get("parent_id"),
                 "status": args.get("status", "ok")}
            if args.get("device_ms") is not None:
                s["device_us"] = float(args["device_ms"]) * 1e3
            spans.append(s)
        return spans
    if isinstance(doc, list):
        return doc
    return [json.loads(line) for line in text.splitlines() if line.strip()]


# -- metrics snapshot (stable schema) --------------------------------------

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


def write_metrics_jsonl(path: str, metrics: Metrics,
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """APPEND one snapshot line (timestamped) — a long-running process
    calling this periodically builds a machine-readable history."""
    rec = dict(extra or {})
    rec["ts"] = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    rec.update(metrics_snapshot(metrics))
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


# -- Prometheus text exposition --------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(prefix: str, name: str) -> str:
    n = _NAME_RE.sub("_", f"{prefix}_{name}" if prefix else name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def prometheus_text(metrics: Metrics, prefix: str = "sparkdl") -> str:
    """Prometheus text exposition (v0.0.4) of the registry: counters as
    ``*_total``, gauges verbatim, timing series as ``*_seconds``
    summaries (p50/p99 quantiles + sum/count over the bounded recent
    window), unitless histograms as plain summaries."""
    raw = metrics.snapshot_raw()
    lines: List[str] = []
    for name in sorted(raw["counters"]):
        n = _prom_name(prefix, name) + "_total"
        lines += [f"# TYPE {n} counter", f"{n} {raw['counters'][name]:g}"]
    for name in sorted(raw["gauges"]):
        n = _prom_name(prefix, name)
        lines += [f"# TYPE {n} gauge", f"{n} {raw['gauges'][name]:g}"]

    def summary(n: str, series: List[float]) -> None:
        lines.append(f"# TYPE {n} summary")
        for q, label in ((50, "0.5"), (99, "0.99")):
            lines.append(f'{n}{{quantile="{label}"}} '
                         f"{Metrics._percentile(series, q):g}")
        lines.append(f"{n}_sum {sum(series):g}")
        lines.append(f"{n}_count {len(series)}")

    for name in sorted(raw["timings_s"]):
        series = raw["timings_s"][name]
        if series:
            summary(_prom_name(prefix, name) + "_seconds", series)
    for name in sorted(raw["histograms"]):
        series = raw["histograms"][name]
        if series:
            summary(_prom_name(prefix, name), series)
    return "\n".join(lines) + ("\n" if lines else "")
