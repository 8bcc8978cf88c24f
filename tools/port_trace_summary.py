#!/usr/bin/env python
"""Fold a span trace into a PERF.md-style per-stage table, for the
PyTorch port (``sparkdl_tpu_torch``).

Reads either trace artifact the system writes, whichever package wrote
it: span JSONL (``spans_<pid>.jsonl``, ``Tracer.flush``) or Chrome
trace-event JSON (``trace_<pid>.json``), or a directory of them
(``SPARKDL_TRACE=<dir>``), through the port's
``sparkdl_tpu_torch.obs.export.load_spans``.  Needs no card, and imports
nothing but the standard library and ``sparkdl_tpu_torch``.

Usage::

    python tools/port_trace_summary.py TRACE [--sort total|count|p99]
                                             [--wall-span NAME]

Output: one markdown table row per span name: count, total ms, p50 / p99
ms, device ms (where a span carries ``device_ms``: the engine's CUDA-event
time of a replay), and % of wall.  Wall is the full extent of the trace
(max end - min start) unless ``--wall-span`` names a span (e.g.
``pipeline.run``) to use as the denominator.  Stage totals can sum past
100% of wall: overlapping stages are the point of the pipeline, and the
table makes the overlap a number.

Exit codes: 0 a table printed, 1 no spans in the trace.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def summarize(spans: List[dict], wall_span: str = None) -> Dict:
    """Per-name aggregation and the wall denominator (microseconds here,
    milliseconds in the rendered table)."""
    if not spans:
        return {"wall_us": 0.0, "stages": {}}
    if wall_span:
        roots = [s for s in spans if s.get("name") == wall_span]
        if not roots:
            raise SystemExit(f"--wall-span {wall_span!r} matches no span; "
                             f"names present: "
                             f"{sorted({s['name'] for s in spans})}")
        wall_us = sum(float(s["dur_us"]) for s in roots)
    else:
        t0 = min(float(s["ts_us"]) for s in spans)
        t1 = max(float(s["ts_us"]) + float(s["dur_us"]) for s in spans)
        wall_us = t1 - t0
    from sparkdl_tpu_torch.utils.metrics import Metrics

    stages: Dict[str, Dict] = {}
    for s in spans:
        st = stages.setdefault(s["name"], {"durs": [], "device_us": 0.0})
        st["durs"].append(float(s["dur_us"]))
        st["device_us"] += float(s.get("device_us") or 0.0)
    for st in stages.values():
        durs = st.pop("durs")
        st["count"] = len(durs)
        st["total_us"] = sum(durs)
        # the registry's nearest-rank percentile: one definition across
        # metric snapshots and trace tables
        st["p50_us"] = Metrics._percentile(durs, 50)
        st["p99_us"] = Metrics._percentile(durs, 99)
    return {"wall_us": wall_us, "stages": stages}


def render(summary: Dict, sort: str = "total") -> str:
    wall_us = summary["wall_us"]
    key = {"total": lambda kv: -kv[1]["total_us"],
           "count": lambda kv: -kv[1]["count"],
           "p99": lambda kv: -kv[1]["p99_us"]}[sort]
    rows = sorted(summary["stages"].items(), key=key)
    lines = [
        "| stage | count | total ms | p50 ms | p99 ms | device ms "
        "| % of wall |",
        "|---|---:|---:|---:|---:|---:|---:|",
    ]
    for name, st in rows:
        pct = (100.0 * st["total_us"] / wall_us) if wall_us else 0.0
        dev = (f"{st['device_us'] / 1e3:.1f}" if st["device_us"]
               else "-")
        lines.append(
            f"| {name} | {st['count']} | {st['total_us'] / 1e3:.1f} "
            f"| {st['p50_us'] / 1e3:.2f} | {st['p99_us'] / 1e3:.2f} "
            f"| {dev} | {pct:.0f}% |")
    lines.append(f"\nwall: {wall_us / 1e3:.1f} ms "
                 f"({summary['wall_us'] / 1e6:.3f} s); stages overlap, "
                 f"so percentages may sum past 100.")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fold a span trace (JSONL or Chrome JSON) into a "
                    "per-stage table.")
    ap.add_argument("trace", help="spans_*.jsonl or trace_*.json path")
    ap.add_argument("--sort", choices=("total", "count", "p99"),
                    default="total")
    ap.add_argument("--wall-span", default=None,
                    help="span name to use as the wall-clock denominator "
                         "(default: full trace extent)")
    args = ap.parse_args(argv)
    from sparkdl_tpu_torch.obs.export import load_spans

    spans = load_spans(args.trace)
    if not spans:
        print("no spans in trace", file=sys.stderr)
        return 1
    print(render(summarize(spans, wall_span=args.wall_span),
                 sort=args.sort))
    return 0


if __name__ == "__main__":
    sys.exit(main())
