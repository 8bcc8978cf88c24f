#!/usr/bin/env python
"""port_blackbox: reconstruct an incident timeline from a flight dump.

Usage::

    python tools/port_blackbox.py artifacts/flight/            # dir or file
    python tools/port_blackbox.py flight_123.jsonl --spans spans.jsonl \
        --journal stream_journal.jsonl --bench bench_lines.jsonl
    python tools/port_blackbox.py flight_123.jsonl --trace <id> --json

Folds the :mod:`sparkdl_tpu_torch.obs.flight` recorder's durable dump (a
file, or a directory of ``flight_*.jsonl`` from several processes)
with whatever other artifacts the run left behind — span JSONL /
Chrome trace / trace directory (``obs.export.load_spans`` forms), a
streaming commit journal, and a bench ``bench_lines.jsonl`` artifact —
into ONE trace-id-correlated incident timeline: every state-change
event in order, annotated with the request trace it happened inside,
ending with per-tracker health verdicts and the journal's replay
state.  ``--trace`` narrows the timeline to one request's incident
slice.

All inputs are read with the shared torn-tail-tolerant
``utils.jsonl.read_jsonl`` reader where they are crash-safe JSONL, so
pointing this at the dump of a SIGKILLed process works by design —
that is the scenario the recorder exists for.  The dump, span, journal
and bench formats are the JAX package's, so either package's artifacts
fold here; this tool imports nothing but the standard library and
``sparkdl_tpu_torch`` (and ``tools/port_stream_journal.py`` for a
journal), so it runs where there is no JAX.

Exit codes: 0 — timeline ends healthy (every degraded tracker
recovered, no journal replay pending); 1 — unresolved incident (a
tracker is still degraded, or uncommitted stream work remains);
2 — unreadable/corrupt input.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_events(path: str) -> List[Dict[str, Any]]:
    """Flight events from a dump file or a directory of
    ``flight_*.jsonl``, ordered for the timeline: wall clock first (the
    only cross-process axis), per-process ``seq`` as the tiebreak (the
    authoritative within-process order — two events in the same
    microsecond still render in emit order)."""
    from sparkdl_tpu_torch.utils.jsonl import read_jsonl

    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "flight_*.jsonl")))
    else:
        files = [path]
    events: List[Dict[str, Any]] = []
    for f in files:
        recs, _ = read_jsonl(f)
        events.extend(recs)
    events.sort(key=lambda e: (e.get("t_wall", 0.0), e.get("pid", 0),
                               e.get("seq", 0)))
    return events


def _span_index(spans: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """trace_id -> {root, spans, count} for correlation."""
    by_trace: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if not tid:
            continue
        entry = by_trace.setdefault(tid, {"root": None, "spans": [],
                                          "count": 0})
        entry["count"] += 1
        if s.get("name") not in entry["spans"]:
            entry["spans"].append(s.get("name"))
        if not s.get("parent_id"):
            entry["root"] = s.get("name")
    return by_trace


def _health_verdicts(events: List[Dict[str, Any]]) -> Dict[str, str]:
    """Per-tracker final state from the health.* event stream — the
    'did it recover?' question a point-in-time poll races past."""
    verdicts: Dict[str, str] = {}
    for e in events:
        name = e.get("event")
        if name not in ("health.degraded", "health.ready"):
            continue
        tracker = (e.get("attrs") or {}).get("tracker", "?")
        verdicts[tracker] = ("degraded" if name == "health.degraded"
                            else "ready")
    return verdicts


def build_timeline(flight_path: str,
                   spans_path: Optional[str] = None,
                   journal_path: Optional[str] = None,
                   bench_path: Optional[str] = None,
                   trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The machine-readable incident document (shared by the CLI and
    the acceptance test).  Stable schema: ``events`` (ordered, each
    with ``rel_s`` from the first event's wall clock and a
    ``trace_known`` flag), ``chain`` (the ordered event-name sequence —
    the causal-chain assertion surface), ``traces`` (trace id ->
    correlated span names), ``health`` (per-tracker final verdicts),
    ``counts``, plus optional ``journal`` and ``bench`` sections."""
    events = load_events(flight_path)
    spans: List[Dict[str, Any]] = []
    if spans_path:
        from sparkdl_tpu_torch.obs.export import load_spans

        spans = load_spans(spans_path)
    traces = _span_index(spans)
    # the verdict always rates the WHOLE dump: health.*/slo.* events
    # carry no trace id, so a --trace-narrowed view would otherwise
    # filter the incident out and report a still-degraded dump clean
    all_events = events
    if trace_id is not None:
        events = [e for e in events if e.get("trace_id") == trace_id]
        traces = {k: v for k, v in traces.items() if k == trace_id}
    t0 = events[0].get("t_wall", 0.0) if events else 0.0
    out_events: List[Dict[str, Any]] = []
    counts: Dict[str, int] = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
        ev = dict(e)
        ev["rel_s"] = round(e.get("t_wall", t0) - t0, 6)
        tid = e.get("trace_id")
        ev["trace_known"] = bool(tid and tid in traces)
        out_events.append(ev)
    doc: Dict[str, Any] = {
        "events": out_events,
        "chain": [e["event"] for e in out_events],
        "counts": counts,
        "health": _health_verdicts(all_events),
        "traces": {tid: traces[tid] for tid in sorted(traces)},
        "correlated_events": sum(1 for e in out_events
                                 if e["trace_known"]),
    }
    if journal_path:
        from tools.port_stream_journal import summarize

        doc["journal"] = summarize(journal_path)
    if bench_path:
        from sparkdl_tpu_torch.utils.jsonl import read_jsonl

        lines, _ = read_jsonl(bench_path)
        doc["bench"] = [{"config": r.get("config"),
                         "metric": r.get("metric"),
                         "faults": r.get("faults"),
                         "slo": (r.get("slo") or {}).get("state")
                         if isinstance(r.get("slo"), dict) else None}
                        for r in lines]
    unresolved = [t for t, v in doc["health"].items() if v == "degraded"]
    replay = bool(doc.get("journal", {}).get("uncommitted"))
    doc["verdict"] = {
        "unrecovered_trackers": sorted(unresolved),
        "journal_replay_pending": replay,
        "clean": not unresolved and not replay,
    }
    return doc


def _render(doc: Dict[str, Any]) -> None:
    print(f"flight events  {len(doc['events'])}  "
          f"(trace-correlated: {doc['correlated_events']})")
    for e in doc["events"]:
        attrs = e.get("attrs") or {}
        attr_s = " ".join(f"{k}={v}" for k, v in attrs.items())
        tid = e.get("trace_id")
        tid_s = (f" trace={tid[:8]}{'*' if e['trace_known'] else ''}"
                 if tid else "")
        print(f"  +{e['rel_s']:9.4f}s [pid {e.get('pid', '?')}] "
              f"{e['event']}{tid_s} {attr_s}".rstrip())
    if doc["traces"]:
        print("correlated traces (* above = spans on file):")
        for tid, t in doc["traces"].items():
            print(f"  {tid[:8]}  root={t['root']}  spans={t['count']} "
                  f"({', '.join(t['spans'])})")
    if doc["health"]:
        print("health verdicts:")
        for tracker, v in sorted(doc["health"].items()):
            print(f"  {tracker}: {v}")
    j = doc.get("journal")
    if j:
        print(f"journal: {j['committed']} committed, "
              f"{len(j['uncommitted'])} replay-pending, "
              f"resume at offset {j['resume_offset']}")
    for b in doc.get("bench", []):
        print(f"bench: {b['config']} faults={b['faults']} "
              f"slo={b['slo']}")
    v = doc["verdict"]
    if v["clean"]:
        print("verdict: clean — every degradation recovered")
    else:
        print(f"verdict: UNRESOLVED — degraded trackers: "
              f"{v['unrecovered_trackers'] or 'none'}, journal replay "
              f"pending: {v['journal_replay_pending']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="port_blackbox", description=__doc__.splitlines()[0])
    ap.add_argument("flight", help="flight dump file, or a directory of "
                                   "flight_*.jsonl")
    ap.add_argument("--spans", default=None,
                    help="span JSONL / Chrome trace / trace directory "
                         "to correlate trace ids against")
    ap.add_argument("--journal", default=None,
                    help="streaming commit journal to fold in")
    ap.add_argument("--bench", default=None,
                    help="bench_lines.jsonl artifact to fold in")
    ap.add_argument("--trace", default=None,
                    help="narrow the timeline to one trace id")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable timeline document on stdout")
    args = ap.parse_args(argv)
    from sparkdl_tpu_torch.utils.jsonl import JsonlCorruptionError

    try:
        doc = build_timeline(args.flight, spans_path=args.spans,
                             journal_path=args.journal,
                             bench_path=args.bench, trace_id=args.trace)
    except (JsonlCorruptionError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc))
    else:
        _render(doc)
    return 0 if doc["verdict"]["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
