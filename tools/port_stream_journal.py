#!/usr/bin/env python
"""Inspect a streaming commit journal of the PyTorch port (read-only).

Usage::

    python tools/port_stream_journal.py path/to/journal.jsonl [--json]

Prints the journal's commit state: committed and uncommitted chunks, the
resume offset a restarted ``sparkdl_tpu_torch.streaming.StreamScorer``
would seek to, and whether the tail is torn.  Unlike ``Journal`` (whose
construction truncates a torn tail so that it can reopen for append), this
reader never writes: it is safe on the journal of a live run.  The journal
format is the JAX package's, so either package's journal reads here.
Imports nothing but ``sparkdl_tpu_torch``.

Exit codes: 0 clean (everything committed), 1 uncommitted work pending (a
restart would replay), 2 unreadable or corrupt journal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def summarize(path: str) -> dict:
    """Read-only journal summary (shared by the CLI and tests)."""
    from sparkdl_tpu_torch.streaming.journal import COMMIT, INTENT, OUTPUT
    from sparkdl_tpu_torch.utils.jsonl import read_jsonl

    records, valid_bytes = read_jsonl(path)
    intents: dict = {}
    outputs: dict = {}
    committed: dict = {}
    for rec in records:
        kind = rec.get("rec")
        cid = rec.get("chunk_id")
        if kind == INTENT:
            intents[cid] = rec.get("offset")
        elif kind == OUTPUT:
            outputs[cid] = rec
        elif kind == COMMIT:
            committed.setdefault(cid, rec.get("offset"))
    done = set(committed.values())
    resume = 0
    while resume in done:
        resume += 1
    uncommitted = [
        {"chunk_id": cid, "offset": off, "has_output": cid in outputs}
        for cid, off in sorted(intents.items(), key=lambda kv: kv[1])
        if cid not in committed
    ]
    try:
        torn_bytes = max(0, os.path.getsize(path) - valid_bytes)
    except OSError:
        torn_bytes = 0
    return {
        "path": path,
        "records": len(records),
        "committed": len(committed),
        "uncommitted": uncommitted,
        "resume_offset": resume,
        "torn_tail_bytes": torn_bytes,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("journal", help="path to the journal JSONL")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON summary on stdout")
    args = ap.parse_args(argv)
    from sparkdl_tpu_torch.utils.jsonl import JsonlCorruptionError

    try:
        summary = summarize(args.journal)
    except (JsonlCorruptionError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"journal      {summary['path']}")
        print(f"records      {summary['records']}")
        print(f"committed    {summary['committed']}")
        print(f"resume at    offset {summary['resume_offset']}")
        if summary["torn_tail_bytes"]:
            print(f"torn tail    {summary['torn_tail_bytes']} bytes "
                  f"(truncated on next journal open)")
        for rec in summary["uncommitted"]:
            stage = "output-written" if rec["has_output"] else "intent-only"
            print(f"  replay: offset {rec['offset']} "
                  f"{rec['chunk_id']} ({stage})")
    return 1 if summary["uncommitted"] else 0


if __name__ == "__main__":
    sys.exit(main())
