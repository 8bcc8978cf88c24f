#!/usr/bin/env python
"""graftlint for the PyTorch port — run the port's static-analysis rules
(``sparkdl_tpu_torch.analysis``) over source trees.

Usage::

    python3 tools/port_graftlint.py sparkdl_tpu_torch chip_smoke.py
    python3 tools/port_graftlint.py --json sparkdl_tpu_torch   # machine-readable
    python3 tools/port_graftlint.py --list-rules

Exit status: 0 when clean, 1 when any finding survives its pragmas.
``--json`` emits a stable machine-readable document for CI consumers::

    {"findings": [{"rule": ..., "path": ..., "line": N,
                   "message": ...}, ...],
     "files": N, "rules": N}

The rules are stdlib-``ast`` only and never import the code they
analyze (importing the ``sparkdl_tpu_torch`` package loads torch, a
second or two; the run over the whole port adds well under a second).  The fault-site registry and the flight-event catalog
are read from ``sparkdl_tpu_torch/faults/sites.py`` and
``sparkdl_tpu_torch/obs/flight.py`` under the targets (or the explicit
``--sites-file`` / ``--events-file``).

Findings print as ``path:line: CODE message``; suppress a deliberate
exception with ``# graftlint: allow=CODE reason=<why>`` on the line or
the line above (a reason-less pragma is itself a finding).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from sparkdl_tpu_torch.analysis import (  # noqa: E402
    RULE_HELP, lint_paths, load_event_registry_file, load_site_registry_file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="port_graftlint",
        description="project-native static analysis for sparkdl_tpu_torch")
    ap.add_argument("targets", nargs="*",
                    help="files and/or directories to lint")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings (stable schema: "
                         "rule, path, line, message)")
    ap.add_argument("--sites-file", default=None,
                    help="explicit faults/sites.py to read the fault-site "
                         "registry from (default: auto-located under the "
                         "targets)")
    ap.add_argument("--events-file", default=None,
                    help="explicit obs/flight.py to read the flight-event "
                         "catalog from (default: auto-located under the "
                         "targets)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(RULE_HELP):
            print(f"{code}  {RULE_HELP[code]}")
        return 0
    if not args.targets:
        ap.error("no targets (try: python3 tools/port_graftlint.py "
                 "sparkdl_tpu_torch chip_smoke.py)")

    missing = [t for t in args.targets if not os.path.exists(t)]
    if missing:
        print(f"graftlint: no such target(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2

    sites = None
    if args.sites_file:
        sites = load_site_registry_file(args.sites_file)
        if not sites:
            print(f"graftlint: {args.sites_file} holds no SITE_HELP/"
                  f"SITES literal", file=sys.stderr)
            return 2
    events = None
    if args.events_file:
        events = load_event_registry_file(args.events_file)
        if not events:
            print(f"graftlint: {args.events_file} holds no EVENT_HELP/"
                  f"EVENTS literal", file=sys.stderr)
            return 2

    findings = lint_paths(args.targets, sites=sites, events=events)
    if args.as_json:
        import json

        print(json.dumps({
            "findings": [{"rule": f.code, "path": f.path, "line": f.line,
                          "message": f.message} for f in findings],
            "files": len({f.path for f in findings}),
            "rules": len(RULE_HELP),
        }, sort_keys=True))
        return 1 if findings else 0
    for f in findings:
        print(f.render())
    if findings:
        print(f"graftlint: {len(findings)} finding(s) across "
              f"{len({f.path for f in findings})} file(s)")
        return 1
    print(f"graftlint: clean ({len(RULE_HELP)} rules over "
          f"{', '.join(args.targets)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
