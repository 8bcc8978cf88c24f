#!/usr/bin/env python
"""graftcheck for the PyTorch port — audit the port's programs against
``PROGRAMS_TORCH.lock.json`` (rules GC000-GC005; see
``sparkdl_tpu_torch/analysis/program``).

Usage::

    python3 tools/port_graftcheck.py                     # audit + verify
    python3 tools/port_graftcheck.py --write-baseline    # regenerate
    python3 tools/port_graftcheck.py --json              # machine-readable
    python3 tools/port_graftcheck.py --models Xception --no-train
    python3 tools/port_graftcheck.py --list-rules

Card-free by construction: every program is built on the meta device
(no weights, no memory, no compute), so the full inventory audits on a
CPU in about a quarter of a minute, and on the card under the card's
torch.  The lockfile's fingerprint is the meta-traced call list, which
does not move with the torch build; the audit warns when the lockfile's
``torch_version`` differs from the running one.

Exit status: 0 clean and matching the committed lockfile; 1 findings or
drift (each line names the GC rule); 2 no lockfile or bad setup.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the canonical configuration the committed lockfile is written from;
#: any narrowing makes the run a subset audit
BASELINE_MAX_BATCH = 32
BASELINE_COMPUTE_DTYPE = "bfloat16"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="port_graftcheck",
        description="meta-device program auditor for sparkdl_tpu_torch")
    ap.add_argument("--lockfile", default=None,
                    help="lockfile path (default: the repo's "
                         "PROGRAMS_TORCH.lock.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the audited records as the new baseline "
                         "instead of verifying against it")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output: {findings, programs}")
    ap.add_argument("--models", default=None,
                    help="comma list narrowing the zoo sweep (audits a "
                         "SUBSET: missing-program drift is not checked)")
    ap.add_argument("--max-batch", type=int, default=BASELINE_MAX_BATCH,
                    help="serving max batch; buckets are its quarter/"
                         "half/full plan (default 32)")
    ap.add_argument("--compute-dtype", default=BASELINE_COMPUTE_DTYPE,
                    choices=("bfloat16", "float32"),
                    help="audited zoo compute dtype (default bfloat16, "
                         "the configuration GC002 guards)")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the train-step programs")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel programs")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the GC rule table and exit")
    args = ap.parse_args(argv)

    from sparkdl_tpu_torch.analysis.program import (GC_RULE_HELP,
                                                    DEFAULT_LOCKFILE,
                                                    audit_inventory,
                                                    diff_records,
                                                    read_lockfile,
                                                    stack_programs,
                                                    write_lockfile)

    if args.list_rules:
        for code in sorted(GC_RULE_HELP):
            print(f"{code}  {GC_RULE_HELP[code]}")
        return 0
    if args.max_batch < 1:
        print(f"port_graftcheck: --max-batch must be positive, got "
              f"{args.max_batch}", file=sys.stderr)
        return 2
    path = args.lockfile or DEFAULT_LOCKFILE
    if not args.write_baseline and not os.path.isfile(path):
        print(f"port_graftcheck: no lockfile at {path}; run "
              f"tools/port_graftcheck.py --write-baseline first",
              file=sys.stderr)
        return 2

    import torch

    models = ([m.strip() for m in args.models.split(",") if m.strip()]
              if args.models else None)
    # ANY narrowing away from the baseline configuration makes this a
    # subset audit: the missing-program drift check would otherwise
    # report every deliberately skipped program as "silently left"
    subset = (bool(models) or args.no_train or args.no_kernels
              or args.max_batch != BASELINE_MAX_BATCH
              or args.compute_dtype != BASELINE_COMPUTE_DTYPE)
    try:
        specs = stack_programs(max_batch_size=args.max_batch, models=models,
                               compute_dtype=args.compute_dtype,
                               include_train=not args.no_train,
                               include_kernels=not args.no_kernels)
    except ValueError as e:  # an unknown model name
        print(f"port_graftcheck: {e}", file=sys.stderr)
        return 2

    progress = None if args.as_json else (
        lambda line: print(f"  {line}", flush=True))
    if not args.as_json:
        print(f"port_graftcheck: auditing {len(specs)} programs "
              f"({args.compute_dtype}, max_batch={args.max_batch})")
    records, findings = audit_inventory(specs, progress=progress)

    if args.write_baseline:
        if findings:
            _emit(args.as_json, findings, records,
                  "refusing to baseline a failing audit")
            return 1
        write_lockfile(records, path, meta={
            "torch_version": torch.__version__,
            "device_count": 1,
            "compute_dtype": args.compute_dtype,
            "max_batch_size": args.max_batch,
            "generated_by": "tools/port_graftcheck.py --write-baseline",
        })
        if args.as_json:
            print(json.dumps({"findings": [], "written": path,
                              "programs": len(records)}))
        else:
            print(f"port_graftcheck: baseline written to {path} "
                  f"({len(records)} programs)")
        return 0

    committed = read_lockfile(path)
    meta = committed.get("meta", {})
    if meta.get("torch_version") not in (None, torch.__version__):
        print(f"port_graftcheck: note — lockfile was generated under torch "
              f"{meta.get('torch_version')}, running {torch.__version__}",
              file=sys.stderr)
    findings.extend(diff_records(committed, records, subset=subset))
    _emit(args.as_json, findings, records, None)
    return 1 if findings else 0


def _emit(as_json: bool, findings, records, note) -> None:
    if as_json:
        print(json.dumps({
            "findings": [{"rule": f.code, "path": f.path, "line": f.line,
                          "message": f.message} for f in findings],
            "programs": {r["name"]: {"fingerprint": r["fingerprint"],
                                     "flops": r["flops"],
                                     "kernels": r["kernels"],
                                     "findings": r["findings"]}
                         for r in records},
        }, sort_keys=True))
        return
    if note:
        print(f"port_graftcheck: {note}", file=sys.stderr)
    for f in findings:
        print(f.render())
    if findings:
        print(f"port_graftcheck: {len(findings)} finding(s) across "
              f"{len({f.path for f in findings})} program(s)")
    else:
        print(f"port_graftcheck: clean ({len(records)} programs match the "
              f"committed lockfile)")


if __name__ == "__main__":
    sys.exit(main())
