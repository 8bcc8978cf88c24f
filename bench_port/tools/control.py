"""The output check's control at a cell's own size: the plain reference
computed in float8 (e4m3, one scale a tensor, for every conv and dense
operand) put in the program's place, on the cell's inputs, and judged by
the harness's own check against the float32 reference, one line per seed.

    python3 bench_port/tools/control.py --workload xception-predict-b64 \\
        --seeds 11,12,13

Each line gives the verdict (``correct`` has to come out false) and the
numbers compared beside their limits.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def control_verdict(run):
    """(checks, rows compared, correct) of the control's rows, every
    input of the cell's frame answered by the reference in float8, judged
    as a run's answers are."""
    from bench_port.lib import harness
    from bench_port.reference.common import fp8_e4m3

    images = harness.driver_of(run).reference_inputs(run)
    rows = harness.reference_rows(run, images, quant=fp8_e4m3)
    out = harness.Outcome(
        setup_s=0.0, end_to_end={}, attempted=len(images), failed=0,
        window=harness.Window(seconds=0.0), memory_peak_bytes=0,
        inputs=images, answers=[(np.arange(len(images)), rows)],
        exact={"misplaced_rows": 0})
    checks, compared = harness.judge(run, out)
    return checks, compared, harness.verdict(checks, compared)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from bench_port.lib import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.prepare(ROOT, args.workload, seed, 0.0, False, T0)
        checks, compared, correct = control_verdict(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rows": compared, "correct": correct,
                          "check": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
