"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout.  Sets up the cell
(seeded weights and inputs, warm-up), measures for ``--seconds``
(``--trace 1``: a shorter window under the profiler), checks every output
against the plain reference and prints one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``breakdown`` when traced) and ``check``, the numbers compared
with their limits, which also end standard error.  Exits 3 without the
CUDA devices the cell asks for, and 1 on any failure, printing no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench_port.lib import harness

    try:
        line, err = harness.execute(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace), T0)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        return 1
    sys.stdout.flush()
    for msg in err:
        print(msg, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
