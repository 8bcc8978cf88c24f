"""Where a cell's card waits: one traced window of the cell (its driver
under the profiler, as a ``--trace 1`` run has it, without the output
check), its idle device seconds charged to the program's spans, one JSON
line a seed.

    python3 bench_port/tools/idle_split.py --workload xception-predict-b64 \\
        --seeds 11,12

Each line gives the window's and the idle seconds, the idle split of the
metrics (``pack``, ``column``, ``engine``, ``unnamed``; ``lib/spans.py``),
a finer split (each engine span, then the runner's and the stage's outer
spans for what the first leaves unnamed), the ``stage.pack`` spans of a
full batch inside the window (count, mean, median, shortest, longest ms),
the count and mean ms of each leaf span inside the window, and how many
anchors lined the ring up with the trace, and their spread.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]

OUTER = ("pipeline.prepare", "pipeline.dispatch", "pipeline.gather",
         "engine.dispatch", "pipeline.run", "stage.transform")


def split(window) -> dict:
    """The idle split of one traced window (None where the ring and the
    trace do not line up)."""
    from bench_port.lib import spans

    aligned = spans.window_aligned(window)
    if aligned is None:
        return {"aligned": False}
    tr = window.trace
    fine = ([(label, names) for label, names in spans.CHARGE[:2]]
            + [(name, (name,)) for name in spans.ENGINE_LEAVES]
            + [(name, (name,)) for name in OUTER])
    rows = window.params.get("batch_size")
    packs = sorted((b - a) * 1e3 for a, b, name, _, r in aligned.spans
                   if name == spans.PACK and r == rows and a >= 0.0
                   and b <= aligned.window_s)
    leaves = {}
    for name in ("stage.pack", "stage.column") + spans.ENGINE_LEAVES:
        ms = [(b - a) * 1e3 for a, b, n, _, _ in aligned.spans
              if n == name and a >= 0.0 and b <= aligned.window_s]
        if ms:
            leaves[name] = {"count": len(ms), "mean": statistics.fmean(ms)}
    return {
        "aligned": True, "pairs": aligned.pairs,
        "offset_spread_us": aligned.spread_s * 1e6,
        "window_s": tr.window_s, "busy_s": tr.busy_s(),
        "idle_s": spans.charge(tr, aligned),
        "idle_s_fine": spans.charge(tr, aligned, fine),
        "pack_ms": ({"count": len(packs), "mean": statistics.fmean(packs),
                     "median": statistics.median(packs),
                     "min": packs[0], "max": packs[-1]} if packs else None),
        "span_ms": leaves,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default=None,
                    help="a device name, skipping the look for the cards")
    ap.add_argument("--overrides", default=None,
                    help="JSON object of the cell's parameters to replace")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench_port.lib import harness
    from sparkdl_tpu_torch.obs.trace import get_tracer

    overrides = json.loads(args.overrides) if args.overrides else None
    for seed in (int(s) for s in args.seeds.split(",")):
        get_tracer().clear()
        # the window is the mix's trace_seconds, as in a traced run
        run = harness.prepare(ROOT, args.workload, seed, 1e9, True,
                              time.monotonic(), args.device, overrides)
        out = harness.driver_of(run).run(run)
        out.window.config, out.window.params = run.config, run.params
        harness.free_program()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": harness.power_limit(),
                          **split(out.window)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
