"""Where tracing's time goes in one engine call of the served Xception.

    python3 tools/obs_overhead_probe.py [--calls 300] [--rounds 2]

Runs on the card.  First the host cost of one span, ``--spans`` spans
a mode, in each of the tracer's modes: ``off`` (neither ``SPARKDL_TRACE``
nor a profiler: the null span), ``profiled`` (a ``torch.profiler``
collecting, on the thread that started it: the ring and a range),
``profiled_other`` (the same profiler, on another thread: the ring only)
and ``traced`` (``SPARKDL_TRACE`` on); one line of host us a span each.

Then builds ``Server("Xception", featurize=True, max_batch_size=32)`` at
299x299 (f32, TF32 off), captures its buckets, and times ``engine(x)`` of
its bucket-8 engine on one image (what a 1-client request dispatches) in
four modes, ``--calls`` calls a block, in the order off, spans, events,
profiled, profiled, events, spans, off (``--rounds`` times):

* ``off``: tracing disabled;
* ``spans``: tracing on with the engine's timing events switched off
  (``engine._timing_event`` returns None), so only the spans' cost shows;
* ``events``: tracing on, as served: spans and a pair of timing events
  around each replay;
* ``profiled``: tracing off, a ``torch.profiler`` collecting CPU and CUDA
  activity over the block: the profiler's cost and its spans'.

Prints, per mode, the median and mean host ms a call (the call returns host
rows, so it includes the device's work) and the median ``device_ms`` the
events read; then one JSON line with every block.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--spans", type=int, default=20000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("obs_overhead_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch.profiler import ProfilerActivity, profile

    from sparkdl_tpu_torch.obs import trace
    from sparkdl_tpu_torch.parallel import engine as engine_mod
    from sparkdl_tpu_torch.serving import Server

    def profiled():
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def span_us(tracer):
        t0 = time.perf_counter()
        for _ in range(args.spans):
            with tracer.span("probe.span", rows=64):
                pass
        return (time.perf_counter() - t0) / args.spans * 1e6

    costs = {}
    for mode in ("off", "profiled", "profiled_other", "traced"):
        tracer = trace.configure(enabled=mode == "traced")
        span_us(tracer)  # warm
        ctx = profiled() if mode.startswith("profiled") else \
            contextlib.nullcontext()
        with ctx:
            if mode == "profiled_other":
                box = []
                t = threading.Thread(target=lambda: box.append(
                    span_us(tracer)))
                t.start()
                t.join()
                costs[mode] = box[0]
            else:
                costs[mode] = span_us(tracer)
        print(f"span {mode:>14}: {costs[mode]:.3f} us of host a span",
              flush=True)

    img = np.random.default_rng(0).integers(0, 256, (1, 299, 299, 3),
                                            dtype=np.uint8)
    srv = Server("Xception", featurize=True, max_batch_size=32,
                 cache=False, cost=False)
    srv.warmup(img[0])
    eng = srv._engine_for(8)
    real_event = engine_mod._timing_event

    def block(mode):
        engine_mod._timing_event = (real_event if mode != "spans"
                                    else (lambda stream: None))
        tracer = trace.configure(enabled=mode in ("spans", "events"))
        times = []
        with profiled() if mode == "profiled" else contextlib.nullcontext():
            for _ in range(args.calls):
                t0 = time.perf_counter()
                eng(img)
                times.append(time.perf_counter() - t0)
        dev = [s["attrs"]["device_ms"] for s in tracer.snapshot()
               if s["name"] == "engine.call"
               and "device_ms" in (s.get("attrs") or {})]
        return dict(mode=mode, median_ms=float(np.median(times) * 1e3),
                    mean_ms=float(np.mean(times) * 1e3),
                    device_ms=float(np.median(dev)) if dev else None)

    for _ in range(20):
        eng(img)
    blocks = []
    order = ["off", "spans", "events", "profiled", "profiled", "events",
             "spans", "off"]
    for _ in range(args.rounds):
        for mode in order:
            blocks.append(block(mode))
    engine_mod._timing_event = real_event
    trace.configure(enabled=False)
    srv.close()
    for mode in ("off", "spans", "events", "profiled"):
        bs = [b for b in blocks if b["mode"] == mode]
        dev = [b["device_ms"] for b in bs if b["device_ms"] is not None]
        medians = [b["median_ms"] for b in bs]
        line = (f"{mode:>6}: median {np.median(medians):.4f} ms a call "
                f"(blocks {', '.join(f'{m:.4f}' for m in medians)}), mean "
                f"{np.mean([b['mean_ms'] for b in bs]):.4f} ms")
        if dev:
            line += f", device_ms {np.median(dev):.4f}"
        print(line, flush=True)
    print(json.dumps({"obs_overhead_probe": blocks, "span_us": costs}),
          flush=True)


if __name__ == "__main__":
    main()
