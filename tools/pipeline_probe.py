"""Which arrangement of the featurizer's host stages is fastest, on a GPU.

    python3 tools/pipeline_probe.py [--model MobileNetV2|ResNet50|VGG16|...]
                                    [--batches 64] [--repeats 3]
                                    [--set SPARKDL_MNV2_FUSED=1] [--set ...]

Runs the zoo featurizer's own decode iterator (``_decoded_chunks`` over an
Arrow column of ``--batches`` x 32 synthetic raw image structs at the
model's input size, seeded) into the zoo engine (one captured graph per
forward) in each of these arrangements, in turns, ``--repeats`` times:

- ``serial``: decode on a prefetch thread, pad, upload, replay and fetch
  on the caller's (``SPARKDL_PIPELINE=0``);
- ``pipelined``: the runner's default, decode and pad on its prepare
  thread, upload and replay on its dispatch thread, fetch on its gather
  thread;
- ``stage_in_dispatch``: the runner with the pad moved to the dispatch
  thread (the engine behind a proxy that pads in ``run_padded``);
- ``prefetch_pipelined``: a prefetch thread decodes and feeds the
  runner's prepare thread, which pads;
- ``pipelined_switch_0.5ms``: ``pipelined`` with the interpreter's thread
  switch interval at 0.5 ms instead of 5 ms (a probe of GIL hand-over
  latency, not a setting the library makes);
- ``pipelined_torch_1_thread``: ``pipelined`` with PyTorch's intra-op
  thread pool at one thread (a probe of its workers' spinning);

and, as bounds, the decode alone (no engine) and the engine alone over
batches decoded beforehand (serial and pipelined).  Prints the card's
name and power limit, img/s per arrangement (median, min and max over the
repeats), the decode's wall and thread CPU ms per batch on the thread
that ran it, the process's CPU time over the wall time (cores busy), and
the runner's stage stall summary; checks that every
arrangement's features equal the serial ones bit for bit, and ends with
one JSON line.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 32
SEED = 0


def synthetic_frame(n, size, seed):
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return DataFrame(structsToArrow(
        [imageArrayToStruct(im, origin=f"synthetic_{i}")
         for i, im in enumerate(imgs)]))


class timed_iter:
    """``it``'s items, adding up the wall and the thread CPU seconds each
    ``next`` took on whichever thread pulled it (the decode)."""

    def __init__(self, it):
        self.it = iter(it)
        self.wall = self.cpu = 0.0
        self.n = 0

    def __iter__(self):
        return self

    def __next__(self):
        w0, c0 = time.perf_counter(), time.thread_time()
        try:
            item = next(self.it)
        finally:
            self.wall += time.perf_counter() - w0
            self.cpu += time.thread_time() - c0
        self.n += 1
        return item


class pad_on_dispatch:
    """The engine as the runner sees it, with the pad moved from the
    prepare stage (``_iter_pieces``) to the dispatch stage
    (``run_padded``); one device batch per dispatch."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def _iter_pieces(self, batches):
        b = self.eng.device_batch_size
        for chunk in batches:
            for off in range(0, len(chunk), b):
                piece = chunk[off:off + b]
                yield "plain", len(piece), piece

    def run_padded(self, piece):
        return self.eng.run_padded(self.eng._pad(piece))


class switch_interval:
    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        self.saved = sys.getswitchinterval()
        sys.setswitchinterval(self.seconds)

    def __exit__(self, *exc):
        sys.setswitchinterval(self.saved)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="MobileNetV2")
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KNOB=VALUE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pipeline_probe: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    for kv in args.set:
        k, v = kv.split("=", 1)
        os.environ[k] = v
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.parallel.pipeline import (PipelinedRunner,
                                                     pipeline_stage_summary)
    from sparkdl_tpu_torch.transformers import named_image as ni
    from sparkdl_tpu_torch.utils.metrics import Metrics
    from sparkdl_tpu_torch.utils.prefetch import prefetch_iter

    spec = get_model_spec(args.model)
    h, w = spec.input_size
    n = args.batches * BATCH
    df = synthetic_frame(n, h, SEED + 13)
    feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                  modelName=args.model, batchSize=BATCH)
    feat.transform(df.limit(BATCH))  # warm: engine, kernels, graph
    eng = ni._zoo_engine(args.model, True, BATCH)

    timers = []

    def chunks():
        timers.append(timed_iter(feat._decoded_chunks(df, h, w, BATCH, [])))
        return timers[-1]

    decoded = list(chunks())

    def runner(engine=eng):
        m = Metrics()
        return m, lambda src: PipelinedRunner(engine, metrics=m).run(src)

    def serial(src):
        return eng.map_batches(src, pipeline=False)

    def arrangements():
        piped_m, piped = runner()
        disp_m, disp = runner(pad_on_dispatch(eng))
        pre_m, pre = runner()
        sw_m, sw = runner()
        _, alone = runner()

        def switched(src):
            with switch_interval(5e-4):
                yield from sw(src)

        one_m, one_run = runner()

        def one(src):
            saved = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                yield from one_run(src)
            finally:
                torch.set_num_threads(saved)

        return {
            "serial": (None, lambda: serial(prefetch_iter(chunks(), 2))),
            "pipelined": (piped_m, lambda: piped(chunks())),
            "stage_in_dispatch": (disp_m, lambda: disp(chunks())),
            "prefetch_pipelined": (pre_m,
                                   lambda: pre(prefetch_iter(chunks(), 2))),
            "pipelined_switch_0.5ms": (sw_m, lambda: switched(chunks())),
            "pipelined_torch_1_thread": (one_m, lambda: one(chunks())),
            "decode_only": (None, lambda: ([len(c)] for c in chunks())),
            "engine_only_serial": (None, lambda: serial(iter(decoded))),
            "engine_only_pipelined": (None,
                                      lambda: alone(iter(decoded))),
        }

    arr = arrangements()
    rates = {k: [] for k in arr}
    host = {k: [] for k in arr}  # (decode wall, decode cpu, cores busy)
    ref = None
    for _ in range(args.repeats):
        for name, (_, run) in arr.items():
            del timers[:]
            t0, p0 = time.perf_counter(), time.process_time()
            outs = list(run())
            wall = time.perf_counter() - t0
            rates[name].append(n / wall)
            batches = sum(t.n for t in timers) or 1
            host[name].append((sum(t.wall for t in timers) / batches,
                               sum(t.cpu for t in timers) / batches,
                               (time.process_time() - p0) / wall))
            if name == "decode_only":
                continue
            mat = np.concatenate(outs, axis=0)
            if ref is None:
                ref = mat
            if mat.shape != (n, spec.feature_size) or not np.array_equal(
                    mat, ref):
                print(f"FAIL: {name} features differ from serial's",
                      flush=True)
                sys.exit(1)
    result = {}
    for name, (m, _) in arr.items():
        r = rates[name]
        dec_wall, dec_cpu, cores = (float(np.median(v)) * f for v, f in
                                    zip(zip(*host[name]), (1e3, 1e3, 1)))
        result[name] = dict(median=float(np.median(r)), min=min(r),
                            max=max(r), runs=r, decode_wall_ms=dec_wall,
                            decode_cpu_ms=dec_cpu, cores_busy=cores)
        stages = pipeline_stage_summary(m) if m is not None else {}
        if stages:
            result[name]["stages"] = stages
        print(f"[probe] {args.model} {h}x{w} {n} images: {name}: img/s "
              f"median {np.median(r):.1f} (min {min(r):.1f}, max "
              f"{max(r):.1f}); decode per batch {dec_wall:.2f} ms wall, "
              f"{dec_cpu:.2f} ms CPU; process CPU {cores:.2f} cores"
              f"{'; stages ' + str(stages) if stages else ''}", flush=True)
    print(json.dumps({"model": args.model, "knobs": args.set, "images": n,
                      "cpus": len(os.sched_getaffinity(0)),
                      "torch_threads": torch.get_num_threads(),
                      "img_s": result}), flush=True)


if __name__ == "__main__":
    main()
