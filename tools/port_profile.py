"""Where the time of one zoo forward goes in the PyTorch port, on a GPU.

    python3 tools/port_profile.py [--model Xception|MobileNetV2|InceptionV3|
                                           ResNet50|VGG16|EfficientNetB0|...]
                                  [--batch 32] [--eager]
                                  [--set SPARKDL_XC_TILED=1] [--set ...]

Builds the port's zoo model (featurizer cut, seeded random weights, the
build variant the ``--set`` environment knobs select, e.g.
``SPARKDL_MNV2_FUSED=1``, ``SPARKDL_XC_TILED=1`` or
``SPARKDL_S2D_STEM=1``) on the card and reports, for one batch at the
model's input size: the time of the forward (CUDA events around the
engine's ``run_padded`` of a batch already in pinned host memory, so the
upload and the host's enqueue gaps count) as the engine runs it, one
captured CUDA graph per forward (``--eager``: op by op, the engine's
``capture=False``), on the fused and the unfused route (the model's
``fused_inference``; for InceptionV3 its fused branch heads against the
per-branch convs, for ResNet its fused shortcut; VGG and EfficientNetB0
have one route), in f32 and in bf16 compute
(``SPARKDL_ZOO_COMPUTE_DTYPE=bfloat16``), with cuDNN's TF32 off and on;
then a ``torch.profiler`` table of the forward's device time by kernel,
its launch count, the wall time of the forward and the share of it the
device was busy, for each route in f32 with TF32 off and for the fused
route with TF32 on and in bf16.  Prints the card's
name and power limit first, and the forward's floating-point operations
per image (``torch.utils.flop_counter`` over one forward on the meta
device: 2 per multiply-add of the convs and matmuls).  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps=10, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_forward(eng, batch, label):
    """Profiler table of one forward: device time by kernel name (device
    events only: an aten op's row would count its kernels twice), the
    forward's wall time under the profiler and the device's busy share of
    it (kernels on one stream do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.run_padded(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_padded(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # "Activity Buffer Request" is the profiler's own bookkeeping
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Activity"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profiler: {label} forward, device time {total / 1e3:.2f} ms "
          f"over {len(rows)} kernel names ({launches} launches); wall time "
          f"{wall_ms:.2f} ms under the profiler, device busy "
          f"{total / 1e3 / wall_ms:.0%} of it")
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3:8.3f} ms {dev_us / total:6.1%} x{count:<4} "
              f"{key[:90]}")


def forward_flops(spec, h, w):
    """FLOP of one image's featurizer forward, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        module = spec.build().eval()
        # the plain route: the same function, and the kernels have no meta
        # implementation
        module.fused_inference = False
        with FlopCounterMode(display=False) as counter:
            module(torch.empty(1, h, w, 3), features=True)
    return counter.get_total_flops()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="Xception")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eager", action="store_true",
                    help="run the forward op by op, not as a CUDA graph")
    ap.add_argument("--set", action="append", default=[], metavar="KNOB=VALUE",
                    help="environment knob for the model's build variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_profile: no CUDA device is available")
    for kv in args.set:
        knob, _, value = kv.partition("=")
        os.environ[knob] = value
    from sparkdl_tpu_torch.models import get_model_spec, model_variant_key
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image as ni

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    spec = get_model_spec(args.model)
    h, w = spec.input_size
    print(f"{spec.name} {h}x{w} batch {args.batch}, "
          f"{'eager' if args.eager else 'graphed'} forward, build variant "
          f"{model_variant_key(spec.name)!r}, "
          f"{forward_flops(spec, h, w) / 1e9:.3f} GFLOP per image")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = np.random.default_rng(0).integers(
        0, 256, (args.batch, h, w, 3), dtype=np.uint8)
    module = ni._cached_model(spec.name)

    # the model's routes: fused and unfused where it has a route toggle,
    # else its one route (None)
    routes = (True, False) if hasattr(module, "fused_inference") else (None,)

    def engine(cdt, fused):
        eng = InferenceEngine(
            ni.zoo_model_fn(spec.name, True, compute_dtype=cdt), module,
            device="cuda", device_batch_size=args.batch, compute_dtype=cdt,
            capture=not args.eager)
        if fused is not None:
            eng.module.fused_inference = fused
        return eng, eng._pad(batch)  # the batch in a pinned buffer

    def route(fused):
        return {True: "fused", False: "unfused", None: "plain"}[fused]

    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        for cdt in (None, torch.bfloat16):
            for fused in routes:
                eng, staged = engine(cdt, fused)
                ms = cuda_ms(lambda: eng.run_padded(staged))
                print(f"forward batch {args.batch}: "
                      f"{'bf16' if cdt else 'f32 '} {route(fused):7} "
                      f"cudnn.allow_tf32={tf32}: {ms:.2f} ms "
                      f"({args.batch / ms * 1e3:.0f} img/s)", flush=True)

    bf16 = torch.bfloat16
    for cdt, fused, tf32 in ((None, routes[0], False), (None, False, False),
                             (None, routes[0], True), (bf16, routes[0], False)):
        if fused is False and len(routes) == 1:
            continue
        torch.backends.cudnn.allow_tf32 = tf32
        profile_forward(*engine(cdt, fused),
                        f"{route(fused)} {'bf16' if cdt else 'f32'}"
                        f"{', TF32 on' if tf32 else ''}")
    torch.backends.cudnn.allow_tf32 = False


if __name__ == "__main__":
    main()
