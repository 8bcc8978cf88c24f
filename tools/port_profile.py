"""Where the time of one Xception forward goes in the PyTorch port, on a GPU.

    python3 tools/port_profile.py [--batch 32]

Builds the port's zoo engine (featurizer cut, seeded random weights) on
the card and reports, for one batch of 299x299 images: the device time of
the forward on the fused and the unfused route, in f32 and in bf16
compute (``SPARKDL_ZOO_COMPUTE_DTYPE=bfloat16``), with cuDNN's TF32 off and
on; then a ``torch.profiler`` table of the fused f32 forward's CUDA time by
kernel.  Prints the card's name and power limit first.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_profile: no CUDA device is available")
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image as ni

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = np.random.default_rng(0).integers(
        0, 256, (args.batch, 299, 299, 3), dtype=np.uint8)
    module = ni._cached_model("Xception")
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        for cdt in (None, torch.bfloat16):
            for fused in (True, False):
                eng = InferenceEngine(
                    ni.zoo_model_fn("Xception", True, compute_dtype=cdt),
                    module, device="cuda", device_batch_size=args.batch,
                    compute_dtype=cdt)
                eng.module.fused_inference = fused
                ms = cuda_ms(lambda: eng.run_padded(batch))
                print(f"forward batch {args.batch}: "
                      f"{'bf16' if cdt else 'f32 '} "
                      f"{'fused  ' if fused else 'unfused'} "
                      f"cudnn.allow_tf32={tf32}: {ms:.2f} ms "
                      f"({args.batch / ms * 1e3:.0f} img/s)", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    eng = InferenceEngine(ni.zoo_model_fn("Xception", True), module,
                          device="cuda", device_batch_size=args.batch)
    eng.run_padded(batch)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_padded(batch)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profiler: fused f32 forward, CUDA self time {total / 1e3:.2f} ms "
          f"over {len(rows)} kernel names")
    for dev_us, count, key in rows[:15]:
        print(f"  {dev_us / 1e3:8.3f} ms {dev_us / total:6.1%} x{count:<4} "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
