"""Smoke run of the PyTorch/CUDA port (sparkdl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (built
for an H100: the kernels are compiled for sm_90a).  It builds the port's
CUDA kernels from ``sparkdl_tpu_torch/ops/csrc`` with nvcc, holds each
kernel against its plain PyTorch version at the shapes the main path gives
it, then drives the main path — ``DeepImageFeaturizer`` and
``DeepImagePredictor`` with Xception at 299x299, batch 32, seeded random
weights — and checks that it ran through the kernels and agrees with the
model's unfused route.  Any failed phase exits non-zero; without a CUDA
device it exits non-zero before printing any result.

Output: the card's name and power limit first, one line per phase, then
one JSON line with every kernel's numbers, and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 32
N_IMAGES = 64
N_PREDICT = 32
KERNEL_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 outputs: about 2 bf16 steps at |y| ~ 4
MAIN_PATH_REL_TOL = 5e-2                  # fused vs unfused, as the JAX package's tests
PEAK_BF16_FLOPS = 989e12                  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12                      # H100 SXM HBM3

# The shape classes Xception's fused route gives the sepconv kernel at
# 299x299: (H=W, C, F, pre_relu, post_relu, launches per forward).
SEPCONV_SHAPES = [
    (37, 256, 728, True, False, 1),    # block4_sepconv1
    (37, 728, 728, True, False, 1),    # block4_sepconv2
    (19, 728, 728, True, False, 25),   # middle flow (24) + block13_sepconv1
    (19, 728, 1024, True, False, 1),   # block13_sepconv2
    (10, 1024, 1536, False, True, 1),  # block14_sepconv1
    (10, 1536, 2048, False, True, 1),  # block14_sepconv2
]
SEPCONV_PER_FORWARD = sum(s[-1] for s in SEPCONV_SHAPES)  # 30


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps=25, warmup=3):
    """Median device time of ``fn()`` in ms over ``reps`` runs (CUDA events
    around each run, after ``warmup`` runs)."""
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


def phase_build(sepconv):
    t0 = time.perf_counter()
    sepconv.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in sepconv.build_log().splitlines()
             if "registers" in ln]
    print(f"[build] sepconv.cu built+loaded in {build_s:.2f}s; "
          f"ptxas: {ptxas[0] if ptxas else 'n/a (library was cached)'}",
          flush=True)


def phase_kernels(sepconv):
    """Kernel vs plain version at each shape class; returns the kernel's
    JSON entry (per-forward totals over the shape classes)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    rows, worst = [], 0.0
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  ops_ms=0.0, bytes_ms=0.0)
    for hw, c, f, pre, post, per_fwd in SEPCONV_SHAPES:
        n = BATCH
        x = torch.randn(n, hw, hw, c, device=dev, generator=g).bfloat16()
        dwk = (torch.randn(3, 3, c, device=dev, generator=g) / 3).bfloat16()
        pw = (torch.randn(c, f, device=dev, generator=g) / math.sqrt(c)
              ).bfloat16()
        scale = torch.rand(f, device=dev, generator=g) * 0.4 + 0.8
        shift = torch.randn(f, device=dev, generator=g) * 0.05

        out = sepconv._fused_sepconv_cuda(x, dwk, pw, scale, shift, pre, post)
        torch.cuda.synchronize()
        ref = sepconv.sepconv_reference(x, dwk, pw, scale, shift, pre, post)
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(),
              f"kernel output not finite at {(hw, c, f)}")
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        bad = (err > KERNEL_TOL["atol"]
               + KERNEL_TOL["rtol"] * ref.float().abs()).sum().item()
        check(bad == 0, f"kernel disagrees with plain version at "
                        f"{(hw, c, f)}: {bad} elements, max abs {max_abs}")
        worst = max(worst, max_abs)

        # library yardstick: cuDNN depthwise + 1x1 conv + affine (bf16)
        xc = x.permute(0, 3, 1, 2)
        dw_w = dwk.permute(2, 0, 1).reshape(c, 1, 3, 3).contiguous(
            memory_format=torch.channels_last)
        pw_w = pw.t().reshape(f, c, 1, 1).contiguous(
            memory_format=torch.channels_last)
        s_b = scale.bfloat16().reshape(1, f, 1, 1)
        t_b = shift.bfloat16().reshape(1, f, 1, 1)

        def library():
            y = F.conv2d(torch.relu(xc) if pre else xc, dw_w, padding=1,
                         groups=c)
            y = F.conv2d(y, pw_w) * s_b + t_b
            return torch.relu(y) if post else y

        k_ms = cuda_ms(lambda: sepconv._fused_sepconv_cuda(
            x, dwk, pw, scale, shift, pre, post))
        p_ms = cuda_ms(lambda: sepconv.sepconv_reference(
            x, dwk, pw, scale, shift, pre, post))
        l_ms = cuda_ms(library)
        flops = 2.0 * n * hw * hw * c * (9 + f)
        nbytes = 2.0 * (n * hw * hw * (c + f) + 9 * c + c * f) + 8.0 * f
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows.append(dict(shape=[n, hw, hw, c, f], pre_relu=pre,
                         post_relu=post, launches_per_forward=per_fwd,
                         max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=bound, bound_by=bound_by))
        print(f"[kernel] sepconv N={n} {hw}x{hw} C={c} F={f} "
              f"pre={int(pre)} post={int(post)}: max_abs_err={max_abs:.5f} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={l_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
              f"-> {bound / k_ms:.1%} of bound", flush=True)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", bound), ("ops_ms", ops_ms),
                       ("bytes_ms", bytes_ms)):
            totals[key] += per_fwd * v
    return {
        "name": "fused_sepconv",
        "route": "cuda",
        "source": "sparkdl_tpu_torch/ops/csrc/sepconv.cu",
        "replaces": "sparkdl_tpu/ops/sepconv.py:143",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst,
        # ms / plain_ms / library_ms / bound_ms: one forward's launches
        # at batch 32, summed over the shape classes (per class in "shapes")
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if totals["ops_ms"] >= totals["bytes_ms"]
                     else "bytes"),
        "library_ms": totals["library_ms"],
        "shapes": rows,
    }


def synthetic_frame(n, seed):
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 299, 299, 3), dtype=np.uint8)
    return DataFrame(structsToArrow(
        [imageArrayToStruct(im, origin=f"synthetic_{i}")
         for i, im in enumerate(imgs)]))


def phase_main_path(sepconv):
    """Featurize 64 and predict 32 synthetic 299x299 images through the
    user entry points; returns the kernel's launch count of that run."""
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image as ni

    df = synthetic_frame(N_IMAGES, SEED)
    feat = ni.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                  modelName="Xception", batchSize=BATCH)
    pred = ni.DeepImagePredictor(inputCol="image", outputCol="preds",
                                 modelName="Xception", decodePredictions=True,
                                 topK=5, batchSize=BATCH)
    # warm-up: builds the engines (weights to the card) and cuDNN plans
    feat.transform(df.limit(BATCH))
    pred.transform(df.limit(N_PREDICT))
    torch.cuda.synchronize()

    sepconv.fused_sepconv.launches = 0
    t0 = time.perf_counter()
    out = feat.transform(df)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pout = pred.transform(df.limit(N_PREDICT))
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    launches = sepconv.fused_sepconv.launches

    feats = out.column_to_numpy("features")
    check(feats.shape == (N_IMAGES, 2048), f"feature shape {feats.shape}")
    check(np.isfinite(feats).all(), "features not finite")
    batches = N_IMAGES // BATCH + N_PREDICT // BATCH
    check(launches == SEPCONV_PER_FORWARD * batches,
          f"sepconv launches {launches}, want {SEPCONV_PER_FORWARD} per "
          f"batch x {batches}")
    preds = pout.table.column("preds").to_pylist()
    check(len(preds) == N_PREDICT and all(len(r) == 5 for r in preds),
          "predictor did not return top-5 rows")
    for r in preds:
        p = [e["probability"] for e in r]
        check(all(math.isfinite(v) for v in p) and p == sorted(p, reverse=True),
              "predictor probabilities not finite and sorted")
    print(f"[main] DeepImageFeaturizer Xception 299x299 batch {BATCH}: "
          f"{N_IMAGES} images in {feat_s:.3f}s = {N_IMAGES / feat_s:.1f} img/s; "
          f"DeepImagePredictor top-5: {N_PREDICT} images in {pred_s:.3f}s = "
          f"{N_PREDICT / pred_s:.1f} img/s; sepconv launches {launches} "
          f"({batches} batches)", flush=True)

    # the same model's unfused route on the card, same uint8 batches
    batch, ok = arrowStructsToBatch(df.table.column("image"), 299, 299)
    check(ok.all(), "synthetic images failed to decode")
    module = ni._cached_model("Xception")
    fused_eng = ni._zoo_engine("Xception", True, BATCH)
    plain_eng = InferenceEngine(ni.zoo_model_fn("Xception", True), module,
                                device="cuda", device_batch_size=BATCH)
    plain_eng.module.fused_inference = False
    want = plain_eng(batch)
    rel = float(np.linalg.norm(feats - want) / np.linalg.norm(want))
    check(rel <= MAIN_PATH_REL_TOL,
          f"fused vs unfused features: rel err {rel:.4g} > {MAIN_PATH_REL_TOL}")
    piece = batch[:BATCH]
    fused_ms = cuda_ms(lambda: fused_eng.run_padded(piece), reps=10)
    plain_ms = cuda_ms(lambda: plain_eng.run_padded(piece), reps=10)
    print(f"[main] fused vs unfused route: ||a-b||/||b|| = {rel:.3e} "
          f"(tol {MAIN_PATH_REL_TOL}); device forward per batch of {BATCH}: "
          f"fused {fused_ms:.2f} ms, unfused {plain_ms:.2f} ms", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.ops import sepconv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # full f32 in the plain and unfused references (see PERF.md)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    check(sparkdl_tpu_torch.resolve_device().type == "cuda",
          "entry points do not default to the card")
    phase_build(sepconv)
    entry = phase_kernels(sepconv)
    entry["launches"] = phase_main_path(sepconv)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
