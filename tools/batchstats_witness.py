"""Where the card and the CPU part in a ``trainBatchStats`` fit of the
zoo's ResNet50: the same SGD fit (batch 8, optax's sgd at 1e-2,
categorical cross entropy over one-hot labels, seeded random weights) run
as float64 on the CPU (the reference), as float32 on the CPU and as
float32 on the card, one step and two steps, and the float32 runs held to
the float64 one.

    python3 tools/batchstats_witness.py [--size 224] [--out FILE]

Run from the root of a checkout; without a card only the CPU runs are
made.  Inputs are seeded tinted images of two classes (per-pixel noise
50), as ``chip_smoke.py``'s [tuning] draws them, in two scales:
``caffe`` (BGR minus the ImageNet mean, the zoo's ResNet50 preprocess)
and ``unit`` (the same divided by 127.5).  Each scale runs with the
port's BatchNorm variance (flax's E[x^2] - mean^2) and with a two-pass
variance mean((x - mean)^2) put in its place.  For each run and step
count it prints the relative error of the fit's update against the
float64 run's, ||d - d64|| / ||d64|| with d = fitted - initial, for the
running statistics and for the parameters, the per-step losses, and the
largest mean^2 / var any BatchNorm saw (what E[x^2] - mean^2 loses in
float32 grows with it).  Last, the caffe-scale fit with each batch's
samples in another order (the same update in exact arithmetic) in
float64 and float32, against the float64 fit.  Ends with one JSON line,
also written to ``--out``.
"""

import argparse
import copy
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sparkdl_tpu_torch import default_device  # noqa: E402
from sparkdl_tpu_torch.estimators import ImageFileEstimator  # noqa: E402
from sparkdl_tpu_torch.graph import function as gfunction  # noqa: E402
from sparkdl_tpu_torch.graph.function import ModelFunction  # noqa: E402
from sparkdl_tpu_torch.models import layers, load_model  # noqa: E402

CAFFE_MEAN_BGR = np.asarray([103.939, 116.779, 123.68], np.float64)
BASES = [(200, 70, 60), (60, 80, 200)]
SEED = 2024

_RATIO = []  # largest mean^2 / var of the BatchNorms in a run


def two_pass_batch_norm_train(bn, x):
    """flax_batch_norm_train with var = mean((x - mean)^2)."""
    x, _ = layers.promote(x, bn.running_mean)
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = x.mean(dim=dims)
    var = ((x - mean.reshape(shape)) ** 2).mean(dim=dims)
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (x - mean.reshape(shape)) * mul.reshape(shape)
    if bn.bias is not None:
        y = y + bn.bias.reshape(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(m * mean.detach())
        bn.running_var.mul_(1.0 - m).add_(m * var.detach())
    _note(mean, var)
    return y


_FLAX = layers.flax_batch_norm_train


def flax_recorded(bn, x):
    y = _FLAX(bn, x)
    xs = layers.promote(x, bn.running_mean)[0].detach()
    dims = [d for d in range(xs.dim()) if d != 1]
    _note(xs.mean(dim=dims), xs.var(dim=dims, unbiased=False))
    return y


def _note(mean, var):
    with torch.no_grad():
        r = float((mean.double() ** 2 / (var.double() + 1e-12)).max())
    _RATIO.append(r)


def set_variance(kind):
    fn = flax_recorded if kind == "flax" else two_pass_batch_norm_train
    layers.flax_batch_norm_train = fn
    gfunction.flax_batch_norm_train = fn


def images(n, size, seed):
    """n seeded tinted images, half of each class, as float64 BGR minus
    the ImageNet mean [n, size, size, 3], and one-hot labels [n, 1000]."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, size, size, 3), np.float64)
    y = np.zeros((n, 1000), np.float64)
    for i in range(n):
        c = i % 2
        px = np.clip(np.asarray(BASES[c], np.float64)
                     + rng.normal(0.0, 50.0, (size, size, 3)), 0, 255)
        x[i] = np.round(px)[..., ::-1] - CAFFE_MEAN_BGR
        y[i, c] = 1.0
    return x, y


def fit(module, x, y, where, dtype):
    """One trainBatchStats fit of 1 epoch at batch 8; returns (state
    dict as float64 host arrays, per-epoch losses)."""
    m = copy.deepcopy(module).to(dtype)
    est = ImageFileEstimator(
        inputCol="uri", outputCol="preds", labelCol="onehot",
        modelFunction=ModelFunction.from_module(m),
        imageLoader=lambda u: None, optimizer="sgd", batchSize=8,
        trainBatchStats=True, fitParams={"epochs": 1, "shuffle": False})
    npdt = np.float64 if dtype == torch.float64 else np.float32
    if where == "cpu":
        with default_device("cpu"):
            fitted = est._fit_on_arrays(x.astype(npdt), y.astype(npdt))
    else:
        fitted = est._fit_on_arrays(x.astype(npdt), y.astype(npdt))
    sd = fitted.getModelFunction().module.state_dict()
    return ({k: v.double().numpy() for k, v in sd.items()
             if v.is_floating_point()}, fitted.trainLosses)


def update_rel(a, ref, init, keys):
    num = sum(float(((a[k] - ref[k]) ** 2).sum()) for k in keys)
    den = sum(float(((ref[k] - init[k]) ** 2).sum()) for k in keys)
    return math.sqrt(num / den) if den else float("nan")


def worst_key(a, ref, init, keys):
    def rel(k):
        d = ref[k] - init[k]
        den = float(np.linalg.norm(d)) or 1.0
        return float(np.linalg.norm(a[k] - ref[k])) / den
    k = max(keys, key=rel)
    return k, rel(k)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    card = torch.cuda.is_available()
    if card:
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    resnet = load_model("ResNet50", weights=None)
    init = {k: v.double().numpy() for k, v in resnet.state_dict().items()
            if v.is_floating_point()}
    stat_keys = [k for k in init
                 if k.endswith(("running_mean", "running_var"))]
    param_keys = [n for n, _ in resnet.named_parameters()]
    x_all, y_all = images(16, args.size, SEED)
    runs = [("cpu", torch.float64), ("cpu", torch.float32)]
    if card:
        runs.append(("card", torch.float32))
    rows = []
    for scale in ("caffe", "unit"):
        xs = x_all if scale == "caffe" else x_all / 127.5
        for variance in ("flax", "two_pass"):
            set_variance(variance)
            for steps in (1, 2):
                n = 8 * steps
                res = {}
                for where, dt in runs:
                    _RATIO.clear()
                    sd, losses = fit(resnet, xs[:n], y_all[:n], where, dt)
                    res[(where, dt)] = (sd, losses, max(_RATIO))
                ref = res[("cpu", torch.float64)][0]
                for (where, dt), (sd, losses, ratio) in res.items():
                    if dt == torch.float64:
                        continue
                    wk, wrel = worst_key(sd, ref, init, stat_keys)
                    row = dict(
                        scale=scale, variance=variance, steps=steps,
                        run=f"{where}_f32",
                        stats_rel_vs_f64=update_rel(sd, ref, init,
                                                    stat_keys),
                        params_rel_vs_f64=update_rel(sd, ref, init,
                                                     param_keys),
                        worst_stat=wk, worst_stat_rel=wrel,
                        losses=losses,
                        losses_f64=res[("cpu", torch.float64)][1],
                        max_mean2_over_var=ratio)
                    if where == "card":
                        cpu32 = res[("cpu", torch.float32)][0]
                        row["stats_rel_vs_cpu_f32"] = update_rel(
                            sd, cpu32, init, stat_keys)
                        row["params_rel_vs_cpu_f32"] = update_rel(
                            sd, cpu32, init, param_keys)
                    rows.append(row)
                    print(f"{scale:5s} {variance:8s} {steps} step(s) "
                          f"{where}_f32 vs cpu_f64: statistics "
                          f"{row['stats_rel_vs_f64']:.3e}, parameters "
                          f"{row['params_rel_vs_f64']:.3e}, worst "
                          f"{wk} {wrel:.3e}, max mean^2/var "
                          f"{ratio:.3g}, losses {losses} (f64 "
                          f"{row['losses_f64']})"
                          + (f"; vs cpu_f32: statistics "
                             f"{row['stats_rel_vs_cpu_f32']:.3e}, "
                             f"parameters "
                             f"{row['params_rel_vs_cpu_f32']:.3e}"
                             if where == "card" else ""), flush=True)
    # the same batches with their samples in another order: the same
    # update in exact arithmetic, summed in another order
    set_variance("flax")
    perm = np.concatenate([np.random.default_rng(1).permutation(8) + 8 * i
                           for i in range(2)])
    for steps in (1, 2):
        n = 8 * steps
        ref = fit(resnet, x_all[:n], y_all[:n], "cpu", torch.float64)[0]
        for dt in (torch.float64, torch.float32):
            sd = fit(resnet, x_all[perm[:n]], y_all[perm[:n]], "cpu", dt)[0]
            row = dict(scale="caffe", variance="flax", steps=steps,
                       run=f"cpu_{'f64' if dt == torch.float64 else 'f32'}"
                           "_permuted",
                       stats_rel_vs_f64=update_rel(sd, ref, init, stat_keys),
                       params_rel_vs_f64=update_rel(sd, ref, init,
                                                    param_keys))
            rows.append(row)
            print(f"caffe flax     {steps} step(s) {row['run']} vs cpu_f64: "
                  f"statistics {row['stats_rel_vs_f64']:.3e}, parameters "
                  f"{row['params_rel_vs_f64']:.3e}", flush=True)
    line = json.dumps({"batchstats_witness": rows, "size": args.size})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
