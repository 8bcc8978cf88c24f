"""Configs 3 and 4 at a stage's scale, on a GPU: a user's Keras
InceptionV3 (converted without Keras) behind ``KerasImageFileTransformer``
and behind the ``registerKerasImageUDF`` UDF, over ``--images`` JPEGs.

    python3 tools/keras_stage_probe.py [--images 2048] [--repeats 3]

Run from the root of a checkout on the machine with the card.  The model
is ``chip_smoke.py``'s [keras] model: the committed Keras InceptionV3
config (299x299) with seeded Keras-layout arrays, f32 with TF32 off,
batch 32.  The JPEGs (PIL-written noise, 240-400 pixels a side, seeded)
go into a temporary directory.  In turns, ``--repeats`` times:

- config 3, ``KerasImageFileTransformer`` over the file URIs with
  ``chip_smoke.load_inception_v3`` (PIL decode, resize to 299, Keras'
  "tf" preprocess) on the shared IO pool: pipelined (the default) and
  serial (``SPARKDL_PIPELINE=0``); beside it the loader alone (the
  stage's own loaded-chunk iterator, no engine) and the engine alone
  over the loaded batches;
- config 4, the UDF through ``udf_registry.apply`` over ``readImages`` of
  the directory resized to 299 by ``createResizeImageUDF``: pipelined
  and serial; beside it the UDF's host stages alone: the struct packing
  (``arrowStructsToBatch``), the score matrix to one Python list a row,
  and ``apply``'s Arrow column of those lists; and the decode and resize
  that make its input (set-up, not part of the UDF's rate).

Prints the card's name and power limit, img/s per arrangement (median,
min and max over the repeats), host ms per batch of 32 for each host
stage, checks that pipelined and serial outputs agree bit for bit and
that the garbage file is the one null row, and ends with one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pyarrow as pa
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH = 32


def write_jpegs(directory, n, seed):
    """``n`` PIL-written noise JPEGs and one garbage .jpg; the sorted
    paths and the garbage file's index."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(240, 400, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(directory, f"img_{i:05d}.jpg"), quality=90)
    bad = os.path.join(directory, "img_00040_garbage.jpg")
    with open(bad, "wb") as f:
        f.write(b"this is not a jpeg")
    paths = sorted(os.path.join(directory, p) for p in os.listdir(directory))
    return paths, paths.index(bad)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def summary(rates):
    return dict(median=float(np.median(rates)), min=min(rates),
                max=max(rates), runs=rates)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("keras_stage_probe: no CUDA device is available",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    os.chdir(ROOT)
    import chip_smoke as cs
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.io import (arrowStructsToBatch,
                                            createResizeImageUDF, readImages)
    from sparkdl_tpu_torch.models import keras_import
    from sparkdl_tpu_torch.parallel.engine import get_cached_engine
    from sparkdl_tpu_torch.transformers import KerasImageFileTransformer
    from sparkdl_tpu_torch.udf import registerKerasImageUDF, udf_registry

    with open(cs.KERAS_CONFIG) as f:
        kfile = keras_import.keras_file(
            json.load(f), cs._keras_layers_for("InceptionV3", cs.SEED + 31))
    n = args.images
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_s, (paths, bad) = timed(lambda: write_jpegs(tmp, n, cs.SEED + 53))
        print(f"[probe] {n} JPEGs + 1 garbage file written in {write_s:.1f}s",
              flush=True)
        batches = (n + BATCH - 1) // BATCH

        # config 3
        uris = DataFrame({"uri": paths})
        stage = KerasImageFileTransformer(
            inputCol="uri", outputCol="preds", modelFile=kfile,
            imageLoader=cs.load_inception_v3, batchSize=BATCH)
        stage.transform(uris.limit(BATCH))  # warm: conversion, engine, graph
        eng = get_cached_engine(stage, stage.getModelFunction(),
                                device_batch_size=BATCH)
        rates = {k: [] for k in ("pipelined", "serial", "loader_only",
                                 "engine_only")}
        ref = None
        loaded = None
        for _ in range(args.repeats):
            for mode, knob in (("pipelined", "1"), ("serial", "0")):
                with cs.env_knobs({"SPARKDL_PIPELINE": knob}):
                    s, out = timed(lambda: stage.transform(uris).table.column(
                        "preds").to_pylist())
                rates[mode].append(n / s)
                nulls = [i for i, r in enumerate(out) if r is None]
                if nulls != [bad] or (ref is not None and out != ref):
                    print(f"FAIL: config 3 {mode}: null rows {nulls} (want "
                          f"[{bad}]) or outputs differ from the first run",
                          flush=True)
                    sys.exit(1)
                ref = out if ref is None else ref
            s, loaded = timed(lambda: list(stage._loaded_chunks(uris, BATCH,
                                                                [])))
            rates["loader_only"].append(n / s)
            s, _ = timed(lambda: list(eng.map_batches(iter(loaded))))
            rates["engine_only"].append(n / s)
        one_s, _ = timed(lambda: [cs.load_inception_v3(p)
                                  for p in paths[:64] if p != paths[bad]])
        result["config3"] = {k: summary(v) for k, v in rates.items()}
        result["config3"]["loader_ms_per_image_one_thread"] = one_s / 63 * 1e3
        result["config3"]["loader_ms_per_batch"] = (
            1e3 * BATCH / result["config3"]["loader_only"]["median"])
        del stage, eng, loaded

        # config 4
        dec_s, images = timed(lambda: readImages(tmp))
        resize = createResizeImageUDF([299, 299])
        res_s, images = timed(lambda: images.map_rows(
            lambda r: {"image": resize(r["image"])}))
        registerKerasImageUDF("inceptionV3_udf", kfile,
                              preprocessor=cs.inception_preprocess)
        udf_registry.apply("inceptionV3_udf", images.limit(BATCH), "image",
                           "p")  # warm
        col = images.table.column("image")
        rates = {k: [] for k in ("pipelined", "serial", "pack_only",
                                 "rows_to_lists_only", "lists_to_arrow_only")}
        ref = None
        for _ in range(args.repeats):
            for mode, knob in (("pipelined", "1"), ("serial", "0")):
                with cs.env_knobs({"SPARKDL_PIPELINE": knob}):
                    s, out = timed(lambda: udf_registry.apply(
                        "inceptionV3_udf", images, "image", "preds"
                    ).table.column("preds").to_pylist())
                rates[mode].append(n / s)
                nulls = [i for i, r in enumerate(out) if r is None]
                if nulls != [bad] or (ref is not None and out != ref):
                    print(f"FAIL: config 4 {mode}: null rows {nulls} (want "
                          f"[{bad}]) or outputs differ from the first run",
                          flush=True)
                    sys.exit(1)
                ref = out if ref is None else ref
            s, _ = timed(lambda: arrowStructsToBatch(
                col, 299, 299, channel_order="bgr", compact=True))
            rates["pack_only"].append(n / s)
            # the UDF's output: the score matrix to one Python list a row,
            # then apply()'s Arrow column of those lists
            flat = np.asarray([r if r is not None else [0.0] * 1000
                               for r in ref], np.float32)
            s, rows = timed(flat.tolist)
            rates["rows_to_lists_only"].append(n / s)
            s, _ = timed(lambda: pa.array(rows, type=pa.list_(pa.float32())))
            rates["lists_to_arrow_only"].append(n / s)
        result["config4"] = {k: summary(v) for k, v in rates.items()}
        result["config4"]["pack_ms_per_batch"] = (
            1e3 * BATCH / result["config4"]["pack_only"]["median"])
        for k in ("rows_to_lists", "lists_to_arrow"):
            result["config4"][f"{k}_ms_per_batch"] = (
                1e3 * BATCH / result["config4"][f"{k}_only"]["median"])
        result["config4"]["setup_decode_ms_per_batch"] = dec_s / batches * 1e3
        result["config4"]["setup_resize_ms_per_batch"] = res_s / batches * 1e3

    for cfg, what in (("config3", "KerasImageFileTransformer"),
                      ("config4", "registerKerasImageUDF")):
        for k, v in result[cfg].items():
            if isinstance(v, dict):
                print(f"[probe] {cfg} ({what}) {n} images at 299x299 batch "
                      f"{BATCH}: {k}: img/s median {v['median']:.1f} (min "
                      f"{v['min']:.1f}, max {v['max']:.1f})", flush=True)
            else:
                print(f"[probe] {cfg}: {k} {v:.2f}", flush=True)
    print(json.dumps({"images": n, "batch": BATCH,
                      "cpus": len(os.sched_getaffinity(0)), **result}),
          flush=True)


if __name__ == "__main__":
    main()
