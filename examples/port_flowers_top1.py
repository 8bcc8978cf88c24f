"""Transfer-learning top-1 on a flowers-style dataset (BASELINE.md config 1),
on the PyTorch port.

The port's twin of ``examples/flowers_top1.py``: the reference's README
recipe, a zoo featurizer plus logistic regression on tf_flowers,
end to end.  Given a dataset laid out as ``<root>/<class_name>/*.jpg``
(the tf_flowers archive layout), this script featurizes every image on
the card (decode and resize on the host through ``filesToModelBatch``, a
prefetch thread two chunks ahead, the engine's ``map_batches`` in bf16
compute with the preprocess on the card), fits the port's
``LogisticRegression`` head on a seeded split, and prints one JSON line
with held-out top-1 accuracy.

Usage:
    python examples/port_flowers_top1.py /data/flower_photos \\
        [--model InceptionV3] [--train-ratio 0.8] [--batch-size 128] \\
        [--max-per-class N] [--seed 0] [--device cpu]

Real pretrained weights: set ``SPARKDL_WEIGHTS_DIR`` to a directory
holding the model's Keras file (``inception_v3.weights.h5``, or a
``.h5`` / ``.keras`` full model), the port's air-gapped weight contract
(``sparkdl_tpu_torch/models/__init__.py load_model``).  Without it the
script runs on the zoo's seeded init and says so in ``weights_source``
(random-weight top-1 is only a smoke signal).  It downloads nothing.
Runs on the card unless ``--device cpu``; without a card and without
``--device cpu`` it raises RuntimeError.

Output:
    {"top1": 0.93, "n_train": 2936, "n_test": 734, "classes": 5,
     "model": "InceptionV3", "weights_source": "...", "seconds": ...,
     "featurize_s": ..., "featurize_img_s": ..., "device": "cuda",
     "dispatches": ..., "graph_captures": ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gather_files(root: str, max_per_class: int | None):
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and not d.startswith("."))
    if not classes:
        raise SystemExit(f"No class subdirectories under {root}")
    files, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        names = sorted(
            f for f in os.listdir(cdir)
            if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if max_per_class:
            names = names[:max_per_class]
        for f in names:
            files.append(os.path.join(cdir, f))
            labels.append(ci)
    return files, np.asarray(labels), classes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="dataset root: <root>/<class>/*.jpg")
    ap.add_argument("--model", default="InceptionV3")
    ap.add_argument("--train-ratio", type=float, default=0.8)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-per-class", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sparkdl_tpu_torch import default_device, resolve_device

    device = resolve_device(args.device)
    with default_device(device):
        return _run(args, device)


def _run(args, device) -> dict:
    import torch

    from sparkdl_tpu_torch.estimators import LogisticRegression
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.io import filesToModelBatch
    from sparkdl_tpu_torch.models import get_model_spec, load_model
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers.named_image import zoo_model_fn
    from sparkdl_tpu_torch.utils.prefetch import prefetch_iter

    t0 = time.perf_counter()
    files, labels, classes = gather_files(args.root, args.max_per_class)
    spec = get_model_spec(args.model)
    h, w = spec.input_size

    wdir = os.environ.get("SPARKDL_WEIGHTS_DIR")
    weights_source = (f"SPARKDL_WEIGHTS_DIR={wdir}"
                      if wdir and spec.resolve_weights("imagenet")
                      != "imagenet" else
                      "seeded init (no weights file in SPARKDL_WEIGHTS_DIR)")

    # Featurize everything: streaming decode -> the featurizer on the card
    module = load_model(spec.name)
    eng = InferenceEngine(
        zoo_model_fn(spec.name, True, compute_dtype=torch.bfloat16), module,
        device=device, device_batch_size=args.batch_size,
        compute_dtype=torch.bfloat16, output_host_dtype=np.float32)

    def chunks():
        for off in range(0, len(files), eng.device_batch_size):
            batch, ok = filesToModelBatch(
                files[off:off + eng.device_batch_size], h, w)
            if not ok.all():
                bad = [files[off + i] for i in np.nonzero(~ok)[0]]
                print(f"warning: {len(bad)} undecodable files (first: "
                      f"{bad[0]})", file=sys.stderr)
            yield batch

    t1 = time.perf_counter()
    feats = np.concatenate(
        list(eng.map_batches(prefetch_iter(chunks(), depth=2))), axis=0)
    featurize_s = time.perf_counter() - t1

    # Split and fit the head (the reference used Spark ML
    # LogisticRegression on the driver; the port's trains on the device).
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(files))
    cut = int(len(files) * args.train_ratio)
    tr, te = order[:cut], order[cut:]
    train_df = DataFrame({"features": [feats[i].tolist() for i in tr],
                          "label": labels[tr].tolist()})
    test_df = DataFrame({"features": [feats[i].tolist() for i in te],
                         "label": labels[te].tolist()})
    lr = LogisticRegression(featuresCol="features", labelCol="label",
                            maxIter=100, learningRate=0.05, batchSize=256,
                            seed=args.seed)
    model = lr.fit(train_df)
    rows = model.transform(test_df).collect()
    y = np.asarray([r["label"] for r in rows])
    p = np.asarray([r["prediction"] for r in rows])
    counters = eng.metrics.counters
    out = {
        "top1": round(float((y == p).mean()), 4),
        "n_train": int(len(tr)), "n_test": int(len(te)),
        "classes": len(classes), "model": spec.name,
        "weights_source": weights_source,
        "seconds": round(time.perf_counter() - t0, 1),
        "featurize_s": featurize_s,
        "featurize_img_s": len(files) / featurize_s,
        "device": str(device),
        "dispatches": -(-len(files) // eng.device_batch_size),
        "graph_captures": int(counters.get("engine.graph_captures", 0)),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
