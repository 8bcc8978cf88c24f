"""Where a captured fit's memory goes after the fit, on the card.

    python3 tools/train_pool_probe.py

Builds config 5's model as ``chip_smoke.py`` [train] does (the committed
Keras InceptionV3 config with seeded arrays, 299x299), runs an SGD and an
Adam fit of 6 epochs over 32 seeded rows at batch 16 (12 steps: long
enough to be captured),
and prints the card's segments by memory pool (the default pool and each
CUDA graph's private pool: total and allocated MiB) before the fits,
after each fit, and after ``gc.collect()`` + ``torch.cuda.empty_cache()``.
A fit whose graphs and pool are released leaves no private-pool segment
and the default pool where it was before.  Run from the repo root
(``PYTHONPATH=.``); ~30 s of command.
"""

import gc
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def segments(tag):
    by = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        key = str(tuple(seg.get("segment_pool_id", (0, 0))))
        tot, alloc = by.get(key, (0, 0))
        by[key] = (tot + seg["total_size"], alloc + seg["allocated_size"])
    print(f"[pool] {tag}: " + ", ".join(
        f"pool {k}: {t / 2**20:.0f} MiB, {a / 2**20:.0f} allocated"
        for k, (t, a) in sorted(by.items())), flush=True)


def main():
    import chip_smoke as c
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    _, params, predict = c._train_model()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 299, 299, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 2, 32)]
    segments("before the fits")
    for opt in ("sgd", "adam"):
        train.fit_data_parallel(predict, params, x, y,
                                optimizer=NamedOptimizer(opt),
                                loss="categorical_crossentropy",
                                batch_size=16, epochs=6)
        segments(f"after the {opt} fit")
        gc.collect()
        torch.cuda.empty_cache()
        segments(f"after the {opt} fit, gc + empty_cache")


if __name__ == "__main__":
    main()
