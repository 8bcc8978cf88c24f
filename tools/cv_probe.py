"""Config 5's CrossValidator run on the card, timed, a few times in one
process.

    python3 /path/to/tools/cv_probe.py LABEL [REPS]

Builds the run as ``chip_smoke.py`` [tuning] step 1 does (the committed
Keras InceptionV3 config with seeded arrays, 48 tinted JPEGs at 299x299,
batch 16, CrossValidator(numFolds=3) over optimizer {adam, sgd} x
fitParams {1 epoch, 2 epochs}), f32 with TF32 off, and prints one JSON
line a repetition: wall s (fit, evaluation and the best model's
transform), the fits' s and img/s, and each fit's s and step mode.  The
first repetition pays the process's cold start.  It imports
``chip_smoke`` and the package from the working directory, so running it
from the roots of two checkouts, alternating, compares two commits in one
call.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def main():
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as c
    from sparkdl_tpu_torch.estimators import (
        CrossValidator, KerasImageFileEstimator,
        MulticlassClassificationEvaluator, ParamGridBuilder)
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import keras_import

    label = sys.argv[1]
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    with open(c.KERAS_CONFIG) as f:
        config = json.load(f)
    kfile = keras_import.keras_file(
        config, c._keras_layers_for("InceptionV3", c.SEED + 31))
    mf = ModelFunction.from_keras(kfile)
    with tempfile.TemporaryDirectory() as tmp:
        paths, labels = c._tuning_files(os.path.join(tmp, "images"))
        onehot = np.eye(1000, dtype=np.float32)
        df = DataFrame({"uri": paths, "label": labels,
                        "onehot": [onehot[v].tolist() for v in labels]})
        for rep in range(reps):
            est = KerasImageFileEstimator(
                inputCol="uri", outputCol="preds", labelCol="onehot",
                modelFile=kfile, imageLoader=c.load_inception_v3,
                kerasLoss="categorical_crossentropy",
                batchSize=c.TUNING_BATCH)
            est._set(modelFunction=mf)  # the KerasFile converted once
            grid = (ParamGridBuilder()
                    .addGrid(est.optimizer, ["adam", "sgd"])
                    .addGrid(est.fitParams, [{"epochs": 1}, {"epochs": 2}])
                    .build())
            evaluator = MulticlassClassificationEvaluator(
                labelCol="label", predictionCol="preds")
            with c._FitLog() as log:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cv = CrossValidator(estimator=est, estimatorParamMaps=grid,
                                    evaluator=evaluator, numFolds=3).fit(df)
                preds = cv.transform(df).column_to_numpy("preds")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            fit_s = sum(f["seconds"] for f in log.fits)
            images = sum(f["images"] for f in log.fits)
            print(json.dumps(dict(
                label=label, rep=rep, wall_s=wall, fit_s=fit_s,
                fit_img_s=images / fit_s, fits=len(log.fits),
                finite=bool(np.isfinite(preds).all()),
                per_fit_s=[f["seconds"] for f in log.fits],
                modes=[f.get("mode") for f in log.fits])), flush=True)


if __name__ == "__main__":
    main()
