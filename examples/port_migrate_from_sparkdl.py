"""Migration tour: spark-deep-learning -> sparkdl_tpu_torch, API by API.

The PyTorch port's twin of ``examples/migrate_from_sparkdl.py``.  Every
section pairs the reference's call (commented, as it appears in the
sparkdl README/docs) with the port's equivalent, and RUNS the equivalent
on synthetic images, so the whole file doubles as an executable smoke of
the migration surface on the card.  Differences that matter are called
out inline; everything else is name for name.  It imports torch and the
port only: no JAX, no Keras, no TensorFlow, no download (the zoo runs on
seeded weights unless ``SPARKDL_WEIGHTS_DIR`` holds the model's file).

Run:  python examples/port_migrate_from_sparkdl.py [--device cpu]
      (on the card unless --device cpu; without a card and without
      --device cpu it raises RuntimeError)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_images(root: str, n: int = 6) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((64, 80, 3)) * 255).astype(np.uint8),
                        "RGB").save(os.path.join(root, f"img_{i}.jpg"))
    with open(os.path.join(root, "broken.jpg"), "wb") as f:
        f.write(b"not an image")  # undecodable rows stay null, as upstream


def _sequential(name, input_shape, layers):
    """A Keras Sequential model's config (Keras 3's form), as
    ``json.loads(model.to_json())`` gives it."""
    return {"class_name": "Sequential", "config": {"name": name, "layers": [
        {"class_name": "InputLayer", "config": {
            "name": "input", "batch_shape": [None, *input_shape]}},
        *layers]}}


def _dense(name, units):
    return {"class_name": "Dense", "config": {
        "name": name, "units": units, "activation": "linear",
        "use_bias": True}}


def _dense_arrays(rng, name, fan_in, units):
    """A Dense layer's weights as Keras stores them: kernel [in, out],
    bias [out]."""
    return (name, "Dense", [
        rng.normal(0, fan_in ** -0.5, (fan_in, units)).astype(np.float32),
        np.zeros(units, np.float32)])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    import sparkdl_tpu_torch

    device = sparkdl_tpu_torch.resolve_device(args.device)
    d = tempfile.mkdtemp(prefix="sparkdl_migration_")
    try:
        with sparkdl_tpu_torch.default_device(device):
            _tour(d, torch)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"migration_smoke": "ok"}))


def _tour(d: str, torch) -> None:
    make_images(d)

    # ------------------------------------------------------------------
    # 1. Reading images
    # reference:
    #   from sparkdl.image import imageIO
    #   df = imageIO.readImagesWithCustomFn(path, decode_f)
    #   df = ImageSchema.readImages(path)        # Spark 2.3 image source
    from sparkdl_tpu_torch.image import readImages

    df = readImages(d)
    rows = df.collect()
    n_null = sum(1 for r in rows if r["image"] is None)
    print(f"readImages: {len(rows)} rows, {n_null} null (bad file)")
    assert len(rows) == 7 and n_null == 1
    # The image struct is the SAME OpenCV-convention schema
    # {origin, height, width, nChannels, mode, data} with BGR bytes.

    # ------------------------------------------------------------------
    # 1b. Row-level image manipulation (resize UDF)
    # reference:
    #   from sparkdl.image.imageIO import createResizeImageUDF
    #   df = df.withColumn("resized", createResizeImageUDF([32, 32])(df.image))
    # Here the same row fn rides DataFrame.map_rows.
    from sparkdl_tpu_torch.image import createResizeImageUDF

    resize = createResizeImageUDF([32, 32])
    resized = df.map_rows(
        lambda r: {"image": r["image"], "resized": resize(r["image"])})
    r0 = next(r for r in resized.collect() if r["resized"] is not None)
    print(f"createResizeImageUDF via map_rows: "
          f"{r0['resized']['height']}x{r0['resized']['width']}")
    assert r0["resized"]["height"] == 32

    # ------------------------------------------------------------------
    # 2. Featurization for transfer learning
    # reference:
    #   from sparkdl import DeepImageFeaturizer
    #   featurizer = DeepImageFeaturizer(inputCol="image",
    #                                    outputCol="features",
    #                                    modelName="InceptionV3")
    #   features_df = featurizer.transform(df)
    from sparkdl_tpu_torch.transformers import DeepImageFeaturizer

    featurizer = DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName="InceptionV3", batchSize=4)
    features_df = featurizer.transform(df)
    feats = [r["features"] for r in features_df.collect()]
    feat = next(f for f in feats if f is not None)
    print(f"DeepImageFeaturizer: {len(feat)}-d features")
    assert len(feat) == 2048 and sum(f is None for f in feats) == 1

    # ------------------------------------------------------------------
    # 3. Prediction with topK decode
    # reference:
    #   from sparkdl import DeepImagePredictor
    #   predictor = DeepImagePredictor(inputCol="image",
    #                                  outputCol="predicted_labels",
    #                                  modelName="InceptionV3",
    #                                  decodePredictions=True, topK=5)
    from sparkdl_tpu_torch.transformers import DeepImagePredictor

    predictor = DeepImagePredictor(inputCol="image",
                                   outputCol="predicted_labels",
                                   modelName="InceptionV3",
                                   decodePredictions=True, topK=5,
                                   batchSize=4)
    preds = next(r["predicted_labels"] for r in
                 predictor.transform(df).collect()
                 if r["predicted_labels"] is not None)
    print(f"DeepImagePredictor topK: {len(preds)} (class, desc, prob) rows")
    assert len(preds) == 5

    # ------------------------------------------------------------------
    # 4. Applying your own model to the image column
    # reference:
    #   from sparkdl import TFImageTransformer
    #   transformer = TFImageTransformer(inputCol="image", outputCol="out",
    #                                    graph=graph, inputTensor=...,
    #                                    outputTensor=..., outputMode="vector")
    # Here the model is ``fn(module, x)`` with the module that holds its
    # tensors, wrapped in a ModelFunction (the GraphDef/session pair's
    # replacement); TF 1.x GraphDefs still load via
    # graph.input.TFInputGraph (section 7).
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.transformers import TFImageTransformer

    class Scale(torch.nn.Module):
        def __init__(self, s):
            super().__init__()
            self.register_buffer("scale", torch.tensor(s))

    mf = ModelFunction(fn=lambda m, x: x.float() * m.scale,
                       module=Scale(1 / 255.0))
    transformer = TFImageTransformer(inputCol="image", outputCol="out",
                                     modelFunction=mf, inputSize=[32, 32],
                                     outputMode="vector", batchSize=4)
    out = next(r["out"] for r in transformer.transform(df).collect()
               if r["out"] is not None)
    print(f"TFImageTransformer: vector of {len(out)}")
    assert len(out) == 32 * 32 * 3

    # ------------------------------------------------------------------
    # 5. Keras models on 1-D float rows / image files
    # reference:
    #   from sparkdl import KerasTransformer, KerasImageFileTransformer
    #   KerasTransformer(inputCol=..., outputCol=..., modelFile="m.h5")
    # modelFile takes a saved .h5 / .keras path where h5py is installed,
    # or, with no Keras and no file at all, the model's config and arrays
    # (``keras_import.keras_file``: what ``model.to_json()`` and each
    # layer's ``get_weights()`` give); either is converted without Keras.
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.models import keras_import
    from sparkdl_tpu_torch.transformers import KerasTransformer

    rng = np.random.default_rng(1)
    mlp = keras_import.keras_file(
        _sequential("mlp", [8], [_dense("dense", 3)]),
        [_dense_arrays(rng, "dense", 8, 3)])
    vdf = DataFrame({"features": [list(map(float, row)) for row in
                                  np.eye(8, dtype=np.float32)[:4]]})
    kt = KerasTransformer(inputCol="features", outputCol="preds",
                          modelFile=mlp, batchSize=4)
    n_kt = len(kt.transform(vdf).collect())
    print(f"KerasTransformer: {n_kt} rows")
    assert n_kt == 4

    # ------------------------------------------------------------------
    # 6. SQL-style UDF registration
    # reference:
    #   from sparkdl.udf.keras_image_model import registerKerasImageUDF
    #   registerKerasImageUDF("my_udf", model)
    #   ...then SELECT my_udf(image) FROM ...
    from sparkdl_tpu_torch.udf import registerKerasImageUDF, udf_registry

    img_model = keras_import.keras_file(
        _sequential("img", [16, 16, 3], [
            {"class_name": "Flatten", "config": {"name": "flatten"}},
            _dense("dense_1", 2)]),
        [_dense_arrays(rng, "dense_1", 16 * 16 * 3, 2)])
    registerKerasImageUDF("my_udf", img_model)
    scored = udf_registry.apply("my_udf", df, "image", "scores")
    n_scored = sum(1 for r in scored.collect() if r["scores"] is not None)
    print(f"registerKerasImageUDF: scored {n_scored} rows")
    assert n_scored == 6
    # (with pyspark installed: udf_registry.to_pandas_udf("my_udf"))

    # ------------------------------------------------------------------
    # 7. Legacy TF-1.x graph import
    # reference:
    #   from sparkdl import TFInputGraph
    #   TFInputGraph.fromGraph / fromGraphDef / fromSavedModel(WithSignature)
    #   / fromCheckpoint(WithSignature)
    # The port reads GraphDefs, SavedModels and checkpoints with neither
    # TensorFlow nor protobuf installed.
    from sparkdl_tpu_torch.graph.input import TFInputGraph  # noqa: F401

    print("TFInputGraph: all six constructors available "
          "(see tests/test_torch_tf_input.py)")

    # ------------------------------------------------------------------
    # 8. Transfer-learning estimator + tuning
    # reference:
    #   from sparkdl import KerasImageFileEstimator
    #   est = KerasImageFileEstimator(inputCol="uri", outputCol="preds",
    #       labelCol="label", imageLoader=load_fn, modelFile="m.h5",
    #       kerasOptimizer="adam", kerasLoss="categorical_crossentropy",
    #       kerasFitParams={"epochs": 5})
    #   CrossValidator(estimator=est, estimatorParamMaps=grid, ...).fit(df)
    from sparkdl_tpu_torch.estimators import ImageFileEstimator

    def loader(uri):
        from PIL import Image

        img = Image.open(uri).convert("RGB").resize((16, 16))
        return np.asarray(img, np.float32) / 255.0

    class Linear(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w))

    est = ImageFileEstimator(
        inputCol="uri", outputCol="preds", labelCol="label",
        modelFunction=ModelFunction(
            fn=lambda m, x: x.reshape(x.shape[0], -1) @ m.w,
            module=Linear(np.zeros((16 * 16 * 3, 2), np.float32))),
        imageLoader=loader, optimizer="sgd", loss="mse",
        fitParams={"epochs": 1, "steps_per_execution": 2}, batchSize=4)
    uris = [os.path.join(d, f"img_{i}.jpg") for i in range(6)]
    labels = [[1.0, 0.0] if i % 2 == 0 else [0.0, 1.0] for i in range(6)]
    tdf = DataFrame({"uri": uris, "label": labels})
    fitted = est.fit(tdf)
    print(f"ImageFileEstimator: fit done, losses={len(fitted.trainLosses)} "
          f"epoch(s)")
    assert len(fitted.trainLosses) == 1
    assert all(np.isfinite(v) for v in fitted.trainLosses)
    # ParamGridBuilder / CrossValidator / TrainValidationSplit live in
    # sparkdl_tpu_torch.estimators.tuning with the pyspark.ml API shape.


if __name__ == "__main__":
    main()
