"""Stage persistence of the port (``sparkdl_tpu_torch/persistence.py``):
save -> load -> the same transform output, bit for bit, for each stage;
the loaded pipeline held against the JAX package's on the same weights
(within 1e-5 of the largest magnitude); lambdas fail at save; a directory
the JAX package wrote is refused."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparkdl_tpu_torch
from sparkdl_tpu.estimators.classification import \
    LogisticRegressionModel as JaxLRModel
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.image.io import readImages as jax_readImages
from sparkdl_tpu.transformers import PipelineModel as JaxPipelineModel
from sparkdl_tpu.transformers import TFImageTransformer as JaxTFImage
from sparkdl_tpu_torch.estimators import LogisticRegression
from sparkdl_tpu_torch.estimators.classification import \
    LogisticRegressionModel
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.image.io import readImages
from sparkdl_tpu_torch.models import keras_import
from sparkdl_tpu_torch.transformers import (DeepImageFeaturizer,
                                            ImageFileTransformer,
                                            KerasImageFileTransformer,
                                            KerasTransformer,
                                            ModelTransformer, PipelineModel,
                                            TFImageTransformer, TFTransformer)


@pytest.fixture(autouse=True)
def _cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


# module-level (picklable) functions, modules and loaders
def _loader8(uri):
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((8, 8))
    return np.asarray(img, dtype=np.float32) / 255.0


class FlatLinear(torch.nn.Module):
    def __init__(self, n_in, n_out, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(torch.randn(n_in, n_out, generator=g))
        self.register_buffer("scale", torch.tensor(0.01))

    def forward(self, x):
        return (x.reshape(x.shape[0], -1).to(torch.float32) @ self.w) \
            * self.scale


def _pair_fn(module, d):
    return {"sum": module(d["a"] + d["b"]), "diff": d["a"] - d["b"]}


def _column(df, name):
    return df.table.column(name).to_pylist()


def _round_trip(stage, df, col, tmp_path, name="stage"):
    want = _column(stage.transform(df), col)
    path = str(tmp_path / name)
    stage.save(path)
    loaded = type(stage).load(path)
    assert _column(loaded.transform(df), col) == want
    return loaded, path, want


def _keras_cnn(path):
    import keras
    from keras import layers

    model = keras.Sequential([
        layers.Input((8, 8, 3)),
        layers.Conv2D(2, 3, padding="same"),
        layers.BatchNormalization(),
        layers.GlobalAveragePooling2D(),
        layers.Dense(2, activation="softmax"),
    ])
    model.save(path)
    return model


def test_model_and_tf_transformers_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    df = DataFrame({"a": [list(map(float, r)) for r in x],
                    "b": [list(map(float, r)) for r in x[::-1]]})
    mt = ModelTransformer(inputCol="a", outputCol="out", batchSize=2,
                          modelFunction=ModelFunction.from_module(
                              FlatLinear(6, 3)))
    loaded, path, _ = _round_trip(mt, df, "out", tmp_path, "mt")
    assert torch.equal(loaded.getModelFunction().module.w,
                       mt.getModelFunction().module.w)
    tf = TFTransformer(modelFunction=ModelFunction(
        fn=_pair_fn, module=FlatLinear(6, 2), input_names=("a", "b"),
        output_names=("sum", "diff")),
        inputMapping={"a": "a", "b": "b"},
        outputMapping={"sum": "s", "diff": "d"})
    loaded, _, _ = _round_trip(tf, df, "s", tmp_path, "tf")
    assert loaded.getOutputMapping() == {"sum": "s", "diff": "d"}


def test_keras_stages_store_config_not_pickles(tmp_path, fixture_images):
    """A stage with a modelFile path stores no model; one holding a
    converted Keras model stores its config as JSON and its tensors, and
    pickles only the loader."""
    kpath = str(tmp_path / "tiny.keras")
    _keras_cnn(kpath)
    df = DataFrame({"uri": fixture_images["paths"]
                    + [fixture_images["bad"]]})
    kt = KerasImageFileTransformer(inputCol="uri", outputCol="p",
                                   modelFile=kpath, imageLoader=_loader8,
                                   batchSize=2)
    loaded, path, want = _round_trip(kt, df, "p", tmp_path, "kift")
    assert want[-1] is None
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["extra"]["modelFunction"] == "from-modelFile"
    assert not os.path.exists(os.path.join(path, "tensors.pt"))
    assert loaded.getModelFile() == kpath

    it = ImageFileTransformer(inputCol="uri", outputCol="p",
                              modelFunction=ModelFunction.from_keras(kpath),
                              imageLoader=_loader8, batchSize=2)
    _, path, _ = _round_trip(it, df, "p", tmp_path, "ift")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["pickles"] == ["imageLoader"]
    assert meta["extra"]["modelFunction"]["keras_config"]["class_name"] \
        == "Sequential"

    read = keras_import.read_keras(kpath)
    mem = KerasImageFileTransformer(
        inputCol="uri", outputCol="p", imageLoader=_loader8, batchSize=2,
        modelFile=keras_import.keras_file(read.model_config, read.layers))
    loaded, _, got = _round_trip(mem, df, "p", tmp_path, "mem")
    assert got == want and not loaded.isSet(loaded.modelFile)


def test_keras_transformer_round_trip(tmp_path):
    import keras
    from keras import layers

    model = keras.Sequential([layers.Input((6,)), layers.Dense(3)])
    kpath = str(tmp_path / "mlp.h5")
    model.save(kpath)
    df = DataFrame({"in": [[0.1 * i] * 6 for i in range(5)]})
    kt = KerasTransformer(inputCol="in", outputCol="o", modelFile=kpath,
                          batchSize=2)
    loaded, _, _ = _round_trip(kt, df, "o", tmp_path)
    assert loaded.getModelFile() == kpath


@pytest.mark.parametrize("mode", ["vector", "image"])
def test_tf_image_transformer_round_trip(tmp_path, fixture_images, mode):
    df = readImages(fixture_images["dir"])
    mf = (ModelFunction.from_module(FlatLinear(6 * 5 * 3, 4))
          if mode == "vector" else ModelFunction.from_callable(_to_float))
    t = TFImageTransformer(inputCol="image", outputCol="f", modelFunction=mf,
                           inputSize=[6, 5], outputMode=mode, batchSize=2)
    loaded, _, _ = _round_trip(t, df, "f", tmp_path)
    assert loaded.getOutputMode() == mode


def _to_float(x):
    return x.to(torch.float32)


def test_zoo_featurizer_params_round_trip(tmp_path):
    ft = DeepImageFeaturizer(inputCol="image", outputCol="features",
                             modelName="ResNet50", batchSize=16)
    p = str(tmp_path / "featurizer")
    ft.save(p)
    loaded = DeepImageFeaturizer.load(p)
    assert (loaded.getModelName(), loaded.getBatchSize(),
            loaded.getInputCol()) == ("ResNet50", 16, "image")
    with pytest.raises(FileExistsError):
        ft.save(p)
    ft.save(p, overwrite=True)
    with pytest.raises(TypeError, match="not a TFImageTransformer"):
        TFImageTransformer.load(p)


def test_pipeline_model_with_logistic_regression(tmp_path, fixture_images):
    """PipelineModel([TFImageTransformer, fitted LogisticRegressionModel])
    saved and loaded, then held against the JAX pipeline with the same
    weights."""
    df = readImages(fixture_images["dir"]).dropna("image")
    module = FlatLinear(8 * 8 * 3, 4, seed=3)
    feats = TFImageTransformer(inputCol="image", outputCol="features",
                               modelFunction=ModelFunction.from_module(module),
                               inputSize=[8, 8], batchSize=2)
    train = feats.transform(df).withColumn("label", [0, 1, 0])
    lr_model = LogisticRegression(maxIter=5, batchSize=2).fit(train)
    pm = PipelineModel([feats, lr_model])
    loaded, path, _ = _round_trip(pm, df, "probability", tmp_path)
    assert isinstance(loaded.stages[1], LogisticRegressionModel)
    assert sorted(os.listdir(os.path.join(path, "stages"))) == [
        "000_TFImageTransformer", "001_LogisticRegressionModel"]
    got = loaded.transform(df)

    w = module.w.detach().numpy()
    jfeats = JaxTFImage(
        inputCol="image", outputCol="features", inputSize=[8, 8],
        batchSize=2, modelFunction=JaxModelFunction(
            fn=lambda v, x: (x.reshape(x.shape[0], -1).astype(jnp.float32)
                             @ v["w"]) * 0.01, variables={"w": w}))
    jpm = JaxPipelineModel([jfeats, JaxLRModel(
        weights={k: np.asarray(v) for k, v in lr_model.weights.items()},
        numClasses=lr_model.numClasses)])
    want = jpm.transform(jax_readImages(fixture_images["dir"]).dropna(
        "image"))
    g, wv = _column(got, "probability"), _column(want, "probability")
    assert [x is None for x in g] == [x is None for x in wv]
    gg = np.asarray([x for x in g if x is not None])
    ww = np.asarray([x for x in wv if x is not None])
    assert np.abs(gg - ww).max() <= 1e-5 * np.abs(ww).max()
    assert _column(got, "prediction") == _column(want, "prediction")


def test_lambda_fn_fails_at_save(tmp_path):
    t = ImageFileTransformer(inputCol="uri", outputCol="out",
                             modelFunction=ModelFunction.from_callable(
                                 lambda x: x), imageLoader=_loader8)
    with pytest.raises(ValueError, match="non-picklable"):
        t.save(str(tmp_path / "bad"))
    t = ImageFileTransformer(inputCol="uri", outputCol="out",
                             modelFunction=ModelFunction.from_callable(
                                 _to_float), imageLoader=lambda u: None)
    with pytest.raises(ValueError, match="non-picklable"):
        t.save(str(tmp_path / "bad2"))


def test_a_jax_package_directory_is_refused(tmp_path):
    from sparkdl_tpu.transformers import DeepImageFeaturizer as JaxFeaturizer

    p = str(tmp_path / "jax_stage")
    JaxFeaturizer(inputCol="image", outputCol="f", modelName="VGG16").save(p)
    with pytest.raises(ValueError, match="not written by sparkdl_tpu_torch"):
        DeepImageFeaturizer.load(p)
