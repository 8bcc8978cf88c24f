"""The port's UDF registry (``sparkdl_tpu_torch/udf``) held against the JAX
package's on the same image column and the same Keras model (CPU).

Both the Arrow path (struct buffers packed zero-copy) and the list path
(rows as dicts) must give the JAX UDF's values within 1e-5 of the largest
magnitude, with null rows kept null.
"""

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.image.io import readImages as jax_readImages
from sparkdl_tpu.udf import UDFRegistry as JaxRegistry
from sparkdl_tpu.udf import register_image_udf as jax_register_image_udf
from sparkdl_tpu.udf import registerKerasImageUDF as jax_registerKerasImageUDF
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.image.io import readImages
from sparkdl_tpu_torch.udf import (UDFRegistry, register_image_udf,
                                   registerKerasImageUDF, udf_registry)

REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _same_rows(got, want, rel=REL):
    assert [g is None for g in got] == [w is None for w in want]
    g = np.asarray([v for v in got if v is not None], np.float64)
    w = np.asarray([v for v in want if v is not None], np.float64)
    assert g.shape == w.shape and len(g)
    assert np.abs(g - w).max() <= rel * np.abs(w).max()


class _FlatW(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x):
        return x.reshape(x.shape[0], -1) @ self.w


def _scale(x):
    return x / 255.0


@pytest.mark.parametrize("path", ["arrow", "list"])
def test_register_image_udf_matches_jax(fixture_images, path):
    w = np.random.default_rng(0).normal(size=(16 * 12 * 3, 2)).astype(
        np.float32)
    jreg, reg = JaxRegistry(), UDFRegistry()
    jax_register_image_udf(
        "lin", JaxModelFunction(fn=lambda v, x: x.reshape(x.shape[0], -1)
                                @ v["w"], variables={"w": w}),
        input_size=(16, 12), preprocessor=lambda x: x / 255.0, registry=jreg,
        batch_size=2)
    register_image_udf("lin", ModelFunction.from_module(_FlatW(w)),
                       input_size=(16, 12), preprocessor=_scale,
                       registry=reg, batch_size=2)
    jcol = jax_readImages(fixture_images["dir"]).table.column("image")
    col = readImages(fixture_images["dir"]).table.column("image")
    if path == "list":
        jcol, col = jcol.to_pylist(), col.to_pylist()
    want = jreg.get("lin")(jcol)
    got = reg.get("lin")(col)
    assert sum(g is None for g in got) == 1
    _same_rows(got, want)


def test_apply_and_first_row_size(fixture_images):
    """Without input_size the first valid row's size is used; apply adds
    the column with nulls kept."""
    reg = UDFRegistry()

    def mean_rgb(x):
        return x.mean(dim=(1, 2))

    register_image_udf("m", ModelFunction.from_callable(mean_rgb),
                       registry=reg)
    df = readImages(fixture_images["dir"])
    out = reg.apply("m", df, "image", "rgb").table.column("rgb").to_pylist()
    assert sum(o is None for o in out) == 1
    assert all(len(o) == 3 for o in out if o is not None)
    assert reg.names() == ["m"]
    with pytest.raises(KeyError, match="No UDF named"):
        reg.get("nope")


def _keras_cnn():
    import keras
    from keras import layers

    return keras.Sequential([
        layers.Input((10, 12, 3)),
        layers.Conv2D(2, 3, padding="same", activation="relu"),
        layers.BatchNormalization(),
        layers.GlobalAveragePooling2D(),
    ])


@pytest.mark.parametrize("source", ["object", "keras", "h5", "keras_file"])
def test_register_keras_image_udf_matches_jax(fixture_images, tmp_path,
                                              source):
    """The same Keras model registered in both packages (the port reads it
    as a model object, a .keras or .h5 path, or a KerasFile); the image
    size comes from the model's input shape."""
    from sparkdl_tpu_torch.models import keras_import

    model = _keras_cnn()
    bn = model.layers[1]
    rng = np.random.default_rng(1)
    bn.set_weights([rng.uniform(0.5, 1.5, w.shape).astype("float32")
                    for w in bn.weights])
    arg = model
    if source in ("keras", "h5", "keras_file"):
        arg = str(tmp_path / f"m.{'h5' if source == 'h5' else 'keras'}")
        model.save(arg)
    if source == "keras_file":
        read = keras_import.read_keras(arg)
        arg = keras_import.keras_file(read.model_config, read.layers)
    jreg, reg = JaxRegistry(), UDFRegistry()
    jax_registerKerasImageUDF("cnn", model, preprocessor=lambda x: x / 255.0,
                              registry=jreg)
    registerKerasImageUDF("cnn", arg, preprocessor=_scale, registry=reg)
    want = jreg.apply("cnn", jax_readImages(fixture_images["dir"]), "image",
                      "f").table.column("f").to_pylist()
    got = reg.apply("cnn", readImages(fixture_images["dir"]), "image",
                    "f").table.column("f").to_pylist()
    _same_rows(got, want)


def test_global_registry_and_pandas_udf_gate(fixture_images):
    register = udf_registry.register("ident_len", lambda rows: [
        None if r is None else float(r["height"]) for r in rows],
        returns="float")
    df = readImages(fixture_images["dir"])
    out = udf_registry.apply("ident_len", df, "image", "h")
    assert sum(v is None for v in out.table.column("h").to_pylist()) == 1
    assert register.returns == "float"
    with pytest.raises(ValueError, match="Unsupported UDF return type"):
        udf_registry.register("bad", lambda rows: rows, returns="tensor")
    try:
        import pyspark  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="pyspark"):
            udf_registry.to_pandas_udf("ident_len")
