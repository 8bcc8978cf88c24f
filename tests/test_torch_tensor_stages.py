"""The port's tensor, image-file and TFImage stages and the rest of
``image/io.py``, held against the JAX package's on the same inputs and
weights (CPU; the conftest's real JPEG fixtures and a garbage ``.jpg``).

Stages of a Keras model read the same ``.keras`` file in both packages;
the others run the same function, written once in jax.numpy and once in
torch, on the same numpy weights.  Float outputs agree within 1e-5 of the
largest magnitude (``REL``); host image functions agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparkdl_tpu_torch
import sparkdl_tpu.image.io as jax_io
import sparkdl_tpu_torch.image.io as port_io
from sparkdl_tpu.frame import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.transformers import image_file as jax_if
from sparkdl_tpu.transformers import named_image as jax_ni
from sparkdl_tpu.transformers import tensor as jax_tensor
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.transformers import image_file as port_if
from sparkdl_tpu_torch.transformers import named_image as port_ni
from sparkdl_tpu_torch.transformers import tensor as port_tensor

REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _column(df, name):
    return df.table.column(name).to_pylist()


def _same_rows(got, want, rel=REL):
    """Two list columns: nulls in the same rows, values within ``rel``."""
    assert [g is None for g in got] == [w is None for w in want]
    pairs = [(g, w) for g, w in zip(got, want) if g is not None]
    assert pairs
    _close([g for g, _ in pairs], [w for _, w in pairs], rel)


def _loader8(uri):
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((8, 6))
    return np.asarray(img, dtype=np.float32) / 255.0


def _keras_cnn(path):
    import keras
    from keras import layers

    model = keras.Sequential([
        layers.Input((6, 8, 3)),
        layers.Conv2D(4, 3, strides=2, padding="same", activation="relu"),
        layers.BatchNormalization(),
        layers.Flatten(),
        layers.Dense(3, activation="softmax"),
    ])
    bn = model.layers[1]
    rng = np.random.default_rng(3)
    bn.set_weights([rng.uniform(0.5, 1.5, w.shape).astype("float32")
                    for w in bn.weights])
    model.save(path)
    return model


# -- tensor stages ---------------------------------------------------------------
class _TanhLinear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x):
        return torch.tanh(x @ self.w)


def test_model_transformer_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(11, 6)).astype(np.float32)
    rows = {"feats": [list(map(float, r)) for r in x]}
    jmf = JaxModelFunction(fn=lambda v, t: jnp.tanh(t @ v["w"]),
                           variables={"w": w})
    want = _column(jax_tensor.ModelTransformer(
        inputCol="feats", outputCol="out", modelFunction=jmf,
        batchSize=4).transform(JaxDataFrame(rows)), "out")
    stage = port_tensor.ModelTransformer(
        inputCol="feats", outputCol="out",
        modelFunction=ModelFunction.from_module(_TanhLinear(w)), batchSize=4)
    got = _column(stage.transform(DataFrame(rows)), "out")
    _same_rows(got, want)
    # the engine is cached on the stage
    stage.transform(DataFrame(rows))
    assert len(stage._engine_cache) == 1


def _sum_diff(module, d):
    return {"sum": d["a"] + d["b"], "diff": d["a"] - d["b"]}


def test_tf_transformer_mapping_matches_jax():
    rng = np.random.default_rng(1)
    xa = rng.normal(size=(9, 4)).astype(np.float32)
    xb = rng.normal(size=(9, 4)).astype(np.float32)
    rows = {"colA": [list(map(float, r)) for r in xa],
            "colB": [list(map(float, r)) for r in xb]}
    kw = dict(inputMapping={"colA": "a", "colB": "b"},
              outputMapping={"sum": "s", "diff": "d"}, batchSize=4)
    jmf = JaxModelFunction(
        fn=lambda v, d: {"sum": d["a"] + d["b"], "diff": d["a"] - d["b"]},
        variables={}, input_names=("a", "b"), output_names=("sum", "diff"))
    want = jax_tensor.TFTransformer(modelFunction=jmf, **kw).transform(
        JaxDataFrame(rows))
    mf = ModelFunction(fn=_sum_diff, input_names=("a", "b"),
                       output_names=("sum", "diff"))
    got = port_tensor.TFTransformer(modelFunction=mf, **kw).transform(
        DataFrame(rows))
    for col in ("s", "d"):
        _same_rows(_column(got, col), _column(want, col))
    with pytest.raises(ValueError, match="unknown model inputs"):
        port_tensor.TFTransformer(modelFunction=mf,
                                  inputMapping={"colA": "nope"},
                                  outputMapping={"sum": "s"}).transform(
            DataFrame(rows))
    with pytest.raises(ValueError, match="unknown model outputs"):
        port_tensor.TFTransformer(modelFunction=mf,
                                  inputMapping={"colA": "a", "colB": "b"},
                                  outputMapping={"nope": "s"}).transform(
            DataFrame(rows))


def test_tf_transformer_on_a_converted_two_input_model(tmp_path):
    """A Keras model with two inputs and two outputs through the mapping
    form, from the same .keras file in both packages."""
    import keras
    from keras import layers

    a = layers.Input((4,), name="a")
    b = layers.Input((4,), name="b")
    h = layers.Concatenate()([a, b])
    model = keras.Model([a, b], [layers.Dense(3, name="o1")(h),
                                 layers.Subtract(name="o2")([a, b])])
    path = str(tmp_path / "two.keras")
    model.save(path)
    rng = np.random.default_rng(2)
    rows = {c: [list(map(float, r)) for r in
                rng.normal(size=(7, 4)).astype(np.float32)]
            for c in ("colA", "colB")}
    jmf = JaxModelFunction.from_keras(path)
    mf = ModelFunction.from_keras(path)
    assert tuple(mf.input_names) == tuple(jmf.input_names)
    want = jax_tensor.TFTransformer(
        modelFunction=jmf, inputMapping={"colA": "a", "colB": "b"},
        outputMapping={jmf.output_names[0]: "p", jmf.output_names[1]: "q"},
        batchSize=4).transform(JaxDataFrame(rows))
    got = port_tensor.TFTransformer(
        modelFunction=mf, inputMapping={"colA": "a", "colB": "b"},
        outputMapping={"o1": "p", "o2": "q"},
        batchSize=4).transform(DataFrame(rows))
    for col in ("p", "q"):
        _same_rows(_column(got, col), _column(want, col))


def test_keras_transformer_matches_jax(tmp_path):
    import keras
    from keras import layers

    model = keras.Sequential([layers.Input((10,)),
                              layers.Dense(6, activation="relu"),
                              layers.Dense(3, activation="softmax")])
    path = str(tmp_path / "mlp.h5")
    model.save(path)
    x = np.random.default_rng(3).normal(size=(7, 10)).astype(np.float32)
    rows = {"in": [list(map(float, r)) for r in x]}
    want = _column(jax_tensor.KerasTransformer(
        inputCol="in", outputCol="out", modelFile=path,
        batchSize=4).transform(JaxDataFrame(rows)), "out")
    got = _column(port_tensor.KerasTransformer(
        inputCol="in", outputCol="out", modelFile=path,
        batchSize=4).transform(DataFrame(rows)), "out")
    _same_rows(got, want)
    _close(got, model.predict(x, verbose=0), rel=1e-4)


# -- image-file stages -------------------------------------------------------------
def _flat_sum(module, x):
    return x.reshape(x.shape[0], -1) @ module.w


class _FlatW(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x):
        return x.reshape(x.shape[0], -1) @ self.w


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_image_file_transformer_matches_jax(fixture_images, monkeypatch,
                                            pipeline):
    """Loader failures become null rows; pipelined and serial alike."""
    monkeypatch.setenv("SPARKDL_PIPELINE", pipeline)
    w = np.random.default_rng(4).normal(size=(6 * 8 * 3, 2)).astype(
        np.float32)
    paths = fixture_images["paths"] + [fixture_images["bad"]] \
        + fixture_images["paths"]
    rows = {"uri": paths}
    jmf = JaxModelFunction(
        fn=lambda v, x: x.reshape(x.shape[0], -1) @ v["w"],
        variables={"w": w})
    want = _column(jax_if.ImageFileTransformer(
        inputCol="uri", outputCol="out", modelFunction=jmf,
        imageLoader=_loader8, batchSize=2).transform(JaxDataFrame(rows)),
        "out")
    got = _column(port_if.ImageFileTransformer(
        inputCol="uri", outputCol="out",
        modelFunction=ModelFunction.from_module(_FlatW(w)),
        imageLoader=_loader8, batchSize=2).transform(DataFrame(rows)), "out")
    assert got[3] is None and sum(g is None for g in got) == 1
    _same_rows(got, want)


def test_image_file_transformer_all_null():
    def bad(uri):
        raise OSError("unreadable")

    stage = port_if.ImageFileTransformer(
        inputCol="uri", outputCol="out",
        modelFunction=ModelFunction.from_module(_FlatW(np.ones((3, 1),
                                                               np.float32))),
        imageLoader=bad)
    out = _column(stage.transform(DataFrame({"uri": ["a", "b"]})), "out")
    assert out == [None, None]


def test_keras_image_file_transformer_matches_jax(tmp_path, fixture_images):
    path = str(tmp_path / "cnn.keras")
    model = _keras_cnn(path)
    paths = [fixture_images["bad"]] + fixture_images["paths"]
    rows = {"uri": paths}
    want = _column(jax_if.KerasImageFileTransformer(
        inputCol="uri", outputCol="out", modelFile=path,
        imageLoader=_loader8, batchSize=2).transform(JaxDataFrame(rows)),
        "out")
    got = _column(port_if.KerasImageFileTransformer(
        inputCol="uri", outputCol="out", modelFile=path,
        imageLoader=_loader8, batchSize=2).transform(DataFrame(rows)), "out")
    assert got[0] is None
    _same_rows(got, want)
    batch = np.stack([_loader8(u) for u in fixture_images["paths"]])
    _close(got[1:], model.predict(batch, verbose=0), rel=1e-4)


def test_keras_image_file_transformer_takes_a_keras_file(tmp_path,
                                                        fixture_images):
    """``modelFile`` may be an in-memory KerasFile (config and arrays)."""
    from sparkdl_tpu_torch.models import keras_import

    path = str(tmp_path / "cnn.keras")
    _keras_cnn(path)
    rows = {"uri": fixture_images["paths"]}
    kw = dict(inputCol="uri", outputCol="out", imageLoader=_loader8,
              batchSize=2)
    from_path = _column(port_if.KerasImageFileTransformer(
        modelFile=path, **kw).transform(DataFrame(rows)), "out")
    kfile = keras_import.read_keras(path)
    in_memory = keras_import.keras_file(kfile.model_config, kfile.layers)
    got = _column(port_if.KerasImageFileTransformer(
        modelFile=in_memory, **kw).transform(DataFrame(rows)), "out")
    assert got == from_path


# -- TFImageTransformer ------------------------------------------------------------
def _half(module, x):
    return x.to(torch.float32) * 0.5


def _rgba(module, x):
    rgb = x.to(torch.float32)
    return torch.cat([rgb, torch.full_like(rgb[..., :1], 7.0)], dim=-1)


@pytest.mark.parametrize("mode", ["vector", "image"])
def test_tf_image_transformer_matches_jax(fixture_images, mode):
    jdf = jax_io.readImages(fixture_images["dir"])
    df = port_io.readImages(fixture_images["dir"])
    jmf = JaxModelFunction(fn=lambda v, x: x.astype("float32") * 0.5)
    kw = dict(inputCol="image", outputCol="out", inputSize=[24, 20],
              outputMode=mode, batchSize=2)
    want = _column(jax_ni.TFImageTransformer(modelFunction=jmf, **kw)
                   .transform(jdf), "out")
    got = _column(port_ni.TFImageTransformer(
        modelFunction=ModelFunction(fn=_half), **kw).transform(df), "out")
    if mode == "vector":
        _same_rows(got, want)
        assert all(len(g) == 24 * 20 * 3 for g in got if g is not None)
    else:
        assert got == want
        valid = [g for g in got if g is not None]
        assert len(valid) == 3 and all(
            g["height"] == 24 and g["width"] == 20 and g["mode"] == 21
            for g in valid)


def test_tf_image_transformer_rgba_and_inferred_size(fixture_images):
    """A 4-channel output packs as BGRA (alpha last); with no inputSize
    the first row's size is used, and transformStream pins it."""
    from sparkdl_tpu_torch.image.schema import imageStructToArray

    df = port_io.readImages(fixture_images["dir"])
    stage = port_ni.TFImageTransformer(
        inputCol="image", outputCol="out", outputMode="image",
        modelFunction=ModelFunction(fn=_rgba), inputSize=[5, 6])
    rows = [r for r in _column(stage.transform(df), "out") if r is not None]
    arr = imageStructToArray(rows[0])
    assert arr.shape == (5, 6, 4) and np.all(arr[..., 3] == 7.0)
    vec = port_ni.TFImageTransformer(
        inputCol="image", outputCol="out",
        modelFunction=ModelFunction(fn=_half), batchSize=2)
    first = next(r for r in _column(df, "image") if r is not None)
    out = _column(vec.transform(df), "out")
    width = first["height"] * first["width"] * 3
    assert all(len(o) == width for o in out if o is not None)
    batches = df.table.to_batches(max_chunksize=1)
    streamed = [v for b in vec.transformStream(batches)
                for v in b.column(b.schema.get_field_index("out"))
                .to_pylist() if v is not None]
    assert {len(v) for v in streamed} == {width}


# -- image/io ----------------------------------------------------------------------------
@pytest.fixture()
def pil_route():
    """The port's native core off, as ``SPARKDL_TPU_DISABLE_NATIVE`` leaves
    it."""
    from sparkdl_tpu_torch import native

    with native.disabled():
        yield


def test_image_io_functions_match_jax(fixture_images, pil_route):
    """createResizeImageUDF, structToModelInput, structsToBatch,
    decodeResizeBatch, filesToModelBatch and filesToDF give the JAX
    package's results (its PIL route: the native core is disabled with
    ``SPARKDL_TPU_DISABLE_NATIVE``; tests/test_torch_native.py holds the
    core's route)."""
    from sparkdl_tpu.image.schema import imageArrayToStruct

    assert not port_io._native_io_preferred()

    paths = fixture_images["paths"] + [fixture_images["bad"]]
    rng = np.random.default_rng(5)
    structs = [imageArrayToStruct(rng.integers(0, 256, (9, 7, c),
                                               dtype=np.uint8), origin="o")
               for c in (3, 1, 4, 3, 3)]
    a = jax_io.createResizeImageUDF([4, 6])(structs[0])
    b = port_io.createResizeImageUDF([4, 6])(structs[0])
    assert a == b and port_io.createResizeImageUDF([4, 6])(None) is None
    with pytest.raises(ValueError):
        port_io.createResizeImageUDF([1, 2, 3])
    for s in structs:
        np.testing.assert_array_equal(port_io.structToModelInput(s, 5, 4),
                                      jax_io.structToModelInput(s, 5, 4))
    np.testing.assert_array_equal(
        port_io.structsToBatch(structs, 5, 4, num_threads=1),
        port_io.structsToBatch(structs, 5, 4))
    np.testing.assert_array_equal(
        port_io.structsToBatch(structs, 5, 4),
        np.stack([jax_io.structToModelInput(s, 5, 4) for s in structs]))
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    got, ok = port_io.decodeResizeBatch(blobs, 12, 10)
    assert ok.tolist() == [True, True, True, False]
    assert not got[3].any()
    for i in range(3):
        want = jax_io.resizeImage(jax_io.PIL_decode(blobs[i]), 12,
                                  10)[:, :, ::-1]
        np.testing.assert_array_equal(got[i], want)
    fgot, fok = port_io.filesToModelBatch(paths + ["/no/such/file"], 12, 10)
    np.testing.assert_array_equal(fgot[:4], got)
    assert fok.tolist() == [True, True, True, False, False]
    pdf = port_io.filesToDF(fixture_images["dir"])
    jdf = jax_io.filesToDF(fixture_images["dir"])
    assert pdf.table.equals(jdf.table)


def test_decode_fault_site_drops_the_row():
    from sparkdl_tpu_torch import faults

    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, "PNG")
    blobs = [buf.getvalue()] * 5
    plan = faults.FaultPlan.parse("seed=1;io.decode:error:exc=decode,at=2")
    with faults.active(plan):
        _, ok = port_io.decodeResizeBatch(blobs, 4, 4)
    assert ok.tolist() == [True, False, True, True, True]  # the 2nd call
    assert plan.fired("io.decode") == 1


def test_resize_udf_over_a_frame(fixture_images):
    """The resize UDF applied with map_rows over readImages: null rows
    stay null, the rest take the new size."""
    df = port_io.readImages(fixture_images["dir"])
    resize = port_io.createResizeImageUDF([7, 5])
    out = df.map_rows(lambda r: {"image": resize(r["image"])})
    rows = _column(out, "image")
    assert sum(r is None for r in rows) == 1
    assert all((r["height"], r["width"]) == (7, 5) for r in rows if r)
