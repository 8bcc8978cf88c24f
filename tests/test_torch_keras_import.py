"""The port's Keras weight import (sparkdl_tpu_torch/models/keras_import.py
and ``load_model(weights=...)``) held against the JAX package's
``import_keras_weights`` on the CPU, tensor for tensor.

Keras writes each file here from ``keras.applications.<Model>(weights=None)``
with its BatchNorm (and EfficientNet's Normalization) statistics redrawn
from a numpy seed, so a fresh init cannot agree by accident.  The JAX
package imports from the live Keras model; its variables go through
``state_dict_from_jax``; the port reads the file Keras wrote from it, with
no Keras.  The two must be equal bit for bit: an import moves values and
transposes them, it computes nothing.

  * MobileNetV2: every layer by name, in all three formats;
  * InceptionV3: every conv and BN by creation order (auto-named), in all
    three formats; the ``.weights.h5`` case takes its names from the
    committed table's renumbered auto names;
  * EfficientNetB0: the Normalization ("norm" kind) and the ImageNet
    build's second Rescaling, read from the ``.keras`` / ``.h5`` model
    config into ``post_scale``; its ``.weights.h5`` (no config) keeps
    ``post_scale`` at 1, as the JAX package does when it loads that file
    into a ``weights=None`` twin.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu.models as jax_models
import sparkdl_tpu_torch.models as port_models
from sparkdl_tpu_torch.models import convert, keras_import, load_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORMATS = ("weights.h5", "h5", "keras")


def _keras():
    import keras

    return keras


def _perturb(model, seed):
    """Redraw every BatchNormalization's four arrays and the Normalization's
    mean and variance from a numpy seed."""
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        cls = type(layer).__name__
        ws = layer.get_weights()
        if cls == "BatchNormalization":
            layer.set_weights([
                rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
                if i == len(ws) - 1 or (i == 0 and layer.scale)
                else rng.normal(0, 0.1, w.shape).astype(np.float32)
                for i, w in enumerate(ws)])
        elif cls == "Normalization":
            layer.set_weights([
                rng.uniform(0.3, 0.6, ws[0].shape).astype(np.float32),
                rng.uniform(0.04, 0.08, ws[1].shape).astype(np.float32),
                ws[2]])


def _save_all(model, d, stem):
    paths = {}
    for fmt in FORMATS:
        p = str(d / f"{stem}.{fmt}")
        if fmt == "weights.h5":
            model.save_weights(p)
        else:
            model.save(p)
        paths[fmt] = p
    return paths


def jax_state_dict(name, keras_model):
    """The JAX package's import from the live Keras model, in port names."""
    spec = jax_models.get_model_spec(name)
    variables = jax_models.import_keras_weights(
        name, keras_model, spec.abstract_variables())
    return convert.state_dict_from_jax(
        name, jax.tree_util.tree_map(np.asarray, variables))


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert bad == []


@pytest.fixture(scope="module")
def mobilenet_files(tmp_path_factory):
    model = _keras().applications.MobileNetV2(weights=None)
    _perturb(model, 1)
    d = tmp_path_factory.mktemp("mobilenet")
    return _save_all(model, d, "MobileNetV2"), jax_state_dict(
        "MobileNetV2", model)


@pytest.fixture(scope="module")
def inception_files(tmp_path_factory):
    keras = _keras()
    # a Conv2D and a BatchNormalization first, so this model's auto names
    # do not start at 0
    keras.layers.Conv2D(1, 1)
    keras.layers.BatchNormalization()
    model = keras.applications.InceptionV3(weights=None)
    _perturb(model, 2)
    assert model.layers[1].name != "conv2d"
    d = tmp_path_factory.mktemp("inception")
    return _save_all(model, d, "InceptionV3"), jax_state_dict(
        "InceptionV3", model)


@pytest.fixture(scope="module")
def efficientnet_files(tmp_path_factory):
    """A ``weights=None`` EfficientNetB0 (its ``.weights.h5``) and the
    ImageNet build of the same weights (its ``.h5`` and ``.keras``):
    Keras' download is replaced by the first model's file, so the second
    carries the extra Rescaling with no network."""
    from keras.src.applications import efficientnet as keras_eff

    keras = _keras()
    d = tmp_path_factory.mktemp("efficientnet")
    base = keras.applications.EfficientNetB0(weights=None)
    _perturb(base, 3)
    wpath = str(d / "EfficientNetB0.weights.h5")
    base.save_weights(wpath)
    mp = pytest.MonkeyPatch()
    mp.setattr(keras_eff.file_utils, "get_file", lambda *a, **k: wpath)
    try:
        inet = keras.applications.EfficientNetB0(weights="imagenet")
    finally:
        mp.undo()
    assert sum(type(l).__name__ == "Rescaling" for l in inet.layers) == 2
    inet.save(str(d / "EfficientNetB0.h5"))
    inet.save(str(d / "EfficientNetB0.keras"))
    paths = {"weights.h5": wpath, "h5": str(d / "EfficientNetB0.h5"),
             "keras": str(d / "EfficientNetB0.keras")}
    want = {"weights.h5": jax_state_dict("EfficientNetB0", base)}
    want["h5"] = want["keras"] = jax_state_dict("EfficientNetB0", inet)
    return paths, want


@pytest.mark.parametrize("fmt", FORMATS)
def test_mobilenet_by_name_matches_jax(mobilenet_files, fmt):
    paths, want = mobilenet_files
    assert_state_dicts_equal(
        load_model("MobileNetV2", weights=paths[fmt]).state_dict(), want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_inception_creation_order_matches_jax(inception_files, fmt):
    paths, want = inception_files
    read = keras_import.read_weights_file(paths[fmt], "InceptionV3")
    names = [l.name for l in read.layers]
    # no InceptionV3 conv or BN name matches a port module: all 188 pair
    # by creation order
    assert len(names) == 189 and names[-1] == "predictions"
    assert_state_dicts_equal(
        load_model("InceptionV3", weights=paths[fmt]).state_dict(), want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_efficientnet_norm_and_post_scale_match_jax(efficientnet_files, fmt):
    paths, want = efficientnet_files
    got = load_model("EfficientNetB0", weights=paths[fmt]).state_dict()
    assert_state_dicts_equal(got, want[fmt])
    post = got["normalization.post_scale"]
    if fmt == "weights.h5":
        assert torch.equal(post, torch.ones(3))
    else:
        assert not torch.equal(post, torch.ones(3))
        np.testing.assert_allclose(post.numpy(), 1 / np.sqrt(
            [0.229, 0.224, 0.225]), rtol=1e-6)


@pytest.mark.parametrize("name", ["ResNet50", "Xception"])
def test_resnet_and_xception_weights_h5_match_jax(name, tmp_path):
    model = getattr(_keras().applications, name)(weights=None)
    _perturb(model, 4)
    path = str(tmp_path / f"{name}.weights.h5")
    model.save_weights(path)
    assert_state_dicts_equal(load_model(name, weights=path).state_dict(),
                             jax_state_dict(name, model))


# -- the committed table ---------------------------------------------------------
def _gen_tool():
    spec = importlib.util.spec_from_file_location(
        "gen_keras_layers", ROOT / "tools" / "gen_keras_layers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", port_models.SUPPORTED_MODELS)
def test_committed_table_equals_keras(name):
    """``data/keras_layers.json`` is what ``tools/gen_keras_layers.py``
    makes from Keras now, and the file is the tool's own formatting."""
    tool = _gen_tool()
    committed = keras_import.keras_layer_table()
    assert committed[name] == tool.model_layers(
        port_models.get_model_spec(name).keras_app)
    assert sorted(committed) == port_models.SUPPORTED_MODELS
    assert pathlib.Path(keras_import.TABLE_PATH).read_text() == tool.dump(
        committed)


def test_zoo_is_the_jax_zoo():
    assert port_models.SUPPORTED_MODELS == jax_models.SUPPORTED_MODELS
    assert len(port_models.SUPPORTED_MODELS) == 9


# -- the importer's rules --------------------------------------------------------
def _layers_from_table(name, seed):
    """Keras-layout arrays of the right shapes for ``name``'s weighted
    layers, from a numpy seed (BN variances positive)."""
    rng = np.random.default_rng(seed)
    return [keras_import.KerasLayer(
        n, cls, [rng.uniform(0.5, 1.5, s).astype(np.float32)
                 for s in shapes])
        for n, cls, shapes in keras_import.keras_layer_table()[name]]


def test_layer_list_entry_places_every_array():
    layers = _layers_from_table("ResNet50", 5)
    sd = port_models.import_keras_weights("ResNet50", layers)
    m = load_model("ResNet50")
    m.load_state_dict(sd)  # strict
    by_name = {l.name: l for l in layers}
    k = by_name["conv2_block1_0_conv"].weights[0]  # HWIO
    assert torch.equal(sd["conv2_block1.conv2_block1_0_conv.weight"],
                       torch.from_numpy(k).permute(3, 2, 0, 1))
    assert torch.equal(sd["predictions.weight"],
                       torch.from_numpy(by_name["predictions"].weights[0]).t())
    assert torch.equal(sd["conv1_bn.running_var"],
                       torch.from_numpy(by_name["conv1_bn"].weights[3]))
    # plain (name, class, arrays) tuples work as well
    sd2 = port_models.import_keras_weights(
        "ResNet50", [tuple(l[:3]) for l in layers])
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_importer_raises_on_what_it_cannot_place():
    from sparkdl_tpu_torch.models.mobilenet import MobileNetV2

    layers = _layers_from_table("MobileNetV2", 6)
    model = MobileNetV2()
    # an auto-named layer with no auto order
    odd = [keras_import.KerasLayer("conv2d_7", *layers[0][1:3])] + layers[1:]
    with pytest.raises(KeyError, match="conv2d_7"):
        keras_import.import_weights(model, odd)
    # a depthwise layer with a bias: the port's depthwise layers have none
    i = next(i for i, l in enumerate(layers)
             if l.class_name == "DepthwiseConv2D")
    biased = list(layers)
    biased[i] = keras_import.KerasLayer(
        layers[i].name, "DepthwiseConv2D",
        [layers[i].weights[0],
         np.zeros(layers[i].weights[0].shape[2], np.float32)])
    with pytest.raises(KeyError, match="does not have"):
        keras_import.import_weights(model, biased)
    # a shape mismatch
    bad = list(layers)
    bad[0] = keras_import.KerasLayer(
        "Conv1", "Conv2D", [np.zeros((3, 3, 3, 16), np.float32)])
    with pytest.raises(ValueError, match="Shape mismatch"):
        keras_import.import_weights(model, bad)
    # a layer missing: its port tensors stay unset
    with pytest.raises(ValueError, match="without a Keras weight"):
        keras_import.import_weights(model, layers[1:])
    # auto order with more layers than it consumes
    extra = layers + [keras_import.KerasLayer(
        "conv2d_3", "Conv2D", [np.zeros((1, 1, 320, 1280), np.float32)])]
    with pytest.raises(ValueError, match="Unconsumed"):
        keras_import.import_weights(model, extra, auto_order=[])


@pytest.mark.parametrize("config,scale,n", [
    ({"scale": False}, False, 3), (None, False, 3), (None, True, 4),
    ({"center": False}, True, 3)])
def test_batchnorm_flags_from_config_or_module(config, scale, n):
    """Keras BN arrays are [gamma if scale][beta if center][mean, var]: the
    flags come from the layer's config, else from the target module."""
    from sparkdl_tpu_torch.models.layers import BatchNorm

    model = torch.nn.Module()
    model.bn = BatchNorm(4, scale=scale)
    arrays = [np.full(4, i + 1, np.float32) for i in range(n)]
    layer = keras_import.KerasLayer("bn", "BatchNormalization", arrays,
                                    config)
    if config == {"center": False}:
        # the port's BatchNorm always has a bias: nothing fills it
        with pytest.raises(ValueError, match="without a Keras weight"):
            keras_import.import_weights(model, [layer])
        return
    sd = keras_import.import_weights(model, [layer])
    assert torch.equal(sd["bn.running_var"], torch.full((4,), float(n)))
    assert torch.equal(sd["bn.bias"], torch.full((4,), float(n - 2)))
    assert ("bn.weight" in sd) == scale


# -- offline resolution (mirrors tests/test_offline_weights.py) ----------------
def test_explicit_weights_path_must_exist():
    spec = port_models.get_model_spec("ResNet50")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        spec.resolve_weights("/no/such/file.h5")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        load_model("ResNet50", weights="/no/such/file.weights.h5")


def test_weights_dir_resolution(tmp_path, monkeypatch):
    spec = port_models.get_model_spec("ResNet50")
    jspec = jax_models.get_model_spec("ResNet50")
    monkeypatch.delenv("SPARKDL_WEIGHTS_DIR", raising=False)
    assert spec.resolve_weights("imagenet") == "imagenet"
    monkeypatch.setenv("SPARKDL_WEIGHTS_DIR", str(tmp_path))
    assert spec.resolve_weights("imagenet") == "imagenet"
    for stem in ("resnet50", "ResNet50"):
        for ext in (".keras", ".h5", ".weights.h5"):
            cand = tmp_path / (stem + ext)
            cand.write_bytes(b"")
            assert spec.resolve_weights("imagenet") == str(cand) == \
                jspec.resolve_weights("imagenet")
    assert spec.resolve_weights(None) is None


def test_missing_imagenet_file_warns_and_gives_seeded_init(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SPARKDL_WEIGHTS_DIR", str(tmp_path))  # empty
    warned = []
    monkeypatch.setattr(port_models.logger, "warning",
                        lambda *a, **k: warned.append(a))
    got = load_model("MobileNetV2", weights="imagenet").state_dict()
    want = load_model("MobileNetV2", weights=None).state_dict()
    assert len(warned) == 1 and "SPARKDL_WEIGHTS_DIR" in warned[0][0]
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_explicit_bad_file_raises(tmp_path, mobilenet_files):
    junk = tmp_path / "x.h5"
    junk.write_bytes(b"not an hdf5 file")
    with pytest.raises(OSError):
        load_model("MobileNetV2", weights=str(junk))
    other = tmp_path / "w.npz"
    other.write_bytes(b"")
    with pytest.raises(ValueError, match="weights files are"):
        load_model("MobileNetV2", weights=str(other))
    paths, _ = mobilenet_files
    # a MobileNetV2 file is not a ResNet50's
    with pytest.raises((KeyError, ValueError)):
        load_model("ResNet50", weights=paths["weights.h5"])
    with pytest.raises((KeyError, ValueError)):
        load_model("ResNet50", weights=paths["keras"])


def test_weights_dir_file_feeds_load_model(tmp_path, monkeypatch,
                                           mobilenet_files):
    """``weights="imagenet"`` (the stages' default) imports the file found
    in ``$SPARKDL_WEIGHTS_DIR``."""
    import shutil

    paths, want = mobilenet_files
    shutil.copy(paths["keras"], tmp_path / "mobilenetv2.keras")
    monkeypatch.setenv("SPARKDL_WEIGHTS_DIR", str(tmp_path))
    assert_state_dicts_equal(
        load_model("MobileNetV2", weights="imagenet").state_dict(), want)
