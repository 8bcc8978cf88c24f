"""The named-image stages serving BASELINE config 2's models (ResNet50 and
VGG16) in the port, held against the JAX package's stages on the CPU over
the conftest's real JPEG fixtures, with top-K decoded through a local
ImageNet class index.

  * ResNet50: both packages' stages load the weights Keras wrote into
    ``$SPARKDL_WEIGHTS_DIR/ResNet50.weights.h5`` (the stages' default,
    ``weights="imagenet"``), and decode with
    ``$SPARKDL_WEIGHTS_DIR/imagenet_class_index.json``;
  * VGG16: the same seeded variables in both zoo caches, decoded with
    ``$SPARKDL_CLASS_INDEX``.

Both registries' spec is narrowed to a small input for the test (64x64 for
ResNet50; 32x32 for VGG16, whose ``fc1`` is built for it); widths stay
full.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu_torch
import sparkdl_tpu.models.imagenet as jax_imagenet
import sparkdl_tpu.transformers.named_image as jax_ni
import sparkdl_tpu_torch.models.imagenet as port_imagenet
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu.image.io import readImages as jax_readImages
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu_torch.image.io import readImages
from sparkdl_tpu_torch.models import convert, load_model
from sparkdl_tpu_torch.models import get_model_spec as port_spec
from sparkdl_tpu_torch.models.vgg import VGG16

# Both sides run f32 on the CPU: only the summation order differs.
TOL = dict(rtol=1e-3, atol=1e-3)


def _class_index(path):
    index = {str(i): [f"n{i:08d}", f"thing_{i}"] for i in range(1000)}
    path.write_text(json.dumps(index))
    return index


@pytest.fixture
def narrow(monkeypatch):
    """Both registries' spec of a model narrowed to ``size``; fresh zoo and
    class-index caches; the port on the CPU."""
    def apply(name, size):
        j = dataclasses.replace(jax_spec(name), input_size=(size, size))
        p = dataclasses.replace(port_spec(name), input_size=(size, size))
        monkeypatch.setattr(jax_ni, "get_model_spec", lambda n: j)
        monkeypatch.setattr(port_ni, "get_model_spec", lambda n: p)

    monkeypatch.setattr(jax_ni, "_ENGINE_CACHE", {})
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    for mod in (jax_ni, port_ni):
        monkeypatch.setattr(mod, "_MODEL_CACHE", {})
    monkeypatch.delenv("SPARKDL_CLASS_INDEX", raising=False)
    monkeypatch.delenv("SPARKDL_WEIGHTS_DIR", raising=False)
    for lib in (jax_imagenet, port_imagenet):
        lib.reset_class_index_cache()
    with sparkdl_tpu_torch.default_device("cpu"):
        yield apply
    for lib in (jax_imagenet, port_imagenet):
        lib.reset_class_index_cache()


def _rows(ni, read, d, name, top):
    kw = dict(inputCol="image", outputCol="preds", modelName=name,
              decodePredictions=True, topK=top, batchSize=2)
    return ni.DeepImagePredictor(**kw).transform(read(d)).table.column(
        "preds").to_pylist()


def _assert_rows_match(got, want, index, top):
    assert got[3] is None and want[3] is None  # the undecodable file
    for g, w in zip(got[:3], want[:3]):
        assert len(g) == top
        assert [p["class"] for p in g] == [p["class"] for p in w]
        assert all(p["description"] == index[str(int(p["class"][1:]))][1]
                   for p in g)
        np.testing.assert_allclose([p["probability"] for p in g],
                                   [p["probability"] for p in w],
                                   rtol=1e-3, atol=1e-7)


def test_resnet50_stage_serves_the_weights_dir_file(narrow, monkeypatch,
                                                    tmp_path, fixture_images):
    import keras

    narrow("ResNet50", 64)
    model = keras.applications.ResNet50(weights=None)
    rng = np.random.default_rng(71)
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            layer.set_weights([w + rng.normal(0, 0.05, w.shape).astype(
                np.float32) for w in layer.get_weights()])
    model.save_weights(str(tmp_path / "ResNet50.weights.h5"))
    index = _class_index(tmp_path / "imagenet_class_index.json")
    monkeypatch.setenv("SPARKDL_WEIGHTS_DIR", str(tmp_path))

    got = _rows(port_ni, readImages, fixture_images["dir"], "ResNet50", 3)
    want = _rows(jax_ni, jax_readImages, fixture_images["dir"], "ResNet50", 3)
    _assert_rows_match(got, want, index, 3)
    # the stage's model holds the file's weights, not the seeded init
    served = port_ni._cached_model("ResNet50")
    kernel = model.get_layer("conv1_conv").get_weights()[0]
    assert torch.equal(served.conv1_conv.weight,
                       torch.from_numpy(kernel).permute(3, 2, 0, 1))
    assert not torch.equal(served.conv1_conv.weight,
                           load_model("ResNet50", weights=None)
                           .conv1_conv.weight)


def test_vgg16_stages_match_jax_with_class_index(narrow, monkeypatch,
                                                 tmp_path, fixture_images):
    narrow("VGG16", 32)
    jm = jax_spec("VGG16").build()
    x = np.zeros((1, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(lambda r: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(72)

    def fill(path, s):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2 / fan), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    monkeypatch.setitem(jax_ni._MODEL_CACHE, ("VGG16", ""), (jm, variables))
    pm = VGG16(input_size=(32, 32))
    pm.load_state_dict(convert.state_dict_from_jax(
        "VGG16", variables, input_size=(32, 32)))
    monkeypatch.setitem(port_ni._MODEL_CACHE, ("VGG16", ""), pm.eval())
    index = _class_index(tmp_path / "index.json")
    monkeypatch.setenv("SPARKDL_CLASS_INDEX", str(tmp_path / "index.json"))

    got = _rows(port_ni, readImages, fixture_images["dir"], "VGG16", 5)
    want = _rows(jax_ni, jax_readImages, fixture_images["dir"], "VGG16", 5)
    _assert_rows_match(got, want, index, 5)

    kw = dict(inputCol="image", outputCol="features", modelName="VGG16",
              batchSize=2)
    gf = port_ni.DeepImageFeaturizer(**kw).transform(
        readImages(fixture_images["dir"])).table.column(
        "features").to_pylist()
    wf = jax_ni.DeepImageFeaturizer(**kw).transform(
        jax_readImages(fixture_images["dir"])).table.column(
        "features").to_pylist()
    assert gf[3] is None and len(gf[0]) == 4096
    np.testing.assert_allclose(np.asarray(gf[:3], np.float32),
                               np.asarray(wf[:3], np.float32), **TOL)
