"""The port's Keras converter (``sparkdl_tpu_torch/graph/keras_convert.py``)
held against the JAX package's (``sparkdl_tpu/graph/keras_convert.py``).

Each model is built in Keras here, converted by both packages, and run on
the same numpy-seeded input.  The port's module gets the JAX
ModelFunction's variables through ``state_dict_from_jax``, and the port's
own reading of the model (``to_json()`` and ``get_weights()``, without
Keras) must give the same tensors.  Outputs agree within 1e-5 of the
largest output magnitude (``REL``), per layer type and for whole models.
"""

import importlib.util
import json
import math
import pathlib
from urllib.parse import unquote

import jax
import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu_torch.graph import keras_convert as kc
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models import keras_import

REL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _keras():
    import keras

    return keras


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _randomize_bn(model, rng):
    """Moving statistics and affines away from their init, so inference
    mode reads them."""
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            layer.set_weights([
                rng.uniform(0.5, 1.5, w.shape).astype("float32")
                if w.name in ("gamma", "moving_variance")
                else rng.normal(0, 0.2, w.shape).astype("float32")
                for w in layer.weights])


def _port_pair(model):
    """(JAX ModelFunction, port ModelFunction with the JAX variables)."""
    jmf = JaxModelFunction.from_keras(model)
    variables = jax.tree_util.tree_map(np.asarray, jmf.variables)
    config, layers = kc.read_keras_source(model)
    module = kc.KerasModel(config)
    carried = kc.state_dict_from_jax(module, variables)
    read = module.keras_state_dict(layers)
    assert carried.keys() == read.keys()
    assert all(torch.equal(carried[k], read[k]) for k in carried)
    module.load_state_dict(carried)
    mf = ModelFunction.from_module(module,
                                   input_names=tuple(module.input_names),
                                   output_names=tuple(module.output_names))
    return jmf, mf


def _run_both(model, x):
    jmf, mf = _port_pair(model)
    want = _np(jmf(x))
    got = mf(x)
    got = ({k: v.numpy() for k, v in got.items()} if isinstance(got, dict)
           else got.numpy())
    return got, want


# -- one model per layer type ------------------------------------------------------
def _seq(shape, *layers):
    keras = _keras()
    return keras.Sequential([keras.layers.Input(shape)] + list(layers))


def _merges():
    keras = _keras()
    L = keras.layers
    inp = L.Input((5, 4, 3))
    a = L.Conv2D(3, 1, name="ca")(inp)
    b = L.Conv2D(3, 1, name="cb")(inp)
    outs = [L.Add()([a, b, inp]), L.Subtract()([a, b]),
            L.Multiply()([a, b, inp]), L.Average()([a, b]),
            L.Maximum()([a, b, inp])]
    return keras.Model(inp, L.Concatenate(axis=1)(outs))


def _identities():
    L = _keras().layers
    return _seq((6, 5, 3), L.Dropout(0.5), L.GaussianNoise(0.3),
                L.GaussianDropout(0.3), L.SpatialDropout2D(0.5),
                L.ActivityRegularization(l1=0.1), L.Conv2D(2, 1))


def _bn_variants():
    keras = _keras()
    L = keras.layers
    inp = L.Input((6, 5, 4))
    x = L.BatchNormalization(center=False, name="bn_nc")(inp)
    x = L.BatchNormalization(scale=False, epsilon=0.01, name="bn_ns")(x)
    x = L.BatchNormalization(axis=2, name="bn_w")(x)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(3, name="d")(x)
    return keras.Model(inp, L.BatchNormalization(name="bn_flat")(x))


LAYER_CASES = {
    # name: (builder, input shape (batch first), layer types covered)
    "conv_same_stride2": (lambda: _seq(
        (11, 9, 3), _keras().layers.Conv2D(4, 3, strides=2, padding="same",
                                           activation="relu")),
        (2, 11, 9, 3), {"Conv2D"}),
    "conv_groups2_valid": (lambda: _seq(
        (8, 7, 4), _keras().layers.Conv2D(6, (3, 2), groups=2,
                                          activation="sigmoid")),
        (2, 8, 7, 4), {"Conv2D"}),
    "depthwise_mult2_same_stride2": (lambda: _seq(
        (9, 7, 3), _keras().layers.DepthwiseConv2D(
            3, strides=2, padding="same", depth_multiplier=2,
            activation="relu6")),
        (2, 9, 7, 3), {"DepthwiseConv2D"}),
    "separable_mult2_same": (lambda: _seq(
        (10, 9, 4), _keras().layers.SeparableConv2D(
            5, 3, padding="same", depth_multiplier=2, activation="elu")),
        (2, 10, 9, 4), {"SeparableConv2D"}),
    "separable_stride2_nobias": (lambda: _seq(
        (11, 8, 3), _keras().layers.SeparableConv2D(
            4, 3, strides=2, padding="same", use_bias=False)),
        (2, 11, 8, 3), {"SeparableConv2D"}),
    "dense_rank3": (lambda: _seq(
        (5, 7), _keras().layers.Dense(3, activation="tanh")),
        (2, 5, 7), {"Dense"}),
    "batchnorm_variants": (_bn_variants, (3, 6, 5, 4),
                           {"BatchNormalization", "GlobalAveragePooling2D",
                            "Dense"}),
    "maxpool_same_odd": (lambda: _seq(
        (11, 9, 3), _keras().layers.MaxPooling2D(3, strides=2,
                                                 padding="same")),
        (2, 11, 9, 3), {"MaxPooling2D"}),
    "avgpool_same_odd": (lambda: _seq(
        (11, 9, 3), _keras().layers.AveragePooling2D(3, strides=2,
                                                     padding="same")),
        (2, 11, 9, 3), {"AveragePooling2D"}),
    "pools_valid": (lambda: _seq(
        (9, 8, 3), _keras().layers.AveragePooling2D(2),
        _keras().layers.MaxPooling2D((2, 1), strides=(1, 2))),
        (2, 9, 8, 3), {"AveragePooling2D", "MaxPooling2D"}),
    "global_pools_keepdims": (lambda: _seq(
        (5, 7, 3), _keras().layers.GlobalMaxPooling2D(keepdims=True),
        _keras().layers.GlobalAveragePooling2D()),
        (2, 5, 7, 3), {"GlobalMaxPooling2D", "GlobalAveragePooling2D"}),
    "relu_full": (lambda: _seq(
        (6, 5), _keras().layers.ReLU(max_value=0.8, negative_slope=0.1,
                                     threshold=0.2)),
        (2, 6, 5), {"ReLU"}),
    "leaky_relu_layer": (lambda: _seq(
        (6, 5), _keras().layers.LeakyReLU(negative_slope=0.2)),
        (2, 6, 5), {"LeakyReLU"}),
    "softmax_axis1": (lambda: _seq(
        (6, 5), _keras().layers.Softmax(axis=1)),
        (2, 6, 5), {"Softmax"}),
    "flatten_h_ne_w": (lambda: _seq(
        (5, 3, 4), _keras().layers.Flatten(), _keras().layers.Dense(3)),
        (2, 5, 3, 4), {"Flatten", "Dense"}),
    "reshape_permute": (lambda: _seq(
        (4, 6), _keras().layers.Reshape((3, 8)),
        _keras().layers.Reshape((2, 3, 4)),
        _keras().layers.Permute((3, 1, 2)), _keras().layers.Flatten()),
        (2, 4, 6), {"Reshape", "Permute", "Flatten"}),
    "identities": (_identities, (2, 6, 5, 3),
                   {"Dropout", "GaussianNoise", "GaussianDropout",
                    "SpatialDropout2D", "ActivityRegularization", "Conv2D"}),
    "merges": (_merges, (2, 5, 4, 3),
               {"Add", "Subtract", "Multiply", "Average", "Maximum",
                "Concatenate", "Conv2D"}),
    "zero_padding_asym": (lambda: _seq(
        (5, 4, 2), _keras().layers.ZeroPadding2D(((1, 2), (0, 3))),
        _keras().layers.Conv2D(2, 2)),
        (2, 5, 4, 2), {"ZeroPadding2D", "Conv2D"}),
    "upsampling": (lambda: _seq(
        (3, 4, 2), _keras().layers.UpSampling2D((2, 3)),
        _keras().layers.Conv2D(2, 3)),
        (2, 3, 4, 2), {"UpSampling2D", "Conv2D"}),
    "rescaling": (lambda: _seq(
        (4, 4, 3), _keras().layers.Rescaling(1 / 127.5, offset=-1.0),
        _keras().layers.Rescaling([0.5, 1.0, 2.0], offset=[0.1, 0.0, -0.1]),
        _keras().layers.Conv2D(2, 1)),
        (2, 4, 4, 3), {"Rescaling", "Conv2D"}),
    "activation_layer": (lambda: _seq(
        (7,), *[_keras().layers.Activation(a) for a in (
            "relu", "softplus", "softsign", "selu", "silu", "swish",
            "hard_sigmoid", "exponential", "linear", "log_softmax")]),
        (3, 7), {"Activation"}),
}


def test_layer_cases_cover_every_supported_type():
    covered = set().union(*(c[2] for c in LAYER_CASES.values()))
    assert covered == set(kc.SUPPORTED_TYPES)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_type_matches_jax(case):
    builder, shape, _ = LAYER_CASES[case]
    model = builder()
    _randomize_bn(model, np.random.default_rng(3))
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    got, want = _run_both(model, x)
    _close(got, want)


def test_activation_strings_follow_jax_not_keras():
    """"gelu" is jax.nn.gelu's tanh approximation (Keras' default is
    exact) and "leaky_relu" has slope 0.01 (Keras 3's default is 0.2): the
    port follows the JAX package, whose outputs it must equal."""
    keras = _keras()
    L = keras.layers
    names = ["gelu", "leaky_relu", "relu", "relu6", "sigmoid", "tanh",
             "softmax", "elu", "selu", "silu", "softplus"]
    inp = L.Input((9,))
    model = keras.Model(inp, L.Concatenate()(
        [L.Dense(4, activation=a, name=f"d_{a}")(inp) for a in names]))
    x = np.random.default_rng(11).normal(size=(5, 9)).astype(np.float32) * 2
    got, want = _run_both(model, x)
    _close(got, want)
    keras_out = model.predict(x, verbose=0)
    gelu, leaky = slice(0, 4), slice(4, 8)
    assert np.abs(got[:, gelu] - keras_out[:, gelu]).max() > 1e-4
    pre = x @ model.get_layer("d_leaky_relu").get_weights()[0] \
        + model.get_layer("d_leaky_relu").get_weights()[1]
    np.testing.assert_allclose(got[:, leaky], np.where(pre > 0, pre, 0.01 * pre),
                               rtol=1e-5, atol=1e-6)


# -- whole models, through files -----------------------------------------------------------
def _branchy_cnn():
    """Functional CNN: conv/bn/pool/branch/merge/dense (the JAX package's
    test model), at H != W and with stride-2 SAME ops."""
    keras = _keras()
    L = keras.layers
    inp = L.Input((17, 15, 3))
    x = L.ZeroPadding2D(((1, 1), (1, 1)))(inp)
    x = L.Conv2D(8, 3, strides=2, padding="valid", name="c1")(x)
    x = L.BatchNormalization(name="bn1")(x)
    x = L.ReLU()(x)
    a = L.SeparableConv2D(8, 3, padding="same", name="sep")(x)
    b = L.DepthwiseConv2D(3, padding="same", name="dw")(x)
    x = L.Add()([a, b])
    y = L.AveragePooling2D(2, padding="same")(x)
    z = L.MaxPooling2D(2, padding="same")(x)
    x = L.Concatenate()([y, z])
    x = L.Conv2D(4, 1, activation="relu", name="c2")(x)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dropout(0.5)(x)
    model = keras.Model(inp, L.Dense(3, activation="softmax", name="d")(x))
    _randomize_bn(model, np.random.default_rng(5))
    return model


def _mlp():
    L = _keras().layers
    return _seq((12,), L.Dense(8, activation="tanh"),
                L.Dense(4, activation="softmax"))


def _to_keras2(config):
    """A Keras 3 functional config rewritten in Keras 2's form: nodes as
    ``[[name, node, tensor, {}], ...]``, ``batch_input_shape``, and the
    input and output layers as lists of ``[name, node, tensor]``."""
    body = config["config"]

    def tensors(obj, out):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                out.append(list(obj["config"]["keras_history"]) + [{}])
            else:
                for v in obj.values():
                    tensors(v, out)
        elif isinstance(obj, list):
            for v in obj:
                tensors(v, out)
        return out

    for layer in body["layers"]:
        layer["inbound_nodes"] = [tensors(n["args"], [])
                                  for n in layer["inbound_nodes"]]
        if layer["class_name"] == "InputLayer":
            layer["config"]["batch_input_shape"] = layer["config"].pop(
                "batch_shape")
    for key in ("input_layers", "output_layers"):
        if isinstance(body[key][0], str):
            body[key] = [body[key]]
    return config


@pytest.mark.parametrize("which", ["branchy_cnn", "mlp"])
def test_file_round_trip_matches_jax(which, tmp_path):
    """.keras and .h5 files Keras writes here, and the .h5 with its config
    rewritten in Keras 2's form: both packages read the same file."""
    import h5py

    model = _branchy_cnn() if which == "branchy_cnn" else _mlp()
    shape = (4, 17, 15, 3) if which == "branchy_cnn" else (5, 12)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = model.predict(x, verbose=0)
    paths = []
    for ext in ("keras", "h5"):
        paths.append(str(tmp_path / f"m.{ext}"))
        model.save(paths[-1])
    if which == "branchy_cnn":
        legacy = str(tmp_path / "m_keras2.h5")
        model.save(legacy)
        with h5py.File(legacy, "r+") as f:
            config = json.loads(f.attrs["model_config"])
            f.attrs["model_config"] = json.dumps(_to_keras2(config))
        with h5py.File(legacy, "r") as f:
            body = json.loads(f.attrs["model_config"])["config"]
        assert body["layers"][1]["inbound_nodes"] == [
            [[body["layers"][0]["name"], 0, 0, {}]]]
        paths.append(legacy)
    for path in paths:
        want = np.asarray(JaxModelFunction.from_keras(path)(x))
        got = ModelFunction.from_keras(path)(x).numpy()
        _close(want, ref, rel=1e-4)
        _close(got, want)


def test_multi_input_output_names_and_dicts():
    keras = _keras()
    L = keras.layers
    a = L.Input((4,), name="a")
    b = L.Input((4,), name="b")
    h = L.Add()([a, b])
    model = keras.Model([a, b], [L.Dense(2, name="o1")(h),
                                 L.Subtract(name="diff")([a, b])])
    rng = np.random.default_rng(2)
    x = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(3, 4)).astype(np.float32)}
    jmf, mf = _port_pair(model)
    # inputs: the input layers' names, as JAX names them; outputs: the
    # output layers' names, where JAX has Keras' per-process tensor names,
    # in the same order
    assert tuple(mf.input_names) == tuple(jmf.input_names) == ("a", "b")
    assert tuple(mf.output_names) == ("o1", "diff")
    assert len(jmf.output_names) == 2
    want = _np(jmf(x))
    got = mf(x)
    for jname, name in zip(jmf.output_names, mf.output_names):
        _close(got[name].numpy(), want[jname])
    with pytest.raises(ValueError, match="pass a dict"):
        mf(x["a"])
    with pytest.raises(ValueError, match="Missing model inputs"):
        mf({"a": x["a"]})


def test_shared_layer_nodes_match_jax():
    """A layer applied twice (two nodes of one weighted layer) and a
    branch that does not reach the output."""
    keras = _keras()
    L = keras.layers
    inp = L.Input((6, 5, 3))
    x = L.Conv2D(4, 3, padding="same", name="c")(inp)
    shared = L.Dense(2, name="shared")
    unused = L.Dense(7, name="unused")(x)  # noqa: F841
    y = L.Conv2D(4, 1, name="c2")(inp)
    model = keras.Model(inp, L.Concatenate()([shared(x), shared(y)]))
    x_in = np.random.default_rng(12).normal(size=(2, 6, 5, 3)).astype(
        np.float32)
    got, want = _run_both(model, x_in)
    _close(got, want)


def test_compose_matches_jax():
    """``compose`` of a function without tensors, a module and a converted
    Keras model, against the JAX composition on the same weights."""
    w = np.eye(3, dtype=np.float32) * 4

    class MatMul(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w))

        def forward(self, x):
            return x @ self.w

    L = _keras().layers
    model = _seq((3,), L.Dense(2, activation="tanh", name="head"))
    jkeras, pkeras = _port_pair(model)
    jcomp = JaxModelFunction.from_callable(lambda x: x / 2.0).compose(
        JaxModelFunction(fn=lambda v, x: x @ v["w"], variables={"w": w})
    ).compose(jkeras)
    comp = ModelFunction.from_callable(lambda x: x / 2.0).compose(
        ModelFunction.from_module(MatMul())).compose(pkeras)
    assert set(comp.module) == {"f", "g"}
    assert set(dict(comp.module.named_children())["f"]) == {"f", "g"}
    x = np.random.default_rng(4).normal(size=(2, 3)).astype(np.float32)
    _close(comp(x).numpy(), np.asarray(jcomp(x)))
    assert comp.output_names == pkeras.output_names


def test_unsupported_layer_fails_before_anything_is_built():
    L = _keras().layers
    model = _seq((4, 3), L.LSTM(2))
    with pytest.raises(NotImplementedError, match=r"LSTM\(lstm"):
        ModelFunction.from_keras(model)
    with pytest.raises(NotImplementedError, match="LSTM"):
        JaxModelFunction.from_keras(model)


def test_config_errors():
    L = _keras().layers
    model = _seq((6, 6, 3), L.Conv2D(2, 3, dilation_rate=2))
    with pytest.raises(NotImplementedError, match="Dilated"):
        ModelFunction.from_keras(model)
    config, layers = kc.read_keras_source(_mlp())
    module = kc.KerasModel(config)
    with pytest.raises(ValueError, match="No Keras arrays"):
        module.keras_state_dict(layers[:1])
    with pytest.raises(KeyError, match="not a weighted layer"):
        module.keras_state_dict(layers + [("nope", "Dense", [])])
    bad = [keras_import.KerasLayer(l.name, l.class_name,
                                   [w.T for w in l.weights])
           for l in layers]
    with pytest.raises(ValueError, match="Shape mismatch"):
        module.keras_state_dict(bad)
    dup = json.loads(json.dumps(config))
    dup["config"]["layers"][2]["config"]["name"] = \
        dup["config"]["layers"][1]["config"]["name"]
    with pytest.raises(ValueError, match="Duplicate layer name"):
        kc.KerasModel(dup)
    with pytest.raises(ValueError, match="weights.h5"):
        kc.read_keras_source("m.weights.h5")


@pytest.mark.parametrize("name", ["conv.1", "keys", "a%2Eb", "forward",
                                  "plain"])
def test_layer_key_round_trip(name):
    key = kc.layer_key(name)
    assert "." not in key and unquote(key) == name
    torch.nn.ModuleDict({key: torch.nn.Identity()})


# -- the committed InceptionV3 config ----------------------------------------------
def _tool():
    spec = importlib.util.spec_from_file_location(
        "gen_keras_configs", ROOT / "tools" / "gen_keras_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _committed_config():
    with open(ROOT / "sparkdl_tpu_torch" / "graph" / "data"
              / "keras_inception_v3.json") as f:
        return json.load(f)


def _seeded_layers(name, seed):
    """Keras-layout arrays of zoo model ``name``'s weighted layers (the
    committed layer table's names and shapes), drawn as ``chip_smoke.py``
    draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for lname, cls, shapes in keras_import.keras_layer_table()[name]:
        if cls == "BatchNormalization":  # [gamma,] beta, mean, variance
            arrays = ([rng.uniform(0.8, 1.2, s) for s in shapes[:-3]]
                      + [rng.normal(0, 0.05, s) for s in shapes[-3:-1]]
                      + [rng.uniform(0.8, 1.2, shapes[-1])])
        else:
            arrays = [rng.normal(0, 1 / math.sqrt(np.prod(shapes[0][:-1])),
                                 shapes[0])]
            if len(shapes) > 1:
                arrays.append(rng.normal(0, 0.05, shapes[1]))
        out.append(keras_import.KerasLayer(
            lname, cls, [a.astype(np.float32) for a in arrays]))
    return out


def test_committed_inception_config_rows_are_the_layer_table():
    config = _committed_config()
    module = kc.KerasModel(config)
    table = keras_import.keras_layer_table()["InceptionV3"]
    rows = [(l["name"], l["class_name"]) for l in config["config"]["layers"]
            if l["class_name"] in kc.WEIGHTED]
    assert rows == [(name, cls) for name, cls, _ in table]
    assert set(module.weighted_nodes()) == {name for name, _ in rows}
    assert len(config["config"]["layers"]) == 313
    assert kc.keras_input_hw(config) == (299, 299)
    # every table shape fits the module the config builds
    module.keras_state_dict(_seeded_layers("InceptionV3", 0))


def test_committed_inception_config_matches_zoo_inception():
    """The committed config at 75x75, batch 2, against the port's zoo
    InceptionV3 on the same Keras-layout arrays: probabilities within
    1e-4 of the largest."""
    from sparkdl_tpu_torch.models import import_keras_weights, load_model
    from sparkdl_tpu_torch.models.preprocess import preprocess_tf

    layers = _seeded_layers("InceptionV3", 9)
    zoo = load_model("InceptionV3")
    zoo.load_state_dict(import_keras_weights("InceptionV3", layers))
    mf = ModelFunction.from_keras(keras_import.keras_file(
        _committed_config(), layers))
    x = np.random.default_rng(8).integers(0, 256, (2, 75, 75, 3),
                                          dtype=np.uint8)
    xf = preprocess_tf(torch.from_numpy(x))
    with torch.no_grad():
        want = zoo(xf).numpy()
    got = mf(xf).numpy()
    assert got.shape == (2, 1000)
    _close(got, want, rel=1e-4)
    np.testing.assert_array_equal(np.argsort(-got, 1)[:, :5],
                                  np.argsort(-want, 1)[:, :5])


def test_trimmed_config_is_the_tool_output_and_converts_identically():
    """The committed file is what the tool writes for a fresh Keras
    InceptionV3, and the trimmed config and the untrimmed ``to_json()``
    config convert to modules whose outputs are equal bit for bit."""
    tool = _tool()
    keras = _keras()
    model = keras.applications.InceptionV3(weights=None)
    raw = json.loads(model.to_json())
    trimmed = tool.trim(raw)
    assert trimmed == _committed_config()
    renames = tool.auto_renames(raw["config"]["layers"])
    layers = _seeded_layers("InceptionV3", 4)
    back = {new: old for old, new in renames.items()}
    raw_layers = [keras_import.KerasLayer(back.get(l.name, l.name),
                                          l.class_name, l.weights)
                  for l in layers]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 75, 75, 3)).astype(np.float32))
    a = ModelFunction.from_keras(keras_import.keras_file(trimmed, layers))(x)
    b = ModelFunction.from_keras(keras_import.keras_file(raw, raw_layers))(x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["dense/BiasAdd:0", "x", "a:3", "bad:x:1"])
def test_graph_utils_match_jax(name):
    from sparkdl_tpu.graph import utils as jax_utils
    from sparkdl_tpu_torch.graph import utils

    ops = ["dense/BiasAdd", "x", "a"]
    for fn in ("op_name", "tensor_name", "output_index", "validated_input",
               "validated_output"):
        args = (name, ops) if fn.startswith("validated") else (name,)
        try:
            want = getattr(jax_utils, fn)(*args)
        except (ValueError, TypeError) as e:
            with pytest.raises(type(e)):
                getattr(utils, fn)(*args)
        else:
            assert getattr(utils, fn)(*args) == want
