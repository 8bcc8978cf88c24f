"""``TFInputGraph`` in the port (``graph/{input,tf_import}.py``), held to
the JAX package's on the same graphs: the six constructors over the
TF-written MLP and CNN fixtures (``sparkdl_tpu_torch/graph/data/
tf_fixtures``; resource variables in the MLP, reference variables in the
CNN), with feeds and fetches as ``"op"`` and as ``"op:0"``, at JAX's own
tolerance (``rtol=1e-5, atol=1e-6``, as ``tests/test_tf_input.py``) and
against TensorFlow's stored outputs; the importer op by op; the graphs
both refuse, with the same exception types, and the two the port alone
refuses; the committed full-width InceptionV3 skeleton filled from
``seeded_keras_arrays`` against JAX at 75x75 (1e-5 relative); and
``TFTransformer`` / ``TFImageTransformer`` over a TFInputGraph, saved and
loaded bit for bit."""

import json
import os
import sys

import numpy as np
import pytest

import sparkdl_tpu_torch
from sparkdl_tpu_torch.graph import proto
from sparkdl_tpu_torch.graph.input import TFInputGraph as PortTIG
from sparkdl_tpu_torch.graph.tf_import import graphdef_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import gen_tf_graphs as gen  # noqa: E402

FIXTURES = gen.FIXTURES
TOL = dict(rtol=1e-5, atol=1e-6)        # tests/test_tf_input.py:84-85


def _tf():
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    import tensorflow as tf

    return tf


def _fixture(model):
    d = os.path.join(FIXTURES, model)
    with open(os.path.join(d, "names.json")) as f:
        names = json.load(f)
    io = dict(np.load(os.path.join(d, "io.npz")))
    return d, names, io


def _cpu(mf, x):
    with sparkdl_tpu_torch.default_device("cpu"):
        y = mf(x)
    if isinstance(y, dict):
        return {k: v.numpy() for k, v in y.items()}
    return y.numpy()


def _jax(mf, x):
    y = mf.fn(mf.variables, x)
    if isinstance(y, dict):
        return {k: np.asarray(v) for k, v in y.items()}
    return np.asarray(y)


def _tf_graph_def(path):
    tf = _tf()
    gd = tf.compat.v1.GraphDef()
    with open(path, "rb") as f:
        gd.ParseFromString(f.read())
    return gd


def _build(cls, kind, d, names, form):
    """``kind``'s constructor of ``cls`` over the fixture in ``d``."""
    feeds = [v + form for v in names["feeds"].values()]
    fetches = [v + form for v in names["fetches"].values()]
    if kind == "graphdef":
        gd = _tf_graph_def(os.path.join(d, "frozen.pb"))
        return cls.fromGraphDef(gd, feeds, fetches)
    if kind == "checkpoint":
        return cls.fromCheckpoint(os.path.join(d, "ckpt"), feeds, fetches)
    if kind == "checkpoint_signature":
        return cls.fromCheckpointWithSignature(os.path.join(d, "ckpt"),
                                               names["checkpoint_signature"])
    if kind == "saved_model":
        return cls.fromSavedModel(os.path.join(d, "saved_model"),
                                  names["tags"], feeds, fetches)
    if kind == "saved_model_signature":
        return cls.fromSavedModelWithSignature(
            os.path.join(d, "saved_model"), names["tags"],
            names["saved_model_signature"])
    assert kind == "graph"
    tf = _tf()
    v1 = tf.compat.v1
    graph = v1.Graph()
    with graph.as_default():
        ckpt = tf.train.latest_checkpoint(os.path.join(d, "ckpt"))
        saver = v1.train.import_meta_graph(ckpt + ".meta")
        with v1.Session(graph=graph) as sess:
            saver.restore(sess, ckpt)
            return cls.fromGraph(graph, sess, feeds, fetches)


KINDS = ("graph", "graphdef", "checkpoint", "checkpoint_signature",
         "saved_model", "saved_model_signature")


@pytest.mark.parametrize("form", ["", ":0"], ids=["op", "op:0"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_constructor_matches_jax_and_tensorflow(model, kind, form):
    from sparkdl_tpu.graph.input import TFInputGraph as JaxTIG

    d, names, io = _fixture(model)
    port = _build(PortTIG, kind, d, names, form)
    jax = _build(JaxTIG, kind, d, names, form)
    assert port.input_names == jax.input_names
    assert sorted(port.output_names) == sorted(jax.output_names)
    pmf, jmf = port.model_function(), jax.model_function()
    assert tuple(pmf.input_names) == tuple(jmf.input_names)
    signature = kind.endswith("signature")
    if signature:
        x = {k: io[f"in_{k}"] for k in names["feeds"]}
    else:
        x = {v + form: io[f"in_{k}"] for k, v in names["feeds"].items()}
    arg = next(iter(x.values())) if len(x) == 1 else x
    got, want = _cpu(pmf, arg), _jax(jmf, arg)
    if not isinstance(got, dict):
        got, want = {pmf.output_names[0]: got}, {jmf.output_names[0]: want}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    for k, v in names["fetches"].items():
        key = k if signature else v + form
        np.testing.assert_allclose(got[key], io[f"out_{k}"], **TOL)


def test_graph_constructor_reads_only_the_session():
    """``fromGraph`` with stand-ins for the Graph and Session (what the
    smoke does on a machine without TensorFlow): the graph's serialized
    GraphDef and ``sess.run`` of the variables, nothing else."""
    d, names, io = _fixture("mlp")
    graph, sess = gen.checkpoint_stand_ins(os.path.join(d, "ckpt"))
    tig = PortTIG.fromGraph(graph, sess, ["x"], ["out"])
    np.testing.assert_allclose(_cpu(tig.model_function(), io["in_features"]),
                               io["out_scores"], **TOL)
    assert len(sess.runs) == 1 and len(sess.runs[0]) == 3
    assert all(f.endswith("ReadVariableOp:0") for f in sess.runs[0])


# -- the importer, op by op --------------------------------------------------

def _ops_cases(tf):
    """name -> (build(x) -> y, input shape), each a small graph of ops the
    two importers run."""
    nn = tf.nn
    c = lambda a: tf.constant(np.asarray(a, np.float32))  # noqa: E731
    rng = np.random.default_rng(7)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    return {
        "matmul_transposes": (lambda x: tf.linalg.matmul(
            x, c(rng.normal(size=(5, 4))), transpose_b=True), (3, 4)),
        "matmul_transpose_a": (lambda x: tf.linalg.matmul(
            x, c(rng.normal(size=(3, 2))), transpose_a=True), (3, 4)),
        "elementwise": (lambda x: tf.maximum(tf.minimum(
            tf.square(x) - tf.abs(x) * 0.5 + tf.negative(x), c(3.0)),
            c(-1.0)) / c(2.0), (2, 5)),
        "math": (lambda x: tf.sqrt(tf.abs(x) + 1.0) + tf.math.rsqrt(
            tf.exp(x) + 1.0) + tf.math.log(tf.abs(x) + 2.0)
            + tf.pow(tf.abs(x) + 1.0, c(1.5)), (2, 5)),
        "activations": (lambda x: tf.add_n([
            nn.relu6(x * 4.0), nn.leaky_relu(x), nn.elu(x), nn.selu(x),
            nn.sigmoid(x), tf.tanh(x), nn.softplus(x)]), (2, 6)),
        "leaky_relu_default_alpha": (
            lambda x: tf.raw_ops.LeakyRelu(features=x), (2, 6)),
        "softmaxes": (lambda x: nn.softmax(x) + nn.log_softmax(x), (3, 7)),
        "reductions": (lambda x: tf.reduce_sum(x, axis=[1], keepdims=True)
                       + tf.reduce_max(x, axis=1, keepdims=True)
                       - tf.reduce_min(x, axis=[1], keepdims=True)
                       + tf.reduce_mean(x, axis=[0, 1]), (3, 4, 2)),
        "shapes": (lambda x: tf.transpose(tf.pad(tf.expand_dims(
            tf.squeeze(tf.reshape(x, [2, 1, 6])), -1),
            [[1, 0], [0, 2], [0, 0]]), [2, 0, 1]), (2, 3, 2)),
        "squeeze_dims": (lambda x: tf.squeeze(x, axis=[1]), (4, 1, 3, 1)),
        "cast_concat": (lambda x: tf.concat([tf.cast(tf.cast(
            x * 10.0, tf.int32), tf.float32), x], axis=-1), (2, 3)),
        "conv_dilated_valid": (lambda x: nn.conv2d(
            x, c(k), strides=1, padding="VALID", dilations=2), (2, 9, 9, 3)),
        "conv_same_even_kernel": (lambda x: nn.conv2d(
            x, c(rng.normal(size=(2, 2, 3, 5))), strides=2,
            padding="SAME"), (1, 7, 6, 3)),
        "depthwise_stride2": (lambda x: nn.depthwise_conv2d(
            x, c(rng.normal(size=(3, 3, 3, 2))), strides=[1, 2, 2, 1],
            padding="SAME"), (2, 7, 7, 3)),
        "pools": (lambda x: tf.concat([
            nn.max_pool2d(x, 2, 2, "VALID"), nn.avg_pool2d(x, 2, 2, "VALID"),
            nn.avg_pool2d(x, 3, 2, "SAME"), nn.max_pool2d(x, 3, 2, "SAME")],
            axis=3), (2, 6, 6, 3)),
        "fused_bn_v1": (lambda x: tf.compat.v1.nn.fused_batch_norm(
            x, c([1.0, 2.0, 0.5]), c([0.1, 0.0, -0.1]), c([0.2, -0.3, 0.0]),
            c([1.5, 0.5, 2.0]), epsilon=1e-3, is_training=False)[0],
            (2, 3, 3, 3)),
        "bias_add_div": (lambda x: tf.math.divide(
            nn.bias_add(x, c([1.0, 2.0, 3.0])), c(4.0)), (2, 3)),
    }


OP_CASES = ("matmul_transposes", "matmul_transpose_a", "elementwise",
            "math", "activations", "leaky_relu_default_alpha", "softmaxes",
            "reductions", "shapes", "squeeze_dims", "cast_concat",
            "conv_dilated_valid", "conv_same_even_kernel",
            "depthwise_stride2", "pools", "fused_bn_v1", "bias_add_div")


@pytest.mark.parametrize("case", OP_CASES)
def test_importer_ops_match_jax_and_tensorflow(case):
    from sparkdl_tpu.graph.tf_import import graphdef_to_jax

    tf = _tf()
    v1 = tf.compat.v1
    build, shape = _ops_cases(tf)[case]
    x_in = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    g = v1.Graph()
    with g.as_default():
        x = v1.placeholder(tf.float32, shape, name="x")
        tf.identity(build(x), name="y")
        with v1.Session(graph=g) as sess:
            ref = sess.run("y:0", {x: x_in})
        gd = g.as_graph_def()
    ops = {n.op for n in gd.node}
    got = _cpu(graphdef_to_torch(gd, ["x"], ["y"]), x_in)
    want = _jax(graphdef_to_jax(gd, ["x"], ["y"]), x_in)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6)
    assert ops <= {"Placeholder", "Const", "Identity"} | set(
        __import__("sparkdl_tpu_torch.graph.tf_import",
                   fromlist=["x"]).SUPPORTED_OPS)


def test_supported_op_set_is_jax_s():
    from sparkdl_tpu.graph import tf_import as jax_import
    from sparkdl_tpu_torch.graph import tf_import as port_import

    assert port_import.SUPPORTED_OPS == jax_import._SUPPORTED_OPS
    assert port_import.STRUCTURAL == jax_import._STRUCTURAL
    assert port_import.STATIC_ARG_SLOTS == jax_import._STATIC_ARG_SLOTS


def test_deep_chain_runs_without_recursion():
    """600 chained nodes: the topological order is worked out iteratively
    (as JAX's ``test_importer_deep_chain_no_recursion_error``)."""
    tf = _tf()
    v1 = tf.compat.v1
    graph = v1.Graph()
    with graph.as_default():
        x = v1.placeholder(tf.float32, shape=[None, 3], name="x")
        h = x
        for i in range(600):
            h = tf.add(h, 1.0 / 600, name=f"add_{i}")
        tf.identity(h, name="out")
    mf = graphdef_to_torch(graph.as_graph_def(), ["x"], ["out"])
    got = _cpu(mf, np.zeros((2, 3), np.float32))
    np.testing.assert_allclose(got, np.ones((2, 3)), rtol=1e-4)
    assert len(mf.module.steps) == 601


# -- refusals ----------------------------------------------------------------

def _refusal_graph(case):
    tf = _tf()
    v1 = tf.compat.v1
    g = v1.Graph()
    feeds, fetches = ["x"], ["y"]
    with g.as_default():
        x = v1.placeholder(tf.float32, [2, 4, 4, 3], name="x")
        if case == "unsupported_op_anywhere":
            tf.identity(x + 1.0, name="y")
            tf.cumsum(x, axis=1, name="unrelated")
        elif case == "secondary_output":
            _, mean, _ = v1.nn.fused_batch_norm(
                x, tf.ones([3]), tf.zeros([3]), tf.zeros([3]), tf.ones([3]),
                is_training=False)
            tf.identity(mean, name="y")
        elif case == "unfed_placeholder":
            z = v1.placeholder(tf.float32, [2, 4, 4, 3], name="z")
            tf.identity(x + z, name="y")
        elif case == "dynamic_reshape":
            s = v1.placeholder(tf.int32, [2], name="s")
            tf.reshape(x, s, name="y")
            feeds = ["x", "s"]
        elif case == "missing_fetch":
            tf.identity(x, name="y")
            fetches = ["nope"]
        elif case == "missing_feed":
            tf.identity(x, name="y")
            feeds = ["nope", "x"]
    return g.as_graph_def(), feeds, fetches


REFUSALS = {
    "unsupported_op_anywhere": (NotImplementedError, "Cumsum"),
    "secondary_output": (NotImplementedError, "secondary"),
    "unfed_placeholder": (ValueError, "not covered"),
    "dynamic_reshape": (NotImplementedError, "dynamic"),
    "missing_fetch": (ValueError, "not found"),
    "missing_feed": (ValueError, "not found"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_port_refuses_what_jax_refuses(case):
    """The same exception type as the JAX importer (it finds a dynamic
    shape when it runs; the port at import, before anything runs)."""
    from sparkdl_tpu.graph.tf_import import graphdef_to_jax

    exc, match = REFUSALS[case]
    gd, feeds, fetches = _refusal_graph(case)
    with pytest.raises(exc, match=match):
        mf = graphdef_to_jax(gd, feeds, fetches)
        x = np.zeros((2, 4, 4, 3), np.float32)
        mf.fn(mf.variables, {"x": x, "s": np.array([2, 48], np.int32)})
    with pytest.raises(exc, match=match):
        graphdef_to_torch(gd, feeds, fetches)


def test_missing_signature_lists_the_available_ones():
    from sparkdl_tpu.graph.input import TFInputGraph as JaxTIG

    d, names, _ = _fixture("cnn")
    for cls in (JaxTIG, PortTIG):
        with pytest.raises(ValueError, match="not found") as info:
            cls.fromSavedModelWithSignature(
                os.path.join(d, "saved_model"), "serve", "nope")
        assert "serving_default" in str(info.value)
        with pytest.raises(ValueError, match="my_sig"):
            cls.fromCheckpointWithSignature(os.path.join(d, "ckpt"), "nope")
    with pytest.raises(ValueError, match="No checkpoint"):
        PortTIG.fromCheckpoint(str(d), ["x"], ["feat"])


def test_tf2_function_library_saved_model_is_refused(tmp_path):
    """A TF2 SavedModel keeps its body in a function library behind
    StatefulPartitionedCall, which neither importer runs."""
    from sparkdl_tpu.graph.input import TFInputGraph as JaxTIG

    tf = _tf()

    class M(tf.Module):
        def __init__(self):
            self.w = tf.Variable(np.ones((4, 2), np.float32))

        @tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32)])
        def __call__(self, x):
            return {"y": tf.matmul(x, self.w)}

    path = str(tmp_path / "tf2")
    m = M()
    tf.saved_model.save(m, path, signatures={"serving_default": m.__call__})
    for cls in (JaxTIG, PortTIG):
        with pytest.raises(NotImplementedError,
                           match="StatefulPartitionedCall"):
            cls.fromSavedModelWithSignature(
                path, "serve", "serving_default").model_function()


@pytest.mark.parametrize("case", ["dilated_depthwise", "training_batch_norm"])
def test_documented_deviations_are_refused(case):
    """Two graphs the JAX importer computes wrongly without a word: it
    drops a depthwise convolution's dilations, and applies the moving
    statistics of a batch norm in training mode.  The port refuses both."""
    tf = _tf()
    v1 = tf.compat.v1
    g = v1.Graph()
    with g.as_default():
        x = v1.placeholder(tf.float32, [1, 8, 8, 2], name="x")
        if case == "dilated_depthwise":
            y = tf.raw_ops.DepthwiseConv2dNative(
                input=x, filter=tf.ones([3, 3, 2, 1]), strides=[1, 1, 1, 1],
                padding="SAME", dilations=[1, 2, 2, 1])
        else:
            y = v1.nn.fused_batch_norm(x, tf.ones([2]), tf.zeros([2]),
                                       tf.zeros([2]), tf.ones([2]),
                                       is_training=True,
                                       exponential_avg_factor=0.5)[0]
        tf.identity(y, name="y")
    with pytest.raises(NotImplementedError,
                       match="dilations" if case == "dilated_depthwise"
                       else "is_training"):
        graphdef_to_torch(g.as_graph_def(), ["x"], ["y"])


def test_unsupported_const_dtype_names_the_node():
    tf = _tf()
    v1 = tf.compat.v1
    g = v1.Graph()
    with g.as_default():
        x = v1.placeholder(tf.float32, [2], name="x")
        c = tf.constant([1 + 2j, 3j], dtype=tf.complex64, name="cplx")
        tf.identity(x, name="y")
        tf.identity(c, name="z")
    with pytest.raises(NotImplementedError, match="cplx.*complex64"):
        graphdef_to_torch(g.as_graph_def(), ["x"], ["z"])


# -- the full-width skeleton -------------------------------------------------

@pytest.fixture(scope="module")
def inception():
    with open(gen.INCEPTION_JSON) as f:
        meta = json.load(f)
    arrays = gen.skeleton_arrays(meta)
    return meta, arrays


def test_inception_skeleton_matches_jax(inception):
    """The committed frozen InceptionV3 (2,217 nodes) filled from
    ``seeded_keras_arrays``: the port on the CPU against the JAX importer
    at 75x75, batch 2, within 1e-5 relative (pooled features and
    probabilities)."""
    tf = _tf()
    from tensorflow.python.framework import tensor_util

    from sparkdl_tpu.graph.input import TFInputGraph as JaxTIG

    meta, arrays = inception
    fetches = [meta["pooled"], meta["probabilities"]]
    with open(gen.INCEPTION_PB, "rb") as f:
        data = f.read()
    gd = gen.fill_skeleton(proto.GraphDef.parse(data), arrays)
    assert len(gd.node) == 2217
    port = PortTIG.fromGraphDef(gd, [meta["feed"]], fetches).model_function()
    tgd = tf.compat.v1.GraphDef()
    tgd.ParseFromString(data)
    for n in tgd.node:
        if n.name in arrays:
            n.attr["value"].tensor.CopyFrom(
                tensor_util.make_tensor_proto(arrays[n.name]))
    jax = JaxTIG.fromGraphDef(tgd, [meta["feed"]], fetches).model_function()
    x = gen.inception_preprocess(gen.oracle_batch(n=2, size=75))
    got, want = _cpu(port, x), _jax(jax, x)
    for k in fetches:
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel < 1e-5, (k, rel)
    assert got[meta["pooled"]].shape == (2, 2048)
    assert got[meta["probabilities"]].shape == (2, 1000)


def test_inception_skeleton_matches_tensorflows_oracle(inception):
    """At 299x299 on the CPU the port reads TensorFlow's stored outputs
    (the card's oracle) within 1e-5 relative, and the module holds one
    buffer a weight constant plus the scalars its forward reads."""
    meta, arrays = inception
    with open(gen.INCEPTION_PB, "rb") as f:
        gd = gen.fill_skeleton(proto.GraphDef.parse(f.read()), arrays)
    mf = graphdef_to_torch(gd, [meta["feed"]],
                           [meta["pooled"], meta["probabilities"]])
    got = _cpu(mf, gen.inception_preprocess(gen.oracle_batch()))
    oracle = np.load(gen.INCEPTION_ORACLE)
    for key, name in (("pooled", meta["pooled"]),
                      ("probabilities", meta["probabilities"])):
        rel = (np.linalg.norm(got[name] - oracle[key])
               / np.linalg.norm(oracle[key]))
        assert rel < 1e-5, (key, rel)
    module = mf.module
    weights = [n for n in module.const_names if n.split("[")[0] in arrays]
    assert len(weights) == len(arrays) == 378
    assert 1000 < len(module.steps) < 2217


# -- stages ------------------------------------------------------------------

def _rows_to_images(v):
    """The column holds flat rows; the CNN's graph wants [N, 8, 8, 3]."""
    return {"image": v["image"].reshape(-1, 8, 8, 3)}


def test_tf_transformer_over_tfinputgraph_matches_jax_and_reloads(tmp_path):
    """``TFTransformer`` over the CNN's SavedModel signature (one input
    column, two output columns) equals the JAX stage; saved and loaded
    through ``persistence.py``'s generic path it gives the same output bit
    for bit."""
    from sparkdl_tpu.frame import DataFrame as JaxDF
    from sparkdl_tpu.graph.input import TFInputGraph as JaxTIG
    from sparkdl_tpu.transformers.tensor import TFTransformer as JaxTFT
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.persistence import load_stage, save_stage
    from sparkdl_tpu_torch.transformers.tensor import TFTransformer

    d, names, io = _fixture("cnn")
    sm = os.path.join(d, "saved_model")
    x = io["in_image"]
    rows = {"img": [r.reshape(-1).tolist() for r in x]}
    kw = dict(inputMapping={"img": "image"},
              outputMapping={"features": "f", "logits": "l"}, batchSize=4)
    port_mf = PortTIG.fromSavedModelWithSignature(
        sm, "serve", "serving_default").model_function()
    jax_mf = JaxTIG.fromSavedModelWithSignature(
        sm, "serve", "serving_default").model_function()

    def reshape(mf, lib):
        return lib.from_callable(_rows_to_images, input_names=("image",),
                                 output_names=("image",)).compose(mf)

    from sparkdl_tpu.graph.function import ModelFunction as JaxMF
    from sparkdl_tpu_torch.graph.function import ModelFunction

    stage = TFTransformer(modelFunction=reshape(port_mf, ModelFunction), **kw)
    jstage = JaxTFT(modelFunction=reshape(jax_mf, JaxMF), **kw)
    with sparkdl_tpu_torch.default_device("cpu"):
        out = stage.transform(DataFrame(rows))
        path = save_stage(stage, str(tmp_path / "tft"))
        again = load_stage(path).transform(DataFrame(rows))
    jout = jstage.transform(JaxDF(rows))
    for col, key in (("f", "features"), ("l", "logits")):
        got = out.column_to_numpy(col)
        np.testing.assert_allclose(got, jout.column_to_numpy(col), **TOL)
        np.testing.assert_allclose(got, io[f"out_{key}"], **TOL)
        np.testing.assert_array_equal(again.column_to_numpy(col), got)


def test_tf_image_transformer_over_tfinputgraph_matches_jax():
    """``TFImageTransformer`` hands the ModelFunction the uint8 RGB batch
    (the JAX stage's contract): a float preprocess composed before the
    CNN's frozen graph, over an image column, equals the JAX stage."""
    from sparkdl_tpu.graph.function import ModelFunction as JaxMF
    from sparkdl_tpu.graph.input import TFInputGraph as JaxTIG
    from sparkdl_tpu.image.schema import imageArrayToStruct as jax_struct
    from sparkdl_tpu.transformers.named_image import \
        TFImageTransformer as JaxTIT
    from sparkdl_tpu.frame import DataFrame as JaxDF
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)
    from sparkdl_tpu_torch.transformers.named_image import TFImageTransformer
    import pyarrow as pa

    d, names, _ = _fixture("cnn")
    frozen = os.path.join(d, "frozen.pb")
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
            for _ in range(5)]
    port_mf = ModelFunction.from_callable(
        lambda x: x.float() / 127.5 - 1.0).compose(
        PortTIG.fromGraphDef(frozen, ["x"], ["feat"]).model_function())
    jax_mf = JaxMF.from_callable(lambda x: x / 127.5 - 1.0).compose(
        JaxTIG.fromGraphDef(_tf_graph_def(frozen), ["x"],
                            ["feat"]).model_function())
    stage = TFImageTransformer(inputCol="image", outputCol="out",
                               modelFunction=port_mf, batchSize=2)
    jstage = JaxTIT(inputCol="image", outputCol="out",
                    modelFunction=jax_mf, batchSize=2)
    df = DataFrame(structsToArrow([imageArrayToStruct(i) for i in imgs]))
    jdf = JaxDF(pa.table({"image": pa.array(
        [jax_struct(i) for i in imgs])}))
    with sparkdl_tpu_torch.default_device("cpu"):
        got = stage.transform(df).column_to_numpy("out")
    want = jstage.transform(jdf).column_to_numpy("out")
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_tfinputgraph_is_exported():
    import sparkdl_tpu_torch.graph as graph

    assert sparkdl_tpu_torch.TFInputGraph is PortTIG
    assert sparkdl_tpu_torch.ModelInput is PortTIG
    assert graph.TFInputGraph is PortTIG and graph.ModelInput is PortTIG
