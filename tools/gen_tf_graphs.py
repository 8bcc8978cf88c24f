"""Write the TensorFlow graphs that the port's ``TFInputGraph`` is held to,
into ``sparkdl_tpu_torch/graph/data/``:

* ``tf_inception_v3.pb``: Keras' ``InceptionV3(weights=None)`` at 299x299
  (the architecture of ``keras_inception_v3.json``), frozen by TensorFlow
  (``convert_variables_to_constants_v2``), with every weight constant's
  ``tensor_content`` cleared (dtype and shape kept; shape, axis and epsilon
  constants stay whole): a skeleton of ~0.4 MB instead of ~96 MB;
* ``tf_inception_v3.json``: the skeleton's feed and fetch names (the input
  placeholder, the pooled features' ``Mean`` and the ``Softmax``), each
  weight constant's name mapped to its Keras variable path and shape, and
  how TF's oracle below was made;
* ``tf_inception_v3_oracle.npz``: TensorFlow's own outputs (pooled
  features and probabilities) of the frozen graph filled with
  :func:`seeded_keras_arrays`, for a seeded batch of 2 at 299x299;
* ``tf_fixtures/{mlp,cnn}/``: TF1-style models written by TensorFlow — a
  ``Saver`` checkpoint whose stored ``.meta`` carries a ``signature_def``
  (``ckpt/``), a SavedModel with ``serving_default`` (``saved_model/``), a
  frozen GraphDef (``frozen.pb``), and ``io.npz`` with their inputs and
  TF's outputs.  The MLP's variables are resource variables (``VarHandleOp``
  / ``ReadVariableOp`` / ``AssignVariableOp``), the CNN's are reference
  variables (``VariableV2`` / ``Assign``); the CNN runs Conv2D with stride 2
  and SAME padding, BiasAdd, FusedBatchNormV3, DepthwiseConv2dNative,
  MaxPool and AvgPool with asymmetric SAME padding, ConcatV2, Mean and
  MatMul.

    KERAS_BACKEND=tensorflow python3 tools/gen_tf_graphs.py

Needs TensorFlow and Keras on the CPU, which are imported inside
:func:`write` only: :func:`seeded_keras_arrays` and :func:`oracle_batch`
import nothing but numpy, so that the tests and ``chip_smoke.py`` (on a
machine without TensorFlow) use these same definitions.  Run it in a fresh
process: Keras names layers by a per-process counter (``conv2d_5``), and the
variable paths below are those of a process that built nothing before.
About a minute; downloads nothing.
"""

import json
import os
from typing import Dict, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "sparkdl_tpu_torch", "graph", "data")
INCEPTION_PB = os.path.join(DATA, "tf_inception_v3.pb")
INCEPTION_JSON = os.path.join(DATA, "tf_inception_v3.json")
INCEPTION_ORACLE = os.path.join(DATA, "tf_inception_v3_oracle.npz")
FIXTURES = os.path.join(DATA, "tf_fixtures")

WEIGHTS_SEED = 0        # seeded_keras_arrays' seed for the skeleton
ORACLE_SEED = 12        # oracle_batch's seed
ORACLE_BATCH = 2
ORACLE_SIZE = 299


def _role_array(rng, path: str, shape: Sequence[int]) -> np.ndarray:
    leaf = path.rsplit("/", 1)[-1]
    shape = tuple(int(s) for s in shape)
    if leaf in ("kernel", "depthwise_kernel", "pointwise_kernel"):
        fan_in = (int(np.prod(shape[:2])) if leaf == "depthwise_kernel"
                  else int(np.prod(shape[:-1])))
        return rng.normal(0.0, np.sqrt(2.0 / max(fan_in, 1)), shape)
    if leaf == "moving_variance":
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "gamma":
        return rng.uniform(0.9, 1.1, shape)
    # beta, moving_mean, bias and anything else: small
    return rng.normal(0.0, 0.05, shape)


def seeded_keras_arrays(shapes: Dict[str, Sequence[int]], seed: int
                        ) -> Dict[str, np.ndarray]:
    """Seeded float32 arrays for Keras variables ``{path: shape}``, drawn
    in sorted path order from one generator, each role from its own
    distribution: kernels N(0, 2/fan_in), ``moving_variance`` U[0.5, 1.5],
    ``gamma`` U[0.9, 1.1], beta, ``moving_mean`` and bias N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    return {p: _role_array(rng, p, shapes[p]).astype(np.float32)
            for p in sorted(shapes)}


def oracle_batch(seed: int = ORACLE_SEED, n: int = ORACLE_BATCH,
                 size: int = ORACLE_SIZE) -> np.ndarray:
    """The uint8 RGB batch TF's oracle was computed on."""
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def inception_preprocess(batch: np.ndarray) -> np.ndarray:
    """Keras' InceptionV3 ``preprocess_input`` in float32: x / 127.5 - 1."""
    return batch.astype(np.float32) / 127.5 - 1.0


def skeleton_arrays(meta: dict, seed: int = WEIGHTS_SEED
                    ) -> Dict[str, np.ndarray]:
    """``{weight constant name: array}`` of the InceptionV3 skeleton, from
    :func:`seeded_keras_arrays` over its Keras variables (``meta`` is
    ``tf_inception_v3.json``)."""
    shapes = {path: shape for path, shape in meta["weights"].values()}
    arrays = seeded_keras_arrays(shapes, seed)
    return {name: arrays[path] for name, (path, _) in meta["weights"].items()}


def fill_skeleton(graph_def, arrays: Dict[str, np.ndarray]):
    """Set the weight constants of the port's parsed GraphDef
    (``sparkdl_tpu_torch.graph.proto``) to ``arrays``, in place."""
    from sparkdl_tpu_torch.graph import proto

    for node in graph_def.node:
        if node.name in arrays:
            node.attr["value"] = proto.AttrValue.of_tensor(
                proto.tensor_from_numpy(arrays[node.name]))
    return graph_def


def checkpoint_stand_ins(ckpt_dir: str):
    """``(graph, session)`` that stand in for TensorFlow's in
    ``TFInputGraph.fromGraph`` where there is none: ``graph.as_graph_def()``
    gives the latest checkpoint's stored GraphDef, and ``session.run``
    gives each fetched variable's value from the checkpoint under the
    variable's own name (a ``ReadVariableOp`` reads its handle's), and
    records the fetches of each call in ``session.runs``."""
    from sparkdl_tpu_torch.graph import proto
    from sparkdl_tpu_torch.graph.bundle import BundleReader, latest_checkpoint

    ckpt = latest_checkpoint(ckpt_dir)
    with open(ckpt + ".meta", "rb") as f:
        graph_def = proto.MetaGraphDef.parse(f.read()).graph_def
    reader = BundleReader(ckpt)
    nodes = {n.name: n for n in graph_def.node}

    class Graph:
        def as_graph_def(self):
            return graph_def

    class Session:
        def __init__(self):
            self.runs = []

        def run(self, fetches):
            self.runs.append(list(fetches))
            out = []
            for t in fetches:
                name = t.split(":")[0]
                if nodes[name].op == "ReadVariableOp":
                    name = nodes[name].input[0]
                out.append(reader.tensor(name))
            return out

    return Graph(), Session()


# -- the writer (TensorFlow from here on) --------------------------------


def _tf():
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    os.environ.setdefault("KERAS_BACKEND", "tensorflow")
    import tensorflow as tf

    return tf


def _run_graph_def(tf, gd, feed: str, fetches, x):
    g = tf.Graph()
    with g.as_default():
        tf.graph_util.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=g) as sess:
            return sess.run([f + ":0" for f in fetches], {feed + ":0": x})


def write_inception(tf) -> dict:
    import keras
    from tensorflow.python.framework import tensor_util
    from tensorflow.python.framework.convert_to_constants import \
        convert_variables_to_constants_v2

    model = keras.applications.InceptionV3(weights=None)
    shapes = {v.path: tuple(v.shape) for v in model.weights}
    arrays = seeded_keras_arrays(shapes, WEIGHTS_SEED)
    for v in model.weights:
        v.assign(arrays[v.path])
    fn = tf.function(lambda x: model(x, training=False))
    cf = fn.get_concrete_function(
        tf.TensorSpec([None, ORACLE_SIZE, ORACLE_SIZE, 3], tf.float32,
                      name="input"))
    gd = convert_variables_to_constants_v2(cf).graph.as_graph_def()
    by_bytes = {a.tobytes(): p for p, a in arrays.items()}
    weights, feed = {}, None
    means, softmaxes = [], []
    for node in gd.node:
        if node.op == "Placeholder":
            feed = node.name
        elif node.op == "Mean":
            means.append(node.name)
        elif node.op == "Softmax":
            softmaxes.append(node.name)
        elif node.op == "Const":
            arr = tensor_util.MakeNdarray(node.attr["value"].tensor)
            path = by_bytes.get(arr.tobytes())
            if path is not None and tuple(arr.shape) == shapes[path]:
                weights[node.name] = [path, list(arr.shape)]
    assert len(means) == 1 and len(softmaxes) == 1, (means, softmaxes)
    assert set(p for p, _ in weights.values()) == set(shapes), \
        "a Keras variable has no constant in the frozen graph"
    assert not gd.library.function, "the frozen graph has a function library"
    x = inception_preprocess(oracle_batch())
    pooled, probs = _run_graph_def(tf, gd, feed, [means[0], softmaxes[0]], x)
    for node in gd.node:
        if node.name in weights:
            node.attr["value"].tensor.tensor_content = b""
    with open(INCEPTION_PB, "wb") as f:
        f.write(gd.SerializeToString())
    np.savez_compressed(INCEPTION_ORACLE, pooled=pooled.astype(np.float32),
                        probabilities=probs.astype(np.float32))
    meta = {
        "model": "keras.applications.InceptionV3(weights=None), frozen by "
                 "convert_variables_to_constants_v2",
        "tensorflow": tf.__version__, "keras": keras.__version__,
        "feed": feed, "pooled": means[0], "probabilities": softmaxes[0],
        "weights_seed": WEIGHTS_SEED,
        "oracle": {"seed": ORACLE_SEED, "batch": ORACLE_BATCH,
                   "size": ORACLE_SIZE,
                   "preprocess": "x / 127.5 - 1 in float32"},
        "weights": dict(sorted(weights.items())),
    }
    with open(INCEPTION_JSON, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return meta


def _save_all(tf, sess, graph, out_dir, feeds, fetches, x):
    """A checkpoint whose .meta holds a signature_def, a SavedModel and a
    frozen GraphDef of ``graph``; the inputs and TF's outputs."""
    v1 = tf.compat.v1
    ckpt_dir = os.path.join(out_dir, "ckpt")
    sm_dir = os.path.join(out_dir, "saved_model")
    os.makedirs(ckpt_dir, exist_ok=True)
    ts = {k: graph.get_tensor_by_name(v + ":0") for k, v in feeds.items()}
    outs = {k: graph.get_tensor_by_name(v + ":0") for k, v in fetches.items()}
    ref = sess.run(outs, {ts[k]: x[k] for k in feeds})
    sig = v1.saved_model.signature_def_utils.predict_signature_def(
        inputs=ts, outputs=outs)
    saver = v1.train.Saver()
    path = saver.save(sess, os.path.join(ckpt_dir, "model"))
    # the state file names the checkpoint relative to its directory, as a
    # checkpoint that moved with its directory does
    with open(os.path.join(ckpt_dir, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "model"\n'
                'all_model_checkpoint_paths: "model"\n')
    meta = saver.export_meta_graph(clear_devices=True)
    meta.signature_def["my_sig"].CopyFrom(sig)
    with open(path + ".meta", "wb") as f:
        f.write(meta.SerializeToString())
    builder = v1.saved_model.Builder(sm_dir)
    builder.add_meta_graph_and_variables(
        sess, ["serve"], signature_def_map={"serving_default": sig})
    builder.save()
    frozen = v1.graph_util.convert_variables_to_constants(
        sess, graph.as_graph_def(), list(fetches.values()))
    with open(os.path.join(out_dir, "frozen.pb"), "wb") as f:
        f.write(frozen.SerializeToString())
    np.savez(os.path.join(out_dir, "io.npz"),
             **{f"in_{k}": v for k, v in x.items()},
             **{f"out_{k}": v for k, v in ref.items()})
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump({"feeds": feeds, "fetches": fetches,
                   "checkpoint_signature": "my_sig",
                   "saved_model_signature": "serving_default",
                   "tags": "serve"}, f, indent=1)
        f.write("\n")


def write_mlp(tf):
    v1 = tf.compat.v1
    rng = np.random.default_rng(3)
    x_in = rng.normal(size=(6, 4)).astype(np.float32)
    graph = v1.Graph()
    with graph.as_default():
        x = v1.placeholder(tf.float32, [None, 4], name="x")
        w1 = v1.get_variable("w1", initializer=rng.normal(
            size=(4, 8)).astype(np.float32))
        b1 = v1.get_variable("b1", initializer=rng.normal(
            0, 0.1, size=8).astype(np.float32))
        h = tf.nn.relu(tf.matmul(x, w1) + b1, name="hidden")
        w2 = v1.get_variable("w2", initializer=rng.normal(
            size=(8, 3)).astype(np.float32))
        tf.nn.softmax(tf.matmul(h, w2), name="out")
        with v1.Session(graph=graph) as sess:
            sess.run(v1.global_variables_initializer())
            _save_all(tf, sess, graph, os.path.join(FIXTURES, "mlp"),
                      {"features": "x"}, {"scores": "out"},
                      {"features": x_in})


def write_cnn(tf):
    v1 = tf.compat.v1
    rng = np.random.default_rng(4)
    x_in = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)

    def var(name, arr):
        return v1.get_variable(name, initializer=arr.astype(np.float32),
                               use_resource=False)

    graph = v1.Graph()
    with graph.as_default():
        x = v1.placeholder(tf.float32, [None, 8, 8, 3], name="x")
        k = var("conv_k", rng.normal(0, 0.5, (3, 3, 3, 4)))
        b = var("conv_b", rng.normal(0, 0.1, 4))
        y = tf.nn.conv2d(x, k, strides=[1, 2, 2, 1], padding="SAME")
        y = tf.nn.bias_add(y, b)
        y, _, _ = v1.nn.fused_batch_norm(
            y, var("bn_gamma", rng.uniform(0.8, 1.2, 4)),
            var("bn_beta", rng.normal(0, 0.1, 4)),
            mean=var("bn_mean", rng.normal(0, 0.1, 4)),
            variance=var("bn_var", rng.uniform(0.5, 1.5, 4)),
            epsilon=1e-3, is_training=False)
        y = tf.nn.relu(y)
        y = tf.nn.depthwise_conv2d(
            y, var("dw_k", rng.normal(0, 0.5, (3, 3, 4, 2))),
            strides=[1, 1, 1, 1], padding="SAME")
        a = tf.nn.max_pool2d(y, 3, 2, padding="SAME")
        c = tf.nn.avg_pool2d(y, 3, 2, padding="SAME")
        y = tf.concat([a, c], axis=3)
        feat = tf.reduce_mean(y, axis=[1, 2], name="feat")
        logits = tf.nn.bias_add(
            tf.matmul(feat, var("fc_w", rng.normal(0, 0.5, (16, 3)))),
            var("fc_b", rng.normal(0, 0.1, 3)), name="logits")
        with v1.Session(graph=graph) as sess:
            sess.run(v1.global_variables_initializer())
            _save_all(tf, sess, graph, os.path.join(FIXTURES, "cnn"),
                      {"image": "x"}, {"features": "feat", "logits": "logits"},
                      {"image": x_in})


def write():
    tf = _tf()
    meta = write_inception(tf)
    write_mlp(tf)
    write_cnn(tf)
    print(f"wrote {INCEPTION_PB} ({os.path.getsize(INCEPTION_PB)} bytes, "
          f"{len(meta['weights'])} weight constants) and {FIXTURES}")


if __name__ == "__main__":
    write()
