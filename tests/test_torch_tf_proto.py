"""The port's protobuf wire-format reader (``graph/proto.py``) and V2
checkpoint reader (``graph/bundle.py``), held to TensorFlow's own parse:
every field number against the installed ``_pb2`` descriptors, every node,
attr and tensor of the committed InceptionV3 skeleton and of each
TF-written fixture against ``GraphDef.ParseFromString`` and
``tensor_util.MakeNdarray``, and every checkpoint tensor against
``tf.train.load_checkpoint``, exactly."""

import os
import shutil

import numpy as np
import pytest

from sparkdl_tpu_torch.graph import bundle, proto

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "sparkdl_tpu_torch", "graph", "data")
FIXTURES = os.path.join(DATA, "tf_fixtures")
MODELS = ("mlp", "cnn")


def _tf():
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    import tensorflow as tf

    return tf


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def tensor_to_numpy(t):
    """``tensor_util.MakeNdarray``'s array from the port's parse: bfloat16
    bit patterns viewed as ``ml_dtypes.bfloat16``, as TensorFlow gives
    them."""
    import ml_dtypes

    arr = proto.tensor_values(t)
    if t.dtype == proto.DT_BFLOAT16:
        arr = arr.view(ml_dtypes.bfloat16)
    return arr


# -- field numbers -----------------------------------------------------------

def _descriptors():
    from tensorflow.core.framework import (attr_value_pb2, graph_pb2,
                                           node_def_pb2, tensor_pb2,
                                           tensor_shape_pb2, types_pb2)
    from tensorflow.core.protobuf import (meta_graph_pb2, saved_model_pb2,
                                          tensor_bundle_pb2)

    AV = attr_value_pb2.AttrValue
    MG = meta_graph_pb2.MetaGraphDef
    return types_pb2, [
        (graph_pb2.GraphDef, {"node": "GRAPHDEF_NODE"}),
        (node_def_pb2.NodeDef, {"name": "NODE_NAME", "op": "NODE_OP",
                                "input": "NODE_INPUT", "attr": "NODE_ATTR"}),
        (AV, {"list": "ATTR_LIST", "s": "ATTR_S", "i": "ATTR_I",
              "f": "ATTR_F", "b": "ATTR_B", "type": "ATTR_TYPE",
              "shape": "ATTR_SHAPE", "tensor": "ATTR_TENSOR",
              "placeholder": "ATTR_PLACEHOLDER", "func": "ATTR_FUNC"}),
        (AV.ListValue, {"s": "LIST_S", "i": "LIST_I", "f": "LIST_F",
                        "b": "LIST_B", "type": "LIST_TYPE",
                        "shape": "LIST_SHAPE", "tensor": "LIST_TENSOR",
                        "func": "LIST_FUNC"}),
        (attr_value_pb2.NameAttrList, {"name": "NAMEATTR_NAME"}),
        (tensor_pb2.TensorProto, {
            "dtype": "TENSOR_DTYPE", "tensor_shape": "TENSOR_SHAPE",
            "tensor_content": "TENSOR_CONTENT",
            "float_val": "TENSOR_FLOAT_VAL", "double_val": "TENSOR_DOUBLE_VAL",
            "int_val": "TENSOR_INT_VAL", "string_val": "TENSOR_STRING_VAL",
            "int64_val": "TENSOR_INT64_VAL", "bool_val": "TENSOR_BOOL_VAL",
            "half_val": "TENSOR_HALF_VAL"}),
        (tensor_shape_pb2.TensorShapeProto, {"dim": "SHAPE_DIM"}),
        (tensor_shape_pb2.TensorShapeProto.Dim, {"size": "DIM_SIZE"}),
        (MG, {"meta_info_def": "META_INFO_DEF", "graph_def": "META_GRAPH_DEF",
              "signature_def": "META_SIGNATURE_DEF"}),
        (MG.MetaInfoDef, {"tags": "META_INFO_TAGS"}),
        (meta_graph_pb2.SignatureDef, {"inputs": "SIG_INPUTS",
                                       "outputs": "SIG_OUTPUTS"}),
        (meta_graph_pb2.TensorInfo, {"name": "TENSORINFO_NAME"}),
        (saved_model_pb2.SavedModel, {
            "meta_graphs": "SAVED_MODEL_META_GRAPHS"}),
        (tensor_bundle_pb2.BundleHeaderProto, {
            "num_shards": "HEADER_NUM_SHARDS",
            "endianness": "HEADER_ENDIANNESS"}),
        (tensor_bundle_pb2.BundleEntryProto, {
            "dtype": "ENTRY_DTYPE", "shape": "ENTRY_SHAPE",
            "shard_id": "ENTRY_SHARD_ID", "offset": "ENTRY_OFFSET",
            "size": "ENTRY_SIZE", "crc32c": "ENTRY_CRC32C",
            "slices": "ENTRY_SLICES"}),
        (MG.SignatureDefEntry, {"key": "MAP_KEY", "value": "MAP_VALUE"}),
    ]


def test_field_numbers_match_descriptors():
    _tf()
    types_pb2, table = _descriptors()
    for message, names in table:
        fields = message.DESCRIPTOR.fields_by_name
        for field, const in names.items():
            assert fields[field].number == getattr(proto, const), \
                (message.DESCRIPTOR.full_name, field)
    dtypes = dict(types_pb2.DataType.items())
    for const in ("DT_FLOAT", "DT_DOUBLE", "DT_INT32", "DT_UINT8",
                  "DT_INT16", "DT_INT8", "DT_STRING", "DT_INT64", "DT_BOOL",
                  "DT_BFLOAT16", "DT_HALF", "DT_RESOURCE"):
        assert dtypes[const] == getattr(proto, const), const


# -- parse equality ----------------------------------------------------------

def _attr_equal(mine, theirs, where):
    from tensorflow.python.framework import tensor_util

    kind = theirs.WhichOneof("value")
    assert mine.kind == kind, where
    if kind == "tensor":
        a = tensor_to_numpy(mine.tensor)
        b = tensor_util.MakeNdarray(theirs.tensor)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif kind == "list":
        for f in ("s", "i", "b", "type"):
            assert list(getattr(mine.list, f)) == list(
                getattr(theirs.list, f)), (where, f)
        np.testing.assert_array_equal(np.float32(mine.list.f),
                                      np.float32(theirs.list.f))
        assert [s.as_list() for s in mine.list.shape] == [
            [d.size for d in s.dim] for s in theirs.list.shape], where
        assert [f.name for f in mine.list.func] == [
            f.name for f in theirs.list.func], where
    elif kind == "shape":
        assert mine.shape.as_list() == [d.size for d in theirs.shape.dim]
    elif kind == "f":
        assert np.float32(mine.f) == np.float32(theirs.f), where
    elif kind == "func":
        assert mine.func.name == theirs.func.name, where
    else:
        assert getattr(mine, kind) == getattr(theirs, kind), where


def _graph_equal(mine, theirs):
    assert len(mine.node) == len(theirs.node)
    for a, b in zip(mine.node, theirs.node):
        assert (a.name, a.op, a.input) == (b.name, b.op, list(b.input))
        assert set(a.attr) == set(b.attr), a.name
        for k in a.attr:
            _attr_equal(a.attr[k], b.attr[k], f"{a.name}.{k}")


GRAPH_FILES = ["tf_inception_v3.pb"] + [
    os.path.join("tf_fixtures", m, "frozen.pb") for m in MODELS]


@pytest.mark.parametrize("rel", GRAPH_FILES)
def test_graph_def_parse_equals_tensorflow(rel):
    tf = _tf()
    data = _read(os.path.join(DATA, rel))
    theirs = tf.compat.v1.GraphDef()
    theirs.ParseFromString(data)
    _graph_equal(proto.GraphDef.parse(data), theirs)


def _meta_equal(mine, theirs):
    assert mine.tags == list(theirs.meta_info_def.tags)
    _graph_equal(mine.graph_def, theirs.graph_def)
    assert set(mine.signature_def) == set(theirs.signature_def)
    for key, sig in mine.signature_def.items():
        ref = theirs.signature_def[key]
        for side in ("inputs", "outputs"):
            got, want = getattr(sig, side), getattr(ref, side)
            assert {k: v.name for k, v in got.items()} == {
                k: v.name for k, v in want.items()}


@pytest.mark.parametrize("model", MODELS)
def test_meta_graph_parse_equals_tensorflow(model):
    tf = _tf()
    from tensorflow.core.protobuf import meta_graph_pb2

    data = _read(os.path.join(FIXTURES, model, "ckpt", "model.meta"))
    theirs = meta_graph_pb2.MetaGraphDef()
    theirs.ParseFromString(data)
    _meta_equal(proto.MetaGraphDef.parse(data), theirs)
    assert "my_sig" in theirs.signature_def and tf is not None


@pytest.mark.parametrize("model", MODELS)
def test_saved_model_parse_equals_tensorflow(model):
    _tf()
    from tensorflow.core.protobuf import saved_model_pb2

    data = _read(os.path.join(FIXTURES, model, "saved_model",
                              "saved_model.pb"))
    theirs = saved_model_pb2.SavedModel()
    theirs.ParseFromString(data)
    mine = proto.SavedModel.parse(data)
    assert len(mine.meta_graphs) == len(theirs.meta_graphs) == 1
    for a, b in zip(mine.meta_graphs, theirs.meta_graphs):
        _meta_equal(a, b)


TENSOR_CASES = [
    ("float32", [[1.5, -2.0, 3.25]]),
    ("float64", [1.0, 2.0]),
    ("float16", [[0.5, -1.0], [65504.0, 1e-4]]),
    ("bfloat16", [3.0, -0.125, 7.5]),
    ("int8", [-128, 5, 127]),
    ("int16", [-30000, 7]),
    ("int32", [[-(2 ** 31), 2 ** 31 - 1], [0, -1]]),
    ("int64", [-(2 ** 63), 2 ** 62, -1]),
    ("uint8", [0, 255, 17]),
    ("bool", [True, False, True]),
    ("string", [b"a", b"", b"tensor_names"]),
]


@pytest.mark.parametrize("dtype,values", TENSOR_CASES,
                         ids=[c[0] for c in TENSOR_CASES])
@pytest.mark.parametrize("form", ["content", "typed", "single", "empty"])
def test_tensor_values_equal_make_ndarray(dtype, values, form):
    """tensor_content, the typed ``*_val`` fields, a single value filling
    its shape (TF's edge padding) and no values at all (zeros), each as
    TensorFlow's ``MakeNdarray`` reads it."""
    tf = _tf()
    from tensorflow.core.framework import tensor_pb2
    from tensorflow.python.framework import tensor_util

    dt = tf.as_dtype(dtype)
    arr = np.array(values, dtype=object if dtype == "string"
                   else dt.as_numpy_dtype)
    if form == "content":
        # strings: TensorFlow's own encoder (they have no tensor_content)
        t = tensor_util.make_tensor_proto(arr)
        if dtype != "string":
            t.ClearField("tensor_content")
            for f in ("float_val", "double_val", "int_val", "int64_val",
                      "bool_val", "half_val"):
                t.ClearField(f)
            t.tensor_content = arr.tobytes()
    else:
        t = tensor_pb2.TensorProto(dtype=dt.as_datatype_enum)
        shape = arr.shape if form != "single" else (2, 3)
        for s in shape:
            t.tensor_shape.dim.add(size=s)
        flat = arr.reshape(-1)[:1] if form == "single" else arr.reshape(-1)
        if form != "empty":
            if dtype in ("float16", "bfloat16"):
                t.half_val.extend(int(v) for v in flat.view(np.uint16))
            else:
                field = {"float32": "float_val", "float64": "double_val",
                         "int64": "int64_val", "bool": "bool_val",
                         "string": "string_val"}.get(dtype, "int_val")
                getattr(t, field).extend(v.item() if hasattr(v, "item")
                                         else v for v in flat)
    want = tensor_util.MakeNdarray(t)
    got = tensor_to_numpy(proto.TensorProto.parse(
        t.SerializeToString()))
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "string":
        assert got.tolist() == want.tolist()
    else:
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_unknown_fields_are_skipped():
    """Fields this reader does not know, of every wire type, are skipped
    (a GraphDef from a newer TensorFlow still parses)."""
    tf = _tf()
    data = _read(os.path.join(FIXTURES, "mlp", "frozen.pb"))
    extra = (b"\xf8\x06\x05"                       # field 111, varint
             + b"\xfa\x06\x03abc"                  # field 111, bytes
             + b"\xfd\x06\x00\x00\x80\x3f"         # field 111, fixed32
             + b"\xf9\x06" + b"\x00" * 8)          # field 111, fixed64
    theirs = tf.compat.v1.GraphDef()
    theirs.ParseFromString(data + extra)
    _graph_equal(proto.GraphDef.parse(data + extra), theirs)
    with pytest.raises(proto.ProtoError):
        proto.GraphDef.parse(data[:-3])


def test_tensor_from_numpy_round_trip():
    for arr in (np.arange(6, dtype=np.float32).reshape(2, 3),
                np.array([1, -2], np.int64), np.array(True)):
        got = tensor_to_numpy(proto.tensor_from_numpy(arr))
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
    import torch

    t = proto.tensor_from_numpy(np.array([1.0, 2.5], np.float16))
    assert proto.tensor_to_torch(t).dtype == torch.float16
    with pytest.raises(NotImplementedError, match="complex64"):
        t = proto.TensorProto()
        t.dtype = 8
        proto.tensor_values(t, "Const node 'c'")


# -- checkpoints -------------------------------------------------------------

CHECKPOINTS = [(m, sub) for m in MODELS for sub in ("ckpt", "saved_model")]


def _prefix(model, sub):
    if sub == "ckpt":
        return bundle.latest_checkpoint(os.path.join(FIXTURES, model, "ckpt"))
    return os.path.join(FIXTURES, model, "saved_model", "variables",
                        "variables")


@pytest.mark.parametrize("model,sub", CHECKPOINTS)
def test_bundle_equals_load_checkpoint(model, sub):
    tf = _tf()
    prefix = _prefix(model, sub)
    reader = bundle.BundleReader(prefix)
    ref = tf.train.load_checkpoint(prefix)
    shapes = ref.get_variable_to_shape_map()
    assert reader.keys() == sorted(shapes)
    assert reader.header.num_shards == 1
    for k in shapes:
        got, want = reader.tensor(k), ref.get_tensor(k)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_latest_checkpoint_state_file(tmp_path):
    src = os.path.join(FIXTURES, "mlp", "ckpt")
    assert bundle.latest_checkpoint(src) == os.path.join(src, "model")
    # an absolute path is kept; a missing state file or index gives None
    d = tmp_path / "moved"
    shutil.copytree(src, d)
    (d / "checkpoint").write_text(
        f'model_checkpoint_path: "{d / "model"}"\n')
    assert bundle.latest_checkpoint(str(d)) == str(d / "model")
    (d / "checkpoint").write_text('model_checkpoint_path: "nope"\n')
    assert bundle.latest_checkpoint(str(d)) is None
    assert bundle.latest_checkpoint(str(tmp_path)) is None


def test_checkpoint_written_by_tensorflow_in_several_blocks(tmp_path):
    """A checkpoint of 300 variables (an index of several blocks and
    restart points, bfloat16/float16/int64/bool values) reads back exactly;
    TensorFlow writes its index blocks uncompressed."""
    tf = _tf()
    rng = np.random.default_rng(0)
    values = {}
    for i in range(300):
        dt = [tf.float32, tf.int64, tf.bool, tf.float16][i % 4]
        arr = rng.normal(size=(i % 5 + 1, 3))
        values[f"layer_{i:03d}/some/long/shared/prefix/kernel"] = \
            tf.constant(arr > 0 if dt == tf.bool else arr, dtype=dt) \
            if dt != tf.int64 else tf.constant((arr * 100).astype(np.int64))
    values["bf16"] = tf.constant([1.5, -2.25], dtype=tf.bfloat16)
    ckpt = tf.train.Checkpoint(**{k.replace("/", "_"): tf.Variable(v)
                                  for k, v in values.items()})
    prefix = ckpt.write(str(tmp_path / "big"))
    reader = bundle.BundleReader(prefix)
    ref = tf.train.load_checkpoint(prefix)
    names = [k for k in ref.get_variable_to_shape_map()
             if ref.get_variable_to_dtype_map()[k] != tf.string]
    assert len(names) == 301
    for k in names:
        want = ref.get_tensor(k)
        got = reader.tensor(k)
        if want.dtype.name == "bfloat16":
            got = got.view(want.dtype)
        np.testing.assert_array_equal(got, want)
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    assert len(data) > 4096     # more than one 4 KiB block


def test_crc32c_known_values_and_vectorised_path():
    assert bundle.crc32c(b"123456789") == 0xE3069283
    assert bundle.crc32c(b"") == 0
    assert bundle.crc32c(bytes(32)) == 0x8A9136AA
    rng = np.random.default_rng(1)
    for n in (3, 4, 1000, (1 << 16) - 1, 1 << 16, (1 << 16) + 1, 300_001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert bundle.crc32c(data) == \
            bundle._crc_loop(0xFFFFFFFF, data) ^ 0xFFFFFFFF, n
    for v in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        assert bundle.unmask_crc(bundle.mask_crc(v)) == v


def test_corrupt_checkpoint_fails_its_crc(tmp_path):
    src = os.path.join(FIXTURES, "cnn", "ckpt")
    d = tmp_path / "ckpt"
    shutil.copytree(src, d)
    data = d / "model.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[10] ^= 0x01
    data.write_bytes(bytes(raw))
    reader = bundle.BundleReader(str(d / "model"))
    bad = [k for k in reader.keys()
           if reader.entries[k].offset <= 10
           < reader.entries[k].offset + reader.entries[k].size]
    assert len(bad) == 1
    with pytest.raises(bundle.CheckpointError, match="crc32c"):
        reader.tensor(bad[0])
    index = d / "model.index"
    raw = bytearray(index.read_bytes())
    raw[3] ^= 0x01
    index.write_bytes(bytes(raw))
    with pytest.raises(bundle.CheckpointError, match="crc32c"):
        bundle.BundleReader(str(d / "model"))


def test_snappy_block_raises(tmp_path):
    """A block marked snappy-compressed (its crc32c made valid) raises and
    says so."""
    src = os.path.join(FIXTURES, "mlp", "ckpt", "model.index")
    raw = bytearray(_read(src))
    footer = memoryview(bytes(raw))[len(raw) - bundle.FOOTER_SIZE:]
    _, _, pos = bundle._handle(footer, 0)
    off, size, _ = bundle._handle(footer, pos)
    raw[off + size] = 1
    crc = bundle.mask_crc(bundle.crc32c(bytes(raw[off:off + size + 1])))
    raw[off + size + 1:off + size + 5] = crc.to_bytes(4, "little")
    path = tmp_path / "model.index"
    path.write_bytes(bytes(raw))
    with pytest.raises(bundle.CheckpointError, match="snappy"):
        bundle.read_table(str(path))
