"""A reader of protobuf's wire format for the TensorFlow messages that
``TFInputGraph`` reads, without TensorFlow and without ``google.protobuf``.

It decodes varints, fixed32/64, length-delimited fields, packed and
unpacked repeated scalars and maps, and skips unknown fields.  The field
numbers below are those of TensorFlow's ``.proto`` files
(``tensorflow/core/framework/{graph,node_def,attr_value,tensor,
tensor_shape}.proto``, ``tensorflow/core/protobuf/{meta_graph,saved_model,
tensor_bundle}.proto``); ``tests/test_torch_tf_proto.py`` pins each one to
the ``_pb2`` descriptors of an installed TensorFlow.

The parsed messages are plain Python objects holding the fields that
TFInputGraph reads, named as in the ``.proto`` files
(``node.attr["strides"].list.i``, ``tensor.tensor_shape.dim[0].size``), so
the importer reads them as the JAX package reads TensorFlow's own; the
other fields are skipped like unknown ones.  :func:`tensor_values` is the
counterpart of ``tensor_util.MakeNdarray`` (bfloat16 as its uint16 bit
patterns), and :func:`tensor_to_torch` gives the tensor.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# -- field numbers -------------------------------------------------------
# GraphDef
GRAPHDEF_NODE = 1
# NodeDef
NODE_NAME, NODE_OP, NODE_INPUT, NODE_ATTR = 1, 2, 3, 5
# AttrValue (a oneof)
ATTR_LIST, ATTR_S, ATTR_I, ATTR_F, ATTR_B = 1, 2, 3, 4, 5
ATTR_TYPE, ATTR_SHAPE, ATTR_TENSOR, ATTR_PLACEHOLDER, ATTR_FUNC = 6, 7, 8, 9, 10
# AttrValue.ListValue
LIST_S, LIST_I, LIST_F, LIST_B, LIST_TYPE, LIST_SHAPE, LIST_TENSOR, LIST_FUNC = (
    2, 3, 4, 5, 6, 7, 8, 9)
# NameAttrList
NAMEATTR_NAME = 1
# TensorProto
TENSOR_DTYPE, TENSOR_SHAPE, TENSOR_CONTENT = 1, 2, 4
TENSOR_FLOAT_VAL, TENSOR_DOUBLE_VAL, TENSOR_INT_VAL, TENSOR_STRING_VAL = 5, 6, 7, 8
TENSOR_INT64_VAL, TENSOR_BOOL_VAL, TENSOR_HALF_VAL = 10, 11, 13
# TensorShapeProto, TensorShapeProto.Dim
SHAPE_DIM, DIM_SIZE = 2, 1
# MetaGraphDef, MetaGraphDef.MetaInfoDef
META_INFO_DEF, META_GRAPH_DEF, META_SIGNATURE_DEF = 1, 2, 5
META_INFO_TAGS = 4
# SignatureDef, TensorInfo
SIG_INPUTS, SIG_OUTPUTS = 1, 2
TENSORINFO_NAME = 1
# SavedModel
SAVED_MODEL_META_GRAPHS = 2
# map<K, V> entries
MAP_KEY, MAP_VALUE = 1, 2
# BundleHeaderProto, BundleEntryProto
HEADER_NUM_SHARDS, HEADER_ENDIANNESS = 1, 2
ENTRY_DTYPE, ENTRY_SHAPE, ENTRY_SHARD_ID, ENTRY_OFFSET = 1, 2, 3, 4
ENTRY_SIZE, ENTRY_CRC32C, ENTRY_SLICES = 5, 6, 7

# -- DataType enum (tensorflow/core/framework/types.proto) ---------------
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_STRING, DT_INT64, DT_BOOL, DT_BFLOAT16, DT_HALF = 7, 9, 10, 14, 19
DT_RESOURCE = 20

DTYPE_NAMES = {
    0: "invalid", 1: "float32", 2: "float64", 3: "int32", 4: "uint8",
    5: "int16", 6: "int8", 7: "string", 8: "complex64", 9: "int64",
    10: "bool", 11: "qint8", 12: "quint8", 13: "qint32", 14: "bfloat16",
    15: "qint16", 16: "quint16", 17: "uint16", 18: "complex128",
    19: "float16", 20: "resource", 21: "variant", 22: "uint32",
    23: "uint64",
}

# The dtypes this reader turns into arrays; bfloat16 is held as its uint16
# bit patterns here (numpy has no bfloat16).
_NUMPY = {
    DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
    DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8,
    DT_INT64: np.int64, DT_BOOL: np.bool_, DT_HALF: np.float16,
    DT_BFLOAT16: np.uint16, DT_STRING: np.object_,
}

_WIRE_VARINT, _WIRE_FIXED64, _WIRE_BYTES, _WIRE_FIXED32 = 0, 1, 2, 5


class ProtoError(ValueError):
    """Bytes that are not a well-formed message."""


# -- wire format ---------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    try:
        b = buf[pos]
        if b < 0x80:
            return b, pos + 1
        result, shift = b & 0x7F, 7
        while True:
            pos += 1
            b = buf[pos]
            result |= (b & 0x7F) << shift
            if b < 0x80:
                return result, pos + 1
            shift += 7
            if shift > 63:
                raise ProtoError("varint longer than 10 bytes")
    except IndexError:
        raise ProtoError("truncated varint") from None


def _signed64(v: int) -> int:
    """A varint as int64/int32 (negative values are sign-extended to 64
    bits on the wire)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def fields(buf) -> Iterator[Tuple[int, int, object]]:
    """``(field number, wire type, value)`` of each field of a message:
    an int for varint and fixed fields, a memoryview for length-delimited
    ones."""
    buf = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == _WIRE_VARINT:
            val, pos = _varint(buf, pos)
        elif wt == _WIRE_BYTES:
            n, pos = _varint(buf, pos)
            if pos + n > end:
                raise ProtoError(f"field {num}: {n} bytes past the end")
            val = buf[pos:pos + n]
            pos += n
        elif wt == _WIRE_FIXED32:
            if pos + 4 > end:
                raise ProtoError(f"field {num}: truncated fixed32")
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        elif wt == _WIRE_FIXED64:
            if pos + 8 > end:
                raise ProtoError(f"field {num}: truncated fixed64")
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        else:
            raise ProtoError(f"field {num}: unsupported wire type {wt}")
        yield num, wt, val


def _packed_varints(val, wt) -> List[int]:
    if wt == _WIRE_VARINT:
        return [val]
    out, pos, end = [], 0, len(val)
    while pos < end:
        v, pos = _varint(val, pos)
        out.append(v)
    return out


def _f32(v: int) -> float:
    return struct.unpack("<f", v.to_bytes(4, "little"))[0]


def _packed_fixed(val, wt, dtype) -> np.ndarray:
    """A packed (or single, unpacked) fixed32/fixed64 field as an array."""
    if wt == _WIRE_BYTES:
        return np.frombuffer(val, dtype=dtype).copy()
    size = np.dtype(dtype).itemsize
    return np.frombuffer(val.to_bytes(size, "little"), dtype=dtype).copy()


def _str(val) -> str:
    return bytes(val).decode("utf-8")


def _map_entry(val) -> Tuple[object, object]:
    key = value = None
    for num, _, v in fields(val):
        if num == MAP_KEY:
            key = v
        elif num == MAP_VALUE:
            value = v
    return key, value


# -- messages ------------------------------------------------------------


class Dim:
    __slots__ = ("size",)

    def __init__(self, size: int = 0):
        self.size = size

    def __repr__(self):
        return f"Dim({self.size})"


class TensorShapeProto:
    __slots__ = ("dim",)

    def __init__(self, dim=None):
        self.dim: List[Dim] = list(dim or [])

    @classmethod
    def parse(cls, buf) -> "TensorShapeProto":
        out = cls()
        for num, _, val in fields(buf):
            if num == SHAPE_DIM:
                d = Dim()
                for n2, _, v2 in fields(val):
                    if n2 == DIM_SIZE:
                        d.size = _signed64(v2)
                out.dim.append(d)
        return out

    def as_list(self) -> List[int]:
        return [d.size for d in self.dim]

    def __repr__(self):
        return f"TensorShapeProto({self.as_list()})"


class TensorProto:
    """A TensorProto's fields; :func:`tensor_values` gives its array."""

    __slots__ = ("dtype", "tensor_shape", "tensor_content", "float_val",
                 "double_val", "int_val", "string_val", "int64_val",
                 "bool_val", "half_val")

    def __init__(self):
        self.dtype = 0
        self.tensor_shape = TensorShapeProto()
        self.tensor_content = b""
        self.float_val: List = []
        self.double_val: List = []
        self.int_val: List[int] = []
        self.string_val: List[bytes] = []
        self.int64_val: List[int] = []
        self.bool_val: List[bool] = []
        self.half_val: List[int] = []

    @classmethod
    def parse(cls, buf) -> "TensorProto":
        t = cls()
        floats, doubles = [], []
        for num, wt, val in fields(buf):
            if num == TENSOR_DTYPE:
                t.dtype = val
            elif num == TENSOR_SHAPE:
                t.tensor_shape = TensorShapeProto.parse(val)
            elif num == TENSOR_CONTENT:
                t.tensor_content = bytes(val)
            elif num == TENSOR_FLOAT_VAL:
                floats.append(_packed_fixed(val, wt, "<f4"))
            elif num == TENSOR_DOUBLE_VAL:
                doubles.append(_packed_fixed(val, wt, "<f8"))
            elif num == TENSOR_INT_VAL:
                t.int_val += [_signed64(v) for v in _packed_varints(val, wt)]
            elif num == TENSOR_STRING_VAL:
                t.string_val.append(bytes(val))
            elif num == TENSOR_INT64_VAL:
                t.int64_val += [_signed64(v) for v in _packed_varints(val, wt)]
            elif num == TENSOR_BOOL_VAL:
                t.bool_val += [bool(v) for v in _packed_varints(val, wt)]
            elif num == TENSOR_HALF_VAL:
                t.half_val += [_signed64(v) for v in _packed_varints(val, wt)]
        if floats:
            t.float_val = np.concatenate(floats).tolist()
        if doubles:
            t.double_val = np.concatenate(doubles).tolist()
        return t

    def __repr__(self):
        return (f"TensorProto({DTYPE_NAMES.get(self.dtype, self.dtype)}, "
                f"{self.tensor_shape.as_list()})")


class NameAttrList:
    __slots__ = ("name",)

    def __init__(self, name: str = ""):
        self.name = name

    @classmethod
    def parse(cls, buf) -> "NameAttrList":
        out = cls()
        for num, _, val in fields(buf):
            if num == NAMEATTR_NAME:
                out.name = _str(val)
        return out


class ListValue:
    __slots__ = ("s", "i", "f", "b", "type", "shape", "tensor", "func")

    def __init__(self):
        self.s: List[bytes] = []
        self.i: List[int] = []
        self.f: List[float] = []
        self.b: List[bool] = []
        self.type: List[int] = []
        self.shape: List[TensorShapeProto] = []
        self.tensor: List[TensorProto] = []
        self.func: List[NameAttrList] = []

    @classmethod
    def parse(cls, buf) -> "ListValue":
        out = cls()
        for num, wt, val in fields(buf):
            if num == LIST_S:
                out.s.append(bytes(val))
            elif num == LIST_I:
                out.i += [_signed64(v) for v in _packed_varints(val, wt)]
            elif num == LIST_F:
                out.f += _packed_fixed(val, wt, "<f4").tolist()
            elif num == LIST_B:
                out.b += [bool(v) for v in _packed_varints(val, wt)]
            elif num == LIST_TYPE:
                out.type += _packed_varints(val, wt)
            elif num == LIST_SHAPE:
                out.shape.append(TensorShapeProto.parse(val))
            elif num == LIST_TENSOR:
                out.tensor.append(TensorProto.parse(val))
            elif num == LIST_FUNC:
                out.func.append(NameAttrList.parse(val))
        return out


class AttrValue:
    """One attr; ``kind`` names the oneof field that is set (None when
    none is), and every field reads its proto3 default when unset."""

    __slots__ = ("kind", "list", "s", "i", "f", "b", "type", "shape",
                 "tensor", "placeholder", "func")

    def __init__(self):
        self.kind: Optional[str] = None
        self.list = ListValue()
        self.s = b""
        self.i = 0
        self.f = 0.0
        self.b = False
        self.type = 0
        self.shape = TensorShapeProto()
        self.tensor = TensorProto()
        self.placeholder = ""
        self.func = NameAttrList()

    @classmethod
    def parse(cls, buf) -> "AttrValue":
        a = cls()
        for num, _, val in fields(buf):
            if num == ATTR_LIST:
                a.kind, a.list = "list", ListValue.parse(val)
            elif num == ATTR_S:
                a.kind, a.s = "s", bytes(val)
            elif num == ATTR_I:
                a.kind, a.i = "i", _signed64(val)
            elif num == ATTR_F:
                a.kind, a.f = "f", _f32(val)
            elif num == ATTR_B:
                a.kind, a.b = "b", bool(val)
            elif num == ATTR_TYPE:
                a.kind, a.type = "type", val
            elif num == ATTR_SHAPE:
                a.kind, a.shape = "shape", TensorShapeProto.parse(val)
            elif num == ATTR_TENSOR:
                a.kind, a.tensor = "tensor", TensorProto.parse(val)
            elif num == ATTR_PLACEHOLDER:
                a.kind, a.placeholder = "placeholder", _str(val)
            elif num == ATTR_FUNC:
                a.kind, a.func = "func", NameAttrList.parse(val)
        return a

    @classmethod
    def of_tensor(cls, tensor: TensorProto) -> "AttrValue":
        a = cls()
        a.kind, a.tensor = "tensor", tensor
        return a

    def __repr__(self):
        return f"AttrValue({self.kind}={getattr(self, self.kind or 's')!r})"


class NodeDef:
    __slots__ = ("name", "op", "input", "attr")

    def __init__(self, name: str = "", op: str = "", input=None, attr=None):
        self.name, self.op = name, op
        self.input: List[str] = list(input or [])
        self.attr: Dict[str, AttrValue] = dict(attr or {})

    @classmethod
    def parse(cls, buf) -> "NodeDef":
        n = cls()
        for num, _, val in fields(buf):
            if num == NODE_NAME:
                n.name = _str(val)
            elif num == NODE_OP:
                n.op = _str(val)
            elif num == NODE_INPUT:
                n.input.append(_str(val))
            elif num == NODE_ATTR:
                k, v = _map_entry(val)
                n.attr[_str(k) if k is not None else ""] = (
                    AttrValue.parse(v) if v is not None else AttrValue())
        return n

    def __repr__(self):
        return f"NodeDef({self.name!r}, {self.op})"


class GraphDef:
    """``node`` in graph order (a function library, where there is one, is
    not read: the ops that call into it are not supported)."""

    __slots__ = ("node",)

    def __init__(self, node=None):
        self.node: List[NodeDef] = list(node or [])

    @classmethod
    def parse(cls, buf) -> "GraphDef":
        g = cls()
        for num, _, val in fields(buf):
            if num == GRAPHDEF_NODE:
                g.node.append(NodeDef.parse(val))
        return g

    def __repr__(self):
        return f"GraphDef({len(self.node)} nodes)"


class TensorInfo:
    __slots__ = ("name",)

    def __init__(self):
        self.name = ""

    @classmethod
    def parse(cls, buf) -> "TensorInfo":
        t = cls()
        for num, _, val in fields(buf):
            if num == TENSORINFO_NAME:
                t.name = _str(val)
        return t


def _tensor_info_map(val, into: Dict[str, TensorInfo]) -> None:
    k, v = _map_entry(val)
    into[_str(k) if k is not None else ""] = (
        TensorInfo.parse(v) if v is not None else TensorInfo())


class SignatureDef:
    __slots__ = ("inputs", "outputs")

    def __init__(self):
        self.inputs: Dict[str, TensorInfo] = {}
        self.outputs: Dict[str, TensorInfo] = {}

    @classmethod
    def parse(cls, buf) -> "SignatureDef":
        s = cls()
        for num, _, val in fields(buf):
            if num == SIG_INPUTS:
                _tensor_info_map(val, s.inputs)
            elif num == SIG_OUTPUTS:
                _tensor_info_map(val, s.outputs)
        return s


class MetaGraphDef:
    __slots__ = ("tags", "graph_def", "signature_def")

    def __init__(self):
        self.tags: List[str] = []
        self.graph_def = GraphDef()
        self.signature_def: Dict[str, SignatureDef] = {}

    @classmethod
    def parse(cls, buf) -> "MetaGraphDef":
        m = cls()
        for num, _, val in fields(buf):
            if num == META_INFO_DEF:
                for n2, _, v2 in fields(val):
                    if n2 == META_INFO_TAGS:
                        m.tags.append(_str(v2))
            elif num == META_GRAPH_DEF:
                m.graph_def = GraphDef.parse(val)
            elif num == META_SIGNATURE_DEF:
                k, v = _map_entry(val)
                m.signature_def[_str(k) if k is not None else ""] = (
                    SignatureDef.parse(v) if v is not None
                    else SignatureDef())
        return m


class SavedModel:
    __slots__ = ("meta_graphs",)

    def __init__(self):
        self.meta_graphs: List[MetaGraphDef] = []

    @classmethod
    def parse(cls, buf) -> "SavedModel":
        s = cls()
        for num, _, val in fields(buf):
            if num == SAVED_MODEL_META_GRAPHS:
                s.meta_graphs.append(MetaGraphDef.parse(val))
        return s


class BundleHeaderProto:
    __slots__ = ("num_shards", "endianness")

    def __init__(self):
        self.num_shards = 0
        self.endianness = 0     # 0 LITTLE, 1 BIG

    @classmethod
    def parse(cls, buf) -> "BundleHeaderProto":
        h = cls()
        for num, _, val in fields(buf):
            if num == HEADER_NUM_SHARDS:
                h.num_shards = _signed64(val)
            elif num == HEADER_ENDIANNESS:
                h.endianness = val
        return h


class BundleEntryProto:
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c",
                 "slices")

    def __init__(self):
        self.dtype = 0
        self.shape = TensorShapeProto()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0
        self.slices = 0         # the number of TensorSliceProtos

    @classmethod
    def parse(cls, buf) -> "BundleEntryProto":
        e = cls()
        for num, _, val in fields(buf):
            if num == ENTRY_DTYPE:
                e.dtype = val
            elif num == ENTRY_SHAPE:
                e.shape = TensorShapeProto.parse(val)
            elif num == ENTRY_SHARD_ID:
                e.shard_id = _signed64(val)
            elif num == ENTRY_OFFSET:
                e.offset = _signed64(val)
            elif num == ENTRY_SIZE:
                e.size = _signed64(val)
            elif num == ENTRY_CRC32C:
                e.crc32c = val
            elif num == ENTRY_SLICES:
                e.slices += 1
        return e


# -- tensors -------------------------------------------------------------


def numpy_dtype(dt: int, what: str = "") -> np.dtype:
    """The numpy dtype of a DataType this reader supports (bfloat16 as its
    uint16 bit patterns); raises ``NotImplementedError`` naming ``what``
    for any other."""
    if dt not in _NUMPY:
        raise NotImplementedError(
            f"{what or 'tensor'}: dtype {DTYPE_NAMES.get(dt, dt)} is not "
            f"supported (float16/32/64, bfloat16, int8/16/32/64, uint8, "
            f"bool and string are)")
    return np.dtype(_NUMPY[dt])


def tensor_values(t: TensorProto, what: str = "") -> np.ndarray:
    """The array a TensorProto holds, as ``tensor_util.MakeNdarray``
    builds it, except that bfloat16 comes back as uint16 bit patterns
    (:func:`tensor_to_torch` reads them as bfloat16)."""
    dtype = numpy_dtype(t.dtype, what)
    shape = t.tensor_shape.as_list()
    n = int(np.prod(shape, dtype=np.int64))
    if t.tensor_content:
        if t.dtype == DT_STRING:
            raise NotImplementedError(
                f"{what or 'tensor'}: string tensor_content is not supported")
        return np.frombuffer(t.tensor_content, dtype=dtype).copy().reshape(shape)
    if t.dtype == DT_STRING:
        values = list(t.string_val)
        if n > len(values):
            # TensorFlow pads with "" (a str) when there is no value at all
            values.extend([values[-1] if values else ""] * (n - len(values)))
        return np.array(values, dtype=object).reshape(shape)
    if t.dtype in (DT_HALF, DT_BFLOAT16):
        values = np.array(t.half_val, dtype=np.uint16)
        if t.dtype == DT_HALF:
            values = values.view(np.float16)
    elif t.dtype == DT_FLOAT:
        values = np.array(t.float_val, dtype=np.float32)
    elif t.dtype == DT_DOUBLE:
        values = np.array(t.double_val, dtype=np.float64)
    elif t.dtype == DT_INT64:
        values = np.array(t.int64_val, dtype=np.int64)
    elif t.dtype == DT_BOOL:
        values = np.array(t.bool_val, dtype=np.bool_)
    else:   # int32, int16, int8, uint8 (TF keeps them all in int_val)
        values = np.array(t.int_val, dtype=np.int64).astype(dtype)
    if values.size == 0:
        return np.zeros(shape, dtype)
    if values.size != n:
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)


def tensor_to_torch(t: TensorProto, what: str = ""):
    """The tensor a TensorProto holds, as a CPU ``torch.Tensor``."""
    import torch

    arr = tensor_values(t, what)
    if t.dtype == DT_STRING:
        raise NotImplementedError(
            f"{what or 'tensor'}: a string tensor has no torch counterpart")
    if t.dtype == DT_BFLOAT16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def tensor_from_numpy(arr: np.ndarray) -> TensorProto:
    """A TensorProto holding ``arr`` (as ``tensor_content``)."""
    arr = np.asarray(arr).copy(order="C")
    dt = {np.dtype(v): k for k, v in _NUMPY.items()
          if k not in (DT_BFLOAT16, DT_STRING)}.get(arr.dtype)
    if dt is None:
        raise NotImplementedError(f"dtype {arr.dtype} is not supported")
    t = TensorProto()
    t.dtype = dt
    t.tensor_shape = TensorShapeProto([Dim(int(s)) for s in arr.shape])
    t.tensor_content = arr.tobytes()
    return t
