"""A frozen TensorFlow GraphDef as a PyTorch module (port of
``sparkdl_tpu/graph/tf_import.py``).

:func:`graphdef_to_torch` is the counterpart of ``graphdef_to_jax``: it
reads a FROZEN GraphDef (variables already constants; ``graph/input.py``
freezes without TensorFlow) and returns a :class:`ModelFunction` over a
:class:`TFGraphModule`, an ``nn.Module`` that holds the constants its
forward reads as buffers.  No TensorFlow and no protobuf package is used:
the GraphDef is read by ``graph/proto.py``.

Import validates exactly as the JAX importer does, before anything runs and
in its order: the feeds and fetches exist (``ValueError``); every op of the
whole GraphDef is supported (``NotImplementedError``); no node refers to a
secondary output ``name:k`` (``NotImplementedError``); every Placeholder is
fed (``ValueError``).  What JAX finds only when it traces (a shape or axis
operand that is not constant, a data format or padding it does not run) is
refused here at import with the same exception types.  Two graphs that the
JAX importer computes wrongly without a word are refused
(``NotImplementedError``), as documented deviations: a dilated
``DepthwiseConv2dNative`` (JAX drops the dilation) and a ``FusedBatchNorm*``
with ``is_training`` true (JAX applies the moving statistics anyway).

Static operands (Reshape's shape, reduction axes, ConcatV2's axis, pad
widths, permutations, ExpandDims' axis) are resolved once at import,
through Identity chains as the JAX importer's ``static_lookup`` does, so
the forward never reads a tensor back to the host and the engine captures
it as one CUDA graph.  The nodes that the fetches need are put in a
topological order at import by an iterative walk (a recursion would
overflow on the 2,217 nodes of a frozen InceptionV3), and each value is
dropped after its last use.

Activations keep the graph's NHWC layout throughout, so reductions, concat
axes, Reshape and Squeeze need no remapping.  A convolution or pool runs on
``x.permute(0, 3, 1, 2)``, which is NCHW in channels_last memory (what
cuDNN takes without a copy), and permutes back; HWIO kernels are permuted
to OIHW once, at import.  TF's SAME padding puts the odd row and column at
the bottom and right: it is explicit where it is asymmetric, with -inf for
MaxPool, and AvgPool divides by the count of real pixels.

As under JAX's default 32-bit mode, float64 and int64 constants, feeds and
casts become float32 and int32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.graph import proto as _proto
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.utils import op_name, output_index, tensor_name
from sparkdl_tpu_torch.models.layers import same_padding

# Every op the forward can run (the JAX importer's _SUPPORTED_OPS).
SUPPORTED_OPS = frozenset({
    "Identity", "StopGradient", "PreventGradient", "Snapshot",
    "CheckNumerics", "NoOp", "PlaceholderWithDefault",
    "MatMul", "Add", "AddV2", "BiasAdd", "AddN", "Sub", "Mul", "RealDiv",
    "Div", "Maximum", "Minimum", "Square", "Sqrt", "Rsqrt", "Exp", "Log",
    "Neg", "Abs", "Pow",
    "Relu", "Relu6", "LeakyRelu", "Elu", "Selu", "Sigmoid", "Tanh",
    "Softplus", "Softmax", "LogSoftmax",
    "Conv2D", "DepthwiseConv2dNative", "MaxPool", "AvgPool",
    "FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3",
    "Mean", "Sum", "Max", "Min",
    "Reshape", "Squeeze", "ExpandDims", "ConcatV2", "Pad", "Transpose",
    "Cast",
})

STRUCTURAL = frozenset({"Placeholder", "Const"})

# Input slots resolved from the graph's constants at import, never run.
STATIC_ARG_SLOTS = {
    "Reshape": (1,),
    "ExpandDims": (1,),
    "Pad": (1,),
    "Transpose": (1,),
    "Mean": (1,),
    "Sum": (1,),
    "Max": (1,),
    "Min": (1,),
}

_IDENTITY_OPS = frozenset({
    "Identity", "StopGradient", "PreventGradient", "Snapshot",
    "CheckNumerics", "NoOp", "PlaceholderWithDefault"})

# TF DataType -> the dtype a Cast yields (JAX's 32-bit default: 64-bit
# types narrow to 32 bits)
_CAST = {
    _proto.DT_FLOAT: torch.float32, _proto.DT_DOUBLE: torch.float32,
    _proto.DT_INT32: torch.int32, _proto.DT_INT64: torch.int32,
    _proto.DT_UINT8: torch.uint8, _proto.DT_INT16: torch.int16,
    _proto.DT_INT8: torch.int8, _proto.DT_BOOL: torch.bool,
    _proto.DT_HALF: torch.float16, _proto.DT_BFLOAT16: torch.bfloat16,
}


def as_graph_def(obj) -> _proto.GraphDef:
    """A parsed GraphDef from this module's own GraphDef, serialized bytes,
    a path to a ``.pb`` file, or any object with ``SerializeToString()``
    (TensorFlow's GraphDef, read without importing TensorFlow)."""
    if isinstance(obj, _proto.GraphDef):
        return obj
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return _proto.GraphDef.parse(obj)
    if isinstance(obj, str):
        with open(obj, "rb") as f:
            return _proto.GraphDef.parse(f.read())
    if hasattr(obj, "SerializeToString"):
        return _proto.GraphDef.parse(obj.SerializeToString())
    raise TypeError(f"Expected a GraphDef, its bytes or a path, got "
                    f"{type(obj).__name__}")


def check_supported(nodes, allowed=frozenset()) -> None:
    """Raise ``NotImplementedError`` naming every node whose op the
    forward cannot run (``allowed``: ops the caller replaces first)."""
    bad = sorted({f"{n.op}({n.name})" for n in nodes
                  if n.op not in SUPPORTED_OPS and n.op not in STRUCTURAL
                  and n.op not in allowed})
    if bad:
        raise NotImplementedError(
            f"TF ops not supported by the GraphDef importer: {bad}")


def _attr(node, key):
    return node.attr.get(key)


def _attr_ints(node, key) -> List[int]:
    a = _attr(node, key)
    return list(a.list.i) if a is not None else []


def _attr_s(node, key, default=b"") -> bytes:
    a = _attr(node, key)
    return a.s if a is not None else default


def _attr_f(node, key, default=0.0) -> float:
    a = _attr(node, key)
    return float(a.f) if a is not None else default


def _attr_b(node, key, default=False) -> bool:
    a = _attr(node, key)
    return bool(a.b) if a is not None else default


def _padding(node) -> str:
    pad = _attr_s(node, "padding", b"SAME").decode()
    if pad not in ("SAME", "VALID"):
        raise NotImplementedError(
            f"{node.op} node {node.name!r}: unsupported padding {pad!r}")
    return pad


def _require_nhwc(node) -> None:
    fmt = _attr_s(node, "data_format", b"NHWC").decode()
    if fmt not in ("NHWC", ""):
        raise NotImplementedError(
            f"{node.op} node {node.name!r} uses data_format {fmt}; only "
            f"NHWC graphs are supported")


def _canonical(t: torch.Tensor) -> torch.Tensor:
    """JAX's 32-bit default: float64 -> float32, int64 -> int32."""
    if t.dtype == torch.float64:
        return t.float()
    if t.dtype == torch.int64:
        return t.int()
    return t


# -- the ops (x is NHWC) -----------------------------------------------------


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _same(x, window, strides, dilations=(1, 1)):
    """(top, bottom, left, right) of TF "SAME" on an NHWC tensor."""
    eff = [(w - 1) * d + 1 for w, d in zip(window, dilations)]
    ph = same_padding(x.shape[1], eff[0], strides[0])
    pw = same_padding(x.shape[2], eff[1], strides[1])
    return ph + pw


def _conv(p, x, w):
    """Conv2D / DepthwiseConv2dNative; ``w`` is OIHW unless the kernel is
    computed (then laid out here)."""
    if "runtime_layout" in p:
        w = _kernel_layout(w, p["runtime_layout"])
    strides, dil, groups = p["strides"], p["dilations"], p["groups"]
    if groups == -1:        # depthwise: one group per input channel
        groups = x.shape[-1]
    pad = (0, 0)
    if p["padding"] == "SAME":
        t, b, l, r = _same(x, w.shape[2:], strides, dil)
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (0, 0, l, r, t, b))
    return _nhwc(F.conv2d(_nchw(x), w, None, strides, pad, dil, groups))


def _max_pool(p, x):
    k, s = p["ksize"], p["strides"]
    pad = (0, 0)
    if p["padding"] == "SAME":
        t, b, l, r = _same(x, k, s)
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (0, 0, l, r, t, b), value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), k, s, pad))


def _avg_pool(p, x):
    """flax's ``avg_pool(count_include_pad=False)``: each window's sum over
    its count of real pixels."""
    k, s = p["ksize"], p["strides"]
    if p["padding"] == "VALID":
        return _nhwc(F.avg_pool2d(_nchw(x), k, s))
    t, b, l, r = _same(x, k, s)
    if t == b and l == r:
        return _nhwc(F.avg_pool2d(_nchw(x), k, s, (t, l),
                                  count_include_pad=False))
    pads = (0, 0, l, r, t, b)
    ones = x.new_ones((1, x.shape[1], x.shape[2], 1))
    total = F.avg_pool2d(_nchw(F.pad(x, pads)), k, s, divisor_override=1)
    count = F.avg_pool2d(_nchw(F.pad(ones, pads)), k, s, divisor_override=1)
    return _nhwc(total / count)


def _reduce(fn, p, x):
    if not p["axes"]:
        return x
    return fn(x, dim=p["axes"], keepdim=p["keep_dims"])


def _matmul(p, a, b):
    if p["transpose_a"]:
        a = a.t()
    if p["transpose_b"]:
        b = b.t()
    return torch.matmul(a, b)


def _addn(p, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _pad(p, x):
    flat = []
    for before, after in reversed(p["paddings"]):
        flat += [before, after]
    return F.pad(x, flat)


def _squeeze(p, x):
    return torch.squeeze(x, dim=p["dims"]) if p["dims"] else torch.squeeze(x)


def _batch_norm(p, x, gamma, beta, mean, var):
    return (x - mean) / torch.sqrt(var + p["epsilon"]) * gamma + beta


_OPS = {
    "Identity": lambda p, *xs: xs[0] if xs else None,
    "MatMul": _matmul,
    "BiasAdd": lambda p, x, b: x + b,
    "Add": lambda p, a, b: a + b,
    "AddV2": lambda p, a, b: a + b,
    "AddN": _addn,
    "Sub": lambda p, a, b: a - b,
    "Mul": lambda p, a, b: a * b,
    "RealDiv": lambda p, a, b: a / b,
    "Div": lambda p, a, b: a / b,
    "Maximum": lambda p, a, b: torch.maximum(a, b),
    "Minimum": lambda p, a, b: torch.minimum(a, b),
    "Square": lambda p, x: x * x,
    "Sqrt": lambda p, x: torch.sqrt(x),
    "Rsqrt": lambda p, x: 1.0 / torch.sqrt(x),
    "Exp": lambda p, x: torch.exp(x),
    "Log": lambda p, x: torch.log(x),
    "Neg": lambda p, x: -x,
    "Abs": lambda p, x: torch.abs(x),
    "Pow": lambda p, a, b: torch.pow(a, b),
    "Relu": lambda p, x: F.relu(x),
    "Relu6": lambda p, x: F.relu6(x),
    "LeakyRelu": lambda p, x: F.leaky_relu(x, p["alpha"]),
    "Elu": lambda p, x: F.elu(x),
    "Selu": lambda p, x: F.selu(x),
    "Sigmoid": lambda p, x: torch.sigmoid(x),
    "Tanh": lambda p, x: torch.tanh(x),
    "Softplus": lambda p, x: F.softplus(x),
    "Softmax": lambda p, x: torch.softmax(x, dim=-1),
    "LogSoftmax": lambda p, x: torch.log_softmax(x, dim=-1),
    "Conv2D": _conv,
    "DepthwiseConv2dNative": _conv,
    "MaxPool": _max_pool,
    "AvgPool": _avg_pool,
    "FusedBatchNorm": _batch_norm,
    "Mean": lambda p, x: _reduce(torch.mean, p, x),
    "Sum": lambda p, x: _reduce(torch.sum, p, x),
    "Max": lambda p, x: _reduce(torch.amax, p, x),
    "Min": lambda p, x: _reduce(torch.amin, p, x),
    "Reshape": lambda p, x: x.reshape(p["shape"]),
    "Squeeze": _squeeze,
    "ExpandDims": lambda p, x: x.unsqueeze(p["axis"]),
    "ConcatV2": lambda p, *xs: torch.cat(xs, dim=p["axis"]),
    "Pad": _pad,
    "Transpose": lambda p, x: x.permute(p["perm"]),
    "Cast": lambda p, x: x.to(p["dtype"]),
}
# ops that run as another op's function
_ALIAS = {op: "Identity" for op in _IDENTITY_OPS}
_ALIAS.update(FusedBatchNormV2="FusedBatchNorm",
              FusedBatchNormV3="FusedBatchNorm")


def with_frees(program: Sequence[tuple], keep: Sequence[int]
               ) -> List[tuple]:
    """The steps ``(op, name, ins, params, out)`` of ``program``, each with
    the slots it frees appended: a value a step computes is dropped after
    its last use, unless its slot is in ``keep`` (the fetches)."""
    computed = {s for *_, s in program} - set(keep)
    last: Dict[int, int] = {}
    for i, (_, _, ins, _, _) in enumerate(program):
        for s in ins:
            last[s] = i
    frees: List[List[int]] = [[] for _ in program]
    for s, i in last.items():
        if s in computed:
            frees[i].append(s)
    return [(op, name, ins, params, out, tuple(sorted(frees[i])))
            for i, (op, name, ins, params, out) in enumerate(program)]


class TFGraphModule(nn.Module):
    """A frozen GraphDef's fetch closure: constants as buffers ``c0``,
    ``c1``, ... (``const_names[i]`` is the TF node of ``c{i}``), and a
    program of steps ``(op, node name, input slots, params, output slot,
    slots freed after it)`` in topological order.  ``forward(x)`` takes
    the single feed's tensor or a dict keyed by feed name (``"op"`` or
    ``"op:0"``) and returns the single fetch or a dict keyed by the fetch
    names as given."""

    def __init__(self, feeds: Sequence[str], fetch_names: Sequence[str],
                 fetch_slots: Sequence[int], steps: Sequence[tuple],
                 consts: Sequence[Tuple[str, int, torch.Tensor]],
                 n_slots: int):
        super().__init__()
        self.feeds = list(feeds)
        self.fetch_names = list(fetch_names)
        self.fetch_slots = list(fetch_slots)
        self.steps = list(steps)
        self.n_slots = n_slots
        self.const_names: List[str] = []
        self.const_slots: List[int] = []
        for i, (name, slot, value) in enumerate(consts):
            self.register_buffer(f"c{i}", value)
            self.const_names.append(name)
            self.const_slots.append(slot)

    def forward(self, x):
        if isinstance(x, dict):
            given = {tensor_name(k): v for k, v in x.items()}
        else:
            if len(self.feeds) != 1:
                raise ValueError(
                    f"Graph has {len(self.feeds)} feeds; pass a dict")
            given = {self.feeds[0]: x}
        vals: List[Any] = [None] * self.n_slots
        for slot, feed in enumerate(self.feeds):
            if feed not in given:
                raise KeyError(f"feed {feed!r} not given (have "
                               f"{sorted(given)})")
            vals[slot] = _canonical(given[feed])
        for i, slot in enumerate(self.const_slots):
            vals[slot] = getattr(self, f"c{i}")
        for op, _, ins, params, out, frees in self.steps:
            vals[out] = _OPS[op](params, *[vals[j] for j in ins])
            for j in frees:
                vals[j] = None
        outs = [vals[s] for s in self.fetch_slots]
        if len(outs) == 1:
            return outs[0]
        return dict(zip(self.fetch_names, outs))


# -- import ------------------------------------------------------------------


class _Importer:
    def __init__(self, graph_def: _proto.GraphDef):
        self.nodes = {n.name: n for n in graph_def.node}
        self._values: Dict[str, np.ndarray] = {}

    def const_value(self, name: str) -> np.ndarray:
        if name not in self._values:
            node = self.nodes[name]
            a = _attr(node, "value")
            self._values[name] = _proto.tensor_values(
                a.tensor if a is not None else _proto.TensorProto(),
                f"Const node {name!r}")
        return self._values[name]

    def const_tensor(self, name: str) -> torch.Tensor:
        a = _attr(self.nodes[name], "value")
        t = a.tensor if a is not None else _proto.TensorProto()
        return _canonical(_proto.tensor_to_torch(t, f"Const node {name!r}"))

    def resolve_const(self, ref: str) -> Optional[str]:
        """The Const behind ``ref`` through Identity chains, or None."""
        name = op_name(ref)
        seen = set()
        while (name in self.nodes and self.nodes[name].op == "Identity"
               and name not in seen and self.nodes[name].input):
            seen.add(name)
            name = op_name(self.nodes[name].input[0])
        if name in self.nodes and self.nodes[name].op == "Const":
            return name
        return None

    def static(self, ref: str, node) -> np.ndarray:
        name = self.resolve_const(ref)
        if name is None:
            raise NotImplementedError(
                f"{node.op} node {node.name!r} has a dynamic shape/axis "
                f"operand {ref!r}; only constant operands are supported")
        return self.const_value(name)


def _data_refs(node) -> List[str]:
    return [r for r in node.input if not r.startswith("^")]


def _static_slots(node) -> set:
    slots = set(STATIC_ARG_SLOTS.get(node.op, ()))
    if node.op == "ConcatV2":
        slots.add(len(_data_refs(node)) - 1)
    return slots


def _params(imp: _Importer, node) -> Dict[str, Any]:
    """The node's import-time parameters (attrs and static operands),
    checked."""
    op, refs = node.op, _data_refs(node)
    p: Dict[str, Any] = {}
    if op in ("Conv2D", "DepthwiseConv2dNative"):
        _require_nhwc(node)
        strides = _attr_ints(node, "strides") or [1, 1, 1, 1]
        dil = _attr_ints(node, "dilations") or [1, 1, 1, 1]
        if op == "DepthwiseConv2dNative" and (dil[1], dil[2]) != (1, 1):
            raise NotImplementedError(
                f"DepthwiseConv2dNative node {node.name!r} has dilations "
                f"{dil}; a dilated depthwise convolution is not supported "
                f"(the JAX importer ignores its dilations)")
        p.update(strides=(strides[1], strides[2]),
                 dilations=(dil[1], dil[2]), padding=_padding(node),
                 groups=-1 if op == "DepthwiseConv2dNative" else 1)
    elif op in ("MaxPool", "AvgPool"):
        _require_nhwc(node)
        k = _attr_ints(node, "ksize")
        s = _attr_ints(node, "strides")
        p.update(ksize=(k[1], k[2]), strides=(s[1], s[2]),
                 padding=_padding(node))
    elif op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        _require_nhwc(node)
        if _attr_b(node, "is_training", True):
            raise NotImplementedError(
                f"{op} node {node.name!r} has is_training=True; only "
                f"inference batch norms are supported (the JAX importer "
                f"applies the moving statistics regardless)")
        p["epsilon"] = _attr_f(node, "epsilon", 1e-3)
    elif op == "BiasAdd":
        _require_nhwc(node)
    elif op == "MatMul":
        p.update(transpose_a=_attr_b(node, "transpose_a"),
                 transpose_b=_attr_b(node, "transpose_b"))
    elif op == "LeakyRelu":
        p["alpha"] = _attr_f(node, "alpha", 0.2)
    elif op in ("Mean", "Sum", "Max", "Min"):
        p.update(axes=tuple(int(a) for a in
                            imp.static(refs[1], node).reshape(-1)),
                 keep_dims=_attr_b(node, "keep_dims"))
    elif op == "Reshape":
        p["shape"] = [int(v) for v in imp.static(refs[1], node).reshape(-1)]
    elif op == "Squeeze":
        p["dims"] = tuple(_attr_ints(node, "squeeze_dims"))
    elif op == "ExpandDims":
        p["axis"] = int(imp.static(refs[1], node).reshape(-1)[0])
    elif op == "ConcatV2":
        p["axis"] = int(imp.static(refs[-1], node).reshape(-1)[0])
    elif op == "Pad":
        p["paddings"] = [[int(a), int(b)] for a, b in
                         imp.static(refs[1], node).reshape(-1, 2)]
    elif op == "Transpose":
        p["perm"] = [int(v) for v in imp.static(refs[1], node).reshape(-1)]
    elif op == "Cast":
        a = _attr(node, "DstT")
        dt = a.type if a is not None else 0
        if dt not in _CAST:
            raise NotImplementedError(
                f"Cast node {node.name!r} to "
                f"{_proto.DTYPE_NAMES.get(dt, dt)} is not supported")
        p["dtype"] = _CAST[dt]
    return p


def _kernel_layout(t: torch.Tensor, how: str) -> torch.Tensor:
    """HWIO -> OIHW; a depthwise (kh, kw, C, M) -> (C*M, 1, kh, kw) (the
    JAX importer's reshape to (kh, kw, 1, C*M) with C groups)."""
    if how == "depthwise":
        kh, kw, c, m = t.shape
        t = t.reshape(kh, kw, 1, c * m)
    return t.permute(3, 2, 0, 1).contiguous()


# Input slots holding a convolution kernel, and its layout: a constant
# kernel is laid out once at import, a computed one on every forward.
KERNEL_SLOTS = {"Conv2D": {1: "hwio"},
                "DepthwiseConv2dNative": {1: "depthwise"}}


def _closure(imp: _Importer, fetches: Sequence[str], feed_ops: set
             ) -> List[str]:
    """The non-Const nodes the fetches need, each after its inputs (an
    iterative post-order walk).  Static operands, fed nodes and constant
    kernels are not walked into."""
    nodes = imp.nodes
    order: List[str] = []
    state: Dict[str, int] = {}      # 1 = on the stack, 2 = done
    for f in fetches:
        stack = [op_name(f)]
        while stack:
            name = stack[-1]
            if name in feed_ops or state.get(name) == 2:
                stack.pop()
                continue
            node = nodes[name]
            if node.op == "Const":
                state[name] = 2
                stack.pop()
                continue
            if state.get(name) == 1:
                order.append(name)
                state[name] = 2
                stack.pop()
                continue
            state[name] = 1
            static = _static_slots(node)
            kernels = KERNEL_SLOTS.get(node.op, {})
            for j, r in enumerate(_data_refs(node)):
                dep = op_name(r)
                if (j in static or dep in feed_ops or state.get(dep) == 2
                        or (j in kernels and imp.resolve_const(r))):
                    continue
                if dep not in nodes:
                    raise ValueError(f"node {name!r} reads {r!r}, which is "
                                     f"not in the graph")
                if state.get(dep) == 1:
                    raise ValueError(f"the graph has a cycle through {dep!r}")
                stack.append(dep)
    return order


def graphdef_to_torch(graph_def, feed_names: Sequence[str],
                      fetch_names: Sequence[str]) -> ModelFunction:
    """A FROZEN GraphDef (this package's parsed GraphDef, its bytes, a
    path, or TensorFlow's GraphDef) as a :class:`ModelFunction` over a
    :class:`TFGraphModule`.  ``feed_names`` / ``fetch_names`` take ``"op"``
    or ``"op:k"`` (``graph/utils.py``)."""
    gd = as_graph_def(graph_def)
    imp = _Importer(gd)
    nodes = imp.nodes
    feeds = [tensor_name(f) for f in feed_names]
    fetches = [tensor_name(f) for f in fetch_names]
    for name in feeds + fetches:
        if op_name(name) not in nodes:
            raise ValueError(
                f"{name!r} not found in graph (ops: "
                f"{sorted(nodes)[:10]}...)")
    check_supported(gd.node)
    multi_out = sorted({
        ref for n in gd.node for ref in n.input
        if not ref.startswith("^") and output_index(ref) > 0
    } | {f for f in fetches if output_index(f) > 0})
    if multi_out:
        raise NotImplementedError(
            f"References to secondary node outputs are not supported: "
            f"{multi_out}")
    feed_ops = {op_name(f) for f in feeds}
    for n in gd.node:
        if n.op == "Placeholder" and n.name not in feed_ops:
            raise ValueError(
                f"Graph placeholder {n.name!r} is not covered by "
                f"feed_names {list(feed_names)}")

    order = _closure(imp, fetches, feed_ops)
    # every node's parameters, checked before anything runs
    plans = {name: _params(imp, nodes[name]) for name in order}

    feed_list: List[str] = []
    slot: Dict[str, int] = {}           # op name -> slot of its output
    for f in feeds:
        if op_name(f) not in slot:
            slot[op_name(f)] = len(feed_list)
            feed_list.append(tensor_name(op_name(f)))
    consts: List[Tuple[str, int, torch.Tensor]] = []
    const_slot: Dict[Tuple[str, str], int] = {}
    n_slots = [len(feed_list)]

    def new_slot() -> int:
        n_slots[0] += 1
        return n_slots[0] - 1

    def const_slot_of(name: str, how: str = "") -> int:
        if (name, how) not in const_slot:
            t = imp.const_tensor(name)
            if how:
                t = _kernel_layout(t, how)
            const_slot[(name, how)] = new_slot()
            consts.append((name + (f"[{how}]" if how else ""),
                           const_slot[(name, how)], t))
        return const_slot[(name, how)]

    def ref_slot(ref: str) -> int:
        name = op_name(ref)
        return slot[name] if name in slot else const_slot_of(name)

    program = []
    for name in order:
        node = nodes[name]
        params = plans[name]
        static = _static_slots(node)
        kernels = KERNEL_SLOTS.get(node.op, {})
        ins = []
        for j, r in enumerate(_data_refs(node)):
            if j in static:
                continue
            c = imp.resolve_const(r) if j in kernels else None
            if c is not None and op_name(r) not in slot:
                ins.append(const_slot_of(c, kernels[j]))
            else:
                if j in kernels:
                    params = dict(params, runtime_layout=kernels[j])
                ins.append(ref_slot(r))
        slot[name] = new_slot()
        program.append((_ALIAS.get(node.op, node.op), name, ins, params,
                        slot[name]))
    fetch_slots = [ref_slot(f) for f in fetches]

    steps = with_frees(program, fetch_slots)
    module = TFGraphModule(feed_list, list(fetch_names), fetch_slots, steps,
                           consts, n_slots[0])
    return ModelFunction.from_module(module, input_names=tuple(feed_names),
                                     output_names=tuple(fetch_names))
