"""Keras model config -> torch ModelFunction, without Keras (port of
``sparkdl_tpu/graph/keras_convert.py``).

The JAX converter walks a live Keras model (``model._nodes_by_depth``).
The machine with the card has no Keras, so the port builds the same graph
from the model's config JSON alone: the ``model_config`` attribute of a
``.h5``, ``config.json`` in a ``.keras`` zip, or ``to_json()`` of a model
object; the arrays come from the file (``models/keras_import.py``'s
readers) or from each layer's ``get_weights()``.  Both serialized forms of
the graph are read: Keras 3's ``inbound_nodes`` (``{"args": [...],
"kwargs": {...}}`` with ``__keras_tensor__`` entries whose
``keras_history`` is ``[layer, node, tensor]``) and Keras 2's
(``[[["layer", node, tensor, {}], ...]]``).

The result is a :class:`ModelFunction` over a :class:`KerasModel`: one
submodule per weighted Keras layer, registered under the layer's name
(escaped, :func:`layer_key`), in PyTorch's layouts (OIHW conv kernels,
``[out, in]`` dense kernels).  Activations stay logical NHWC tensors, so
every axis-based layer (BatchNormalization, Concatenate, Softmax, Flatten,
Reshape, Permute, Dense on the last axis) keeps its Keras meaning; each
conv and pool takes the view ``x.permute(0, 3, 1, 2)``, which is NCHW in
channels_last memory (what cuDNN is given on the card), and permutes its
result back the same way.  Spatial sizes stay free: the input's
``batch_shape`` gives the channel counts only.

Semantics follow the JAX converter's ``_convert_node``, not Keras, where
the two differ: the activation string ``"gelu"`` is the tanh
approximation (``jax.nn.gelu``'s default) and ``"leaky_relu"`` has slope
0.01 (``jax.nn.leaky_relu``'s); the ``LeakyReLU`` layer reads its own
slope.  Inference only: Dropout and the noise layers are the identity,
BatchNormalization applies its moving statistics.  Layers are checked
before anything is built; the converter also refuses what the JAX one
would compute wrongly without a word (dilated depthwise and separable
convs, ``channels_first``, a non-nearest ``UpSampling2D``).

Input names are the input layers' names; output names are the output
layers' names.  The JAX package names outputs by the Keras tensor
(``keras_tensor_<n>``, numbered per process), which a config does not
record; both list them in the same order.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.convert import (_tensor, depthwise_to_torch,
                                              kernel_to_torch,
                                              pointwise_to_torch)
from sparkdl_tpu_torch.models.layers import conv2d, promote, same_padding

# every layer type the converter lowers (InputLayer is read, not lowered):
# the JAX converter's _SUPPORTED_TYPES
SUPPORTED_TYPES = frozenset({
    "Conv2D", "DepthwiseConv2D", "SeparableConv2D", "Dense",
    "BatchNormalization", "MaxPooling2D", "AveragePooling2D",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D", "Activation", "ReLU",
    "LeakyReLU", "Softmax", "Flatten", "Reshape", "Permute", "Dropout",
    "GaussianNoise", "GaussianDropout", "SpatialDropout2D",
    "ActivityRegularization", "Add", "Subtract", "Multiply", "Average",
    "Maximum", "Concatenate", "ZeroPadding2D", "UpSampling2D", "Rescaling",
})
WEIGHTED = frozenset({"Conv2D", "DepthwiseConv2D", "SeparableConv2D",
                      "Dense", "BatchNormalization"})
_IDENTITY = frozenset({"Dropout", "GaussianNoise", "GaussianDropout",
                       "SpatialDropout2D", "ActivityRegularization"})
# the size a free spatial dimension takes while the channel counts are
# worked out on the meta device (no memory, no compute)
_TRACE_SPATIAL = 299


# -- activations: the JAX converter's table ---------------------------------------
def _linear(x):
    return x


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def _leaky_relu(x):
    return F.leaky_relu(x, 0.01)            # jax.nn.leaky_relu's default


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _log_softmax(x):
    return torch.log_softmax(x, dim=-1)


ACTIVATIONS = {
    "linear": _linear, "relu": torch.relu, "relu6": F.relu6,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "softmax": _softmax,
    "softplus": F.softplus, "softsign": F.softsign, "elu": F.elu,
    "selu": F.selu, "gelu": _gelu, "silu": F.silu, "swish": F.silu,
    "exponential": torch.exp, "hard_sigmoid": F.hardsigmoid,
    "leaky_relu": _leaky_relu, "log_softmax": _log_softmax,
}


def _activation(act) -> str:
    """The activation's name, checked against the table."""
    if act is None:
        return "linear"
    if isinstance(act, dict):  # a serialized function object
        act = act.get("config")
    if not isinstance(act, str) or act not in ACTIVATIONS:
        raise NotImplementedError(f"Unsupported Keras activation {act!r}")
    return act


# -- names ---------------------------------------------------------------------------
_RESERVED = frozenset(dir(nn.ModuleDict()))


def layer_key(name: str) -> str:
    """The submodule key of Keras layer ``name``: ``nn.ModuleDict`` refuses
    ``.`` in a key and names that are its attributes, so ``%`` and ``.``
    are percent-encoded, and so is the first letter of a name that is one
    of its attributes (``keys`` -> ``%6Beys``); ``urllib.parse.unquote``
    inverts it."""
    key = name.replace("%", "%25").replace(".", "%2E")
    if key in _RESERVED:
        key = f"%{ord(key[0]):02X}{key[1:]}"
    return key


# -- the graph, from the config ------------------------------------------------------
TensorRef = Tuple[str, int, int]    # (layer, node index, tensor index)


class Node(NamedTuple):
    """One application of a Keras layer: its name, class, normalized
    config (plain data), input tensors and output tensor."""
    layer: str
    op: str
    spec: dict
    inputs: Tuple[TensorRef, ...]
    out: TensorRef


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


def _channels_last(cls: str, name: str, cfg: dict) -> None:
    fmt = cfg.get("data_format") or "channels_last"
    if fmt != "channels_last":
        raise NotImplementedError(
            f"{cls} {name!r} has data_format={fmt!r}; only channels_last "
            f"is supported")


def _conv_spec(cls: str, name: str, cfg: dict) -> dict:
    if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
        raise NotImplementedError(f"Dilated {cls} {name!r} not supported yet")
    padding = str(cfg.get("padding", "valid")).lower()
    if padding not in ("valid", "same"):
        raise NotImplementedError(f"Unsupported padding {padding!r} "
                                  f"({name!r})")
    spec = dict(kernel=_pair(cfg["kernel_size"]),
                strides=_pair(cfg.get("strides", 1)), padding=padding,
                use_bias=bool(cfg.get("use_bias", True)),
                activation=_activation(cfg.get("activation")))
    if cls == "Conv2D":
        spec.update(filters=int(cfg["filters"]),
                    groups=int(cfg.get("groups") or 1))
    else:
        spec["mult"] = int(cfg.get("depth_multiplier") or 1)
        if cls == "SeparableConv2D":
            spec["filters"] = int(cfg["filters"])
    return spec


def _pool_spec(name: str, cfg: dict) -> dict:
    pool = _pair(cfg.get("pool_size", 2))
    strides = cfg.get("strides")
    padding = str(cfg.get("padding", "valid")).lower()
    if padding not in ("valid", "same"):
        raise NotImplementedError(f"Unsupported padding {padding!r} "
                                  f"({name!r})")
    return dict(pool=pool, strides=_pair(strides) if strides else pool,
                padding=padding)


def _zero_padding(p) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``padding`` as ((top, bottom), (left, right))."""
    if isinstance(p, int):
        return ((p, p), (p, p))
    return (_pair(p[0]), _pair(p[1]))


def _spec(cls: str, name: str, cfg: dict) -> dict:
    """The config fields the lowering of ``cls`` reads, checked and
    normalized (the JAX converter reads the same fields off the live
    layer)."""
    if cls in ("Conv2D", "DepthwiseConv2D", "SeparableConv2D", "MaxPooling2D",
               "AveragePooling2D", "GlobalAveragePooling2D",
               "GlobalMaxPooling2D", "Flatten", "UpSampling2D",
               "ZeroPadding2D"):
        _channels_last(cls, name, cfg)
    if cls in ("Conv2D", "DepthwiseConv2D", "SeparableConv2D"):
        return _conv_spec(cls, name, cfg)
    if cls == "Dense":
        return dict(units=int(cfg["units"]),
                    use_bias=bool(cfg.get("use_bias", True)),
                    activation=_activation(cfg.get("activation")))
    if cls == "BatchNormalization":
        axis = cfg.get("axis", -1)
        return dict(axis=int(axis if isinstance(axis, int) else axis[0]),
                    epsilon=float(cfg.get("epsilon", 1e-3)),
                    center=bool(cfg.get("center", True)),
                    scale=bool(cfg.get("scale", True)))
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        return _pool_spec(name, cfg)
    if cls in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
        return dict(keepdims=bool(cfg.get("keepdims", False)))
    if cls == "Activation":
        return dict(activation=_activation(cfg.get("activation")))
    if cls == "ReLU":
        mv = cfg.get("max_value")
        return dict(max_value=None if mv is None else float(mv),
                    slope=float(cfg.get("negative_slope") or 0.0),
                    threshold=float(cfg.get("threshold") or 0.0))
    if cls == "LeakyReLU":  # Keras 2 names the slope alpha
        return dict(slope=float(cfg.get("negative_slope",
                                        cfg.get("alpha", 0.3))))
    if cls in ("Softmax", "Concatenate"):
        axis = cfg.get("axis", -1)
        return dict(axis=int(axis) if isinstance(axis, int)
                    else tuple(int(a) for a in axis))
    if cls == "Reshape":
        return dict(target_shape=tuple(int(d) for d in cfg["target_shape"]))
    if cls == "Permute":
        return dict(dims=tuple(int(d) for d in cfg["dims"]))
    if cls == "ZeroPadding2D":
        return dict(padding=_zero_padding(cfg.get("padding", 1)))
    if cls == "UpSampling2D":
        interp = cfg.get("interpolation", "nearest")
        if interp != "nearest":
            raise NotImplementedError(
                f"Only nearest UpSampling2D supported ({name!r}: {interp!r})")
        return dict(size=_pair(cfg.get("size", 2)))
    if cls == "Rescaling":
        return dict(scale=cfg.get("scale", 1.0), offset=cfg.get("offset", 0.0))
    return {}


def _ref(v) -> TensorRef:
    return (str(v[0]), int(v[1]), int(v[2]))


def _refs(v) -> List[TensorRef]:
    """``input_layers`` / ``output_layers``: one ``[name, node, tensor]``,
    a list of them, or a dict of them (dict-structured inputs)."""
    if isinstance(v, dict):
        v = list(v.values())
    if v and isinstance(v[0], str):
        return [_ref(v)]
    return [_ref(r) for r in v]


def _keras3_tensors(obj, found: List[TensorRef]) -> None:
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            found.append(_ref(obj["config"]["keras_history"]))
        else:
            for v in obj.values():
                _keras3_tensors(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _keras3_tensors(v, found)


def _node_inputs(layer: str, node) -> Tuple[TensorRef, ...]:
    """The input tensors of one serialized node, in argument order."""
    if isinstance(node, dict):  # Keras 3
        found: List[TensorRef] = []
        _keras3_tensors(node.get("args", []), found)
        in_kwargs: List[TensorRef] = []
        _keras3_tensors(node.get("kwargs", {}), in_kwargs)
        if in_kwargs:
            raise NotImplementedError(
                f"layer {layer!r} takes tensors as keyword arguments")
        return tuple(found)
    return tuple(_ref(entry) for entry in node)  # Keras 2


def _input_shape(cfg: dict) -> Optional[list]:
    shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
    return list(shape) if shape else None


class Graph(NamedTuple):
    """A model config read: inputs ``(name, tensor, batch_shape)``, nodes
    in an order that computes every input before its use, outputs
    ``(name, tensor)``."""
    inputs: List[Tuple[str, TensorRef, list]]
    nodes: List[Node]
    outputs: List[Tuple[str, TensorRef]]


def _layer_name(entry: dict) -> str:
    return entry.get("name") or entry["config"]["name"]


def _check_layers(entries: Sequence[dict]) -> None:
    """Refuse unsupported layers and duplicate names before anything is
    built, as the JAX converter does."""
    unsupported = sorted({
        f"{e['class_name']}({_layer_name(e)})" for e in entries
        if e["class_name"] not in SUPPORTED_TYPES
        and e["class_name"] != "InputLayer"})
    if unsupported:
        raise NotImplementedError(
            f"Keras layers not supported by the torch converter: "
            f"{unsupported}")
    seen = set()
    for e in entries:
        name = _layer_name(e)
        if name in seen:
            raise ValueError(f"Duplicate layer name {name!r}")
        seen.add(name)


def _sequential(cfg: dict) -> Graph:
    entries = list(cfg["config"]["layers"])
    _check_layers(entries)
    if not entries:
        raise ValueError("Sequential model has no layers")
    if entries[0]["class_name"] == "InputLayer":
        first = entries.pop(0)
        in_name, shape = _layer_name(first), _input_shape(first["config"])
    else:
        in_name = f"{_layer_name(entries[0])}_input"
        shape = (_input_shape(entries[0]["config"])
                 or cfg["config"].get("build_input_shape"))
    if not shape:
        raise ValueError("Sequential model has no input shape; give it an "
                         "Input layer or build it before saving")
    prev: TensorRef = (in_name, 0, 0)
    nodes = []
    for e in entries:
        name = _layer_name(e)
        nodes.append(Node(name, e["class_name"],
                          _spec(e["class_name"], name, e["config"]),
                          (prev,), (name, 0, 0)))
        prev = (name, 0, 0)
    return Graph([(in_name, (in_name, 0, 0), list(shape))], nodes,
                 [(prev[0], prev)])


def _functional(cfg: dict) -> Graph:
    entries = cfg["config"]["layers"]
    _check_layers(entries)
    shapes: Dict[str, Optional[list]] = {}
    producers: Dict[TensorRef, Node] = {}
    for e in entries:
        name, cls = _layer_name(e), e["class_name"]
        if cls == "InputLayer":
            shapes[name] = _input_shape(e["config"])
            continue
        spec = _spec(cls, name, e["config"])
        for k, node in enumerate(e.get("inbound_nodes") or []):
            producers[(name, k, 0)] = Node(name, cls, spec,
                                           _node_inputs(name, node),
                                           (name, k, 0))
    inputs = []
    for ref in _refs(cfg["config"]["input_layers"]):
        if ref[0] not in shapes:
            raise ValueError(f"model input {ref[0]!r} is not an InputLayer")
        if not shapes[ref[0]]:
            raise ValueError(f"InputLayer {ref[0]!r} has no batch_shape")
        inputs.append((ref[0], ref, shapes[ref[0]]))
    # depth-first from the outputs: every node after the nodes it reads
    order: List[Node] = []
    state: Dict[TensorRef, int] = {ref: 2 for _, ref, _ in inputs}
    for out in _refs(cfg["config"]["output_layers"]):
        stack = [(out, False)]
        while stack:
            ref, expanded = stack.pop()
            if expanded:
                state[ref] = 2
                order.append(producers[ref])
                continue
            if state.get(ref) == 2:
                continue
            if ref[2] != 0:
                raise NotImplementedError(
                    f"Multi-output layer {ref[0]!r} unsupported")
            if ref not in producers:
                raise ValueError(f"tensor {list(ref)} has no producing layer "
                                 f"in the config")
            if state.get(ref) == 1:
                raise ValueError(f"the graph has a cycle through {ref[0]!r}")
            state[ref] = 1
            stack.append((ref, True))
            stack.extend((r, False) for r in reversed(producers[ref].inputs))
    outputs = []
    for ref in _refs(cfg["config"]["output_layers"]):
        name = ref[0] if ref[1:] == (0, 0) else f"{ref[0]}_{ref[1]}"
        outputs.append((name, ref))
    return Graph(inputs, order, outputs)


def read_graph(model_config: dict) -> Graph:
    """The graph of a Keras model config (``{"class_name": "Functional" |
    "Model" | "Sequential", "config": {...}}``), checked."""
    cls = model_config.get("class_name")
    if cls == "Sequential":
        return _sequential(model_config)
    if cls in ("Functional", "Model"):
        return _functional(model_config)
    raise ValueError(f"not a Keras model config (class_name {cls!r})")


# -- the weighted layers ------------------------------------------------------------
def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class _Conv(nn.Module):
    """Conv2D (``groups``) and DepthwiseConv2D (``groups`` = C): ``weight``
    [F, C/groups, kh, kw], ``bias`` [F]."""

    def __init__(self, out_ch: int, in_per_group: int, kernel, use_bias):
        super().__init__()
        self.weight = _param(out_ch, in_per_group, *kernel)
        self.bias = _param(out_ch) if use_bias else None


class _SepConv(nn.Module):
    """SeparableConv2D: ``depthwise_weight`` [C*mult, 1, kh, kw],
    ``pointwise_weight`` [F, C*mult, 1, 1], ``bias`` [F]."""

    def __init__(self, c: int, mult: int, filters: int, kernel, use_bias):
        super().__init__()
        self.depthwise_weight = _param(c * mult, 1, *kernel)
        self.pointwise_weight = _param(filters, c * mult, 1, 1)
        self.bias = _param(filters) if use_bias else None


class _Dense(nn.Module):
    """Dense: ``weight`` [out, in], ``bias`` [out]."""

    def __init__(self, in_features: int, units: int, use_bias: bool):
        super().__init__()
        self.weight = _param(units, in_features)
        self.bias = _param(units) if use_bias else None


class _BatchNorm(nn.Module):
    """BatchNormalization at inference: ``weight`` (gamma, when
    ``scale``), ``bias`` (beta, when ``center``), buffers ``running_mean``
    and ``running_var``."""

    def __init__(self, c: int, scale: bool, center: bool):
        super().__init__()
        self.weight = _param(c) if scale else None
        self.bias = _param(c) if center else None
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))


def keras_batchnorm_names(module: nn.Module) -> List[str]:
    """The names of the moving statistics (``running_mean``,
    ``running_var``) of every converted BatchNormalization layer in
    ``module``: buffers here, which the JAX converter keeps among the
    model's variables."""
    return [f"{name}.{k}" for name, m in module.named_modules()
            if isinstance(m, _BatchNorm)
            for k in ("running_mean", "running_var")]


class _Rescale(nn.Module):
    """A per-channel Rescaling's scale and offset, as buffers made once
    (a forward makes no tensor from a list: a CUDA-graph capture refuses
    the copy)."""

    def __init__(self, scale, offset):
        super().__init__()
        self.values = (scale, offset)
        self.register_buffer("scale", torch.empty(np.shape(scale)))
        self.register_buffer("offset", torch.empty(np.shape(offset)))

    def fill(self) -> None:
        with torch.no_grad():
            self.scale.copy_(torch.tensor(self.values[0]))
            self.offset.copy_(torch.tensor(self.values[1]))


def _build(node: Node, xs: List[torch.Tensor]) -> nn.Module:
    """The submodule of a weighted layer, sized by its first input."""
    s, x = node.spec, xs[0]
    if node.op == "Conv2D":
        c, g = x.shape[-1], s["groups"]
        if c % g or s["filters"] % g:
            raise ValueError(f"{node.layer!r}: {c} input channels and "
                             f"{s['filters']} filters in {g} groups")
        return _Conv(s["filters"], c // g, s["kernel"], s["use_bias"])
    if node.op == "DepthwiseConv2D":
        return _Conv(x.shape[-1] * s["mult"], 1, s["kernel"], s["use_bias"])
    if node.op == "SeparableConv2D":
        return _SepConv(x.shape[-1], s["mult"], s["filters"], s["kernel"],
                        s["use_bias"])
    if node.op == "Dense":
        return _Dense(x.shape[-1], s["units"], s["use_bias"])
    return _BatchNorm(x.shape[s["axis"]], s["scale"], s["center"])


def _keras_tensors(node: Node, arrays: Sequence) -> Dict[str, torch.Tensor]:
    """The submodule tensors of a weighted layer from its Keras arrays, in
    Keras' order (kernel(s), then bias; BatchNormalization: gamma if
    scale, beta if center, moving mean, moving variance)."""
    s, w = node.spec, list(arrays)
    if node.op == "BatchNormalization":
        want = s["scale"] + s["center"] + 2
    else:
        want = (2 if node.op == "SeparableConv2D" else 1) + s["use_bias"]
    if len(w) != want:
        raise ValueError(f"{node.layer!r} ({node.op}): {len(w)} arrays, "
                         f"want {want}")
    out: Dict[str, torch.Tensor] = {}
    if node.op == "BatchNormalization":
        if s["scale"]:
            out["weight"] = _tensor(w.pop(0))
        if s["center"]:
            out["bias"] = _tensor(w.pop(0))
        out["running_mean"], out["running_var"] = _tensor(w[0]), _tensor(w[1])
        return out
    if node.op in ("Conv2D", "Dense"):
        out["weight"] = kernel_to_torch(w.pop(0), node.layer)
    elif node.op == "DepthwiseConv2D":
        out["weight"] = depthwise_to_torch(w.pop(0))
    else:
        out["depthwise_weight"] = depthwise_to_torch(w.pop(0))
        out["pointwise_weight"] = pointwise_to_torch(w.pop(0))
    if w:
        out["bias"] = _tensor(w[0])
    return out


# -- the lowering of each layer (x is NHWC) -----------------------------------------------
def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _same_pads(x, window, strides) -> tuple:
    """``F.pad`` amounts of TF "SAME" on an NHWC tensor: the odd row and
    column go to the bottom and right."""
    ph = same_padding(x.shape[1], window[0], strides[0])
    pw = same_padding(x.shape[2], window[1], strides[1])
    return (0, 0, pw[0], pw[1], ph[0], ph[1])


def _act(name: str, y):
    return ACTIVATIONS[name](y)


def _conv(node, m, xs):
    s, x = node.spec, xs[0]
    if s["padding"] == "same":
        pads = _same_pads(x, s["kernel"], s["strides"])
        if any(pads):
            x = F.pad(x, pads)
    if node.op == "SeparableConv2D":
        y = conv2d(_nchw(x), m.depthwise_weight, s["strides"],
                   groups=x.shape[-1])
        y = conv2d(y, m.pointwise_weight, bias=m.bias)
    else:
        groups = x.shape[-1] if node.op == "DepthwiseConv2D" else s["groups"]
        y = conv2d(_nchw(x), m.weight, s["strides"], groups=groups,
                   bias=m.bias)
    return _act(s["activation"], _nhwc(y))


def _dense(node, m, xs):
    x, w = promote(xs[0], m.weight)
    b = m.bias.to(x.dtype) if m.bias is not None else None
    return _act(node.spec["activation"], F.linear(x, w, b))


def _batchnorm(node, m, xs):
    s, x = node.spec, xs[0]
    shape = [1] * x.ndim
    shape[s["axis"]] = -1

    def r(v):
        return v.reshape(shape)

    y = (x - r(m.running_mean)) / torch.sqrt(r(m.running_var) + s["epsilon"])
    if s["scale"]:
        y = y * r(m.weight)
    if s["center"]:
        y = y + r(m.bias)
    return y


def _max_pool(node, m, xs):
    s, x = node.spec, xs[0]
    if s["padding"] == "same":
        pads = _same_pads(x, s["pool"], s["strides"])
        if any(pads):
            x = F.pad(x, pads, value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), s["pool"], s["strides"]))


def _avg_pool(node, m, xs):
    """SAME divides each window's sum by its count of real pixels (flax's
    ``count_include_pad=False``); ``F.avg_pool2d`` pads symmetrically
    only, so the pad is explicit and the count is pooled from ones."""
    s, x = node.spec, xs[0]
    pads = (_same_pads(x, s["pool"], s["strides"])
            if s["padding"] == "same" else (0,) * 6)
    if not any(pads):
        return _nhwc(F.avg_pool2d(_nchw(x), s["pool"], s["strides"]))
    ones = x.new_ones((1, x.shape[1], x.shape[2], 1))
    total = F.avg_pool2d(_nchw(F.pad(x, pads)), s["pool"], s["strides"],
                         divisor_override=1)
    count = F.avg_pool2d(_nchw(F.pad(ones, pads)), s["pool"], s["strides"],
                         divisor_override=1)
    return _nhwc(total / count)


def _relu(node, m, xs):
    s, x = node.spec, xs[0]
    y = torch.where(x >= s["threshold"], x, s["slope"] * (x - s["threshold"]))
    if s["max_value"] is not None:
        y = torch.clamp(y, max=s["max_value"])
    return y


def _softmax_layer(node, m, xs):
    axis, x = node.spec["axis"], xs[0]
    if isinstance(axis, int):
        return torch.softmax(x, dim=axis)
    e = torch.exp(x - torch.amax(x, dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True)


def _upsampling(node, m, xs):
    (sh, sw), x = node.spec["size"], xs[0]
    b, h, w, c = x.shape
    return (x[:, :, None, :, None, :].expand(b, h, sh, w, sw, c)
            .reshape(b, h * sh, w * sw, c))


def _rescaling(node, m, xs):
    if m is not None:
        return xs[0] * m.scale + m.offset
    return xs[0] * node.spec["scale"] + node.spec["offset"]


_OPS = {
    "Conv2D": _conv, "DepthwiseConv2D": _conv, "SeparableConv2D": _conv,
    "Dense": _dense, "BatchNormalization": _batchnorm,
    "MaxPooling2D": _max_pool, "AveragePooling2D": _avg_pool,
    "GlobalAveragePooling2D": lambda n, m, xs: xs[0].mean(
        dim=(1, 2), keepdim=n.spec["keepdims"]),
    "GlobalMaxPooling2D": lambda n, m, xs: xs[0].amax(
        dim=(1, 2), keepdim=n.spec["keepdims"]),
    "Activation": lambda n, m, xs: _act(n.spec["activation"], xs[0]),
    "ReLU": _relu,
    "LeakyReLU": lambda n, m, xs: F.leaky_relu(xs[0], n.spec["slope"]),
    "Softmax": _softmax_layer,
    "Flatten": lambda n, m, xs: xs[0].reshape(xs[0].shape[0], -1),
    "Reshape": lambda n, m, xs: xs[0].reshape(
        (xs[0].shape[0],) + n.spec["target_shape"]),
    "Permute": lambda n, m, xs: xs[0].permute((0,) + n.spec["dims"]),
    # merges fold left to right, as the JAX converter's loops do
    "Add": lambda n, m, xs: functools.reduce(torch.add, xs),
    "Subtract": lambda n, m, xs: xs[0] - xs[1],
    "Multiply": lambda n, m, xs: functools.reduce(torch.mul, xs),
    "Average": lambda n, m, xs: functools.reduce(torch.add, xs) / len(xs),
    "Maximum": lambda n, m, xs: functools.reduce(torch.maximum, xs),
    "Concatenate": lambda n, m, xs: torch.cat(xs, dim=n.spec["axis"]),
    "ZeroPadding2D": lambda n, m, xs: F.pad(
        xs[0], (0, 0) + n.spec["padding"][1] + n.spec["padding"][0]),
    "UpSampling2D": _upsampling,
    "Rescaling": _rescaling,
}
_OPS.update({t: (lambda n, m, xs: xs[0]) for t in _IDENTITY})


# -- the module ---------------------------------------------------------------------
class KerasModel(nn.Module):
    """A Keras model built from its config: ``layers`` holds one
    submodule per weighted Keras layer (key :func:`layer_key`), the graph
    is plain data (:class:`Node` s), and ``forward`` walks it.

    A single-input model takes a tensor, a multi-input one a dict keyed
    by ``input_names``; a multi-output model returns a dict keyed by
    ``output_names``.  The tensors are allocated, not filled: load the
    arrays with :meth:`load_keras_layers` (or a ``state_dict``).  A
    forward makes no tensor from host data and does not synchronise, so
    the engine captures it as one CUDA graph."""

    def __init__(self, model_config: dict):
        super().__init__()
        graph = read_graph(model_config)
        self.model_config = model_config
        self.input_names = [name for name, _, _ in graph.inputs]
        self.input_shapes = {name: shape for name, _, shape in graph.inputs}
        self.output_names = [name for name, _ in graph.outputs]
        self._in_refs = [ref for _, ref, _ in graph.inputs]
        self._out_refs = [ref for _, ref in graph.outputs]
        self._nodes = graph.nodes
        self.layers = nn.ModuleDict()
        # the channel counts: one forward on the meta device builds each
        # weighted submodule from the shape that reaches it
        with torch.device("meta"):
            self._run({name: torch.empty(
                [1] + [_TRACE_SPATIAL if d is None else int(d)
                       for d in shape[1:-1]] + [self._channels(name, shape)])
                for name, _, shape in graph.inputs}, build=True)
        self.to_empty(device="cpu")
        for m in self.layers.values():
            if isinstance(m, _Rescale):
                m.fill()

    @staticmethod
    def _channels(name: str, shape) -> int:
        if shape[-1] is None:
            raise ValueError(f"input {name!r} has no channel count in its "
                             f"batch_shape {shape}")
        return int(shape[-1])

    def _run(self, values: Dict[str, torch.Tensor], build: bool = False):
        t = {ref: values[name] for name, ref in zip(self.input_names,
                                                     self._in_refs)}
        for node in self._nodes:
            xs = [t[r] for r in node.inputs]
            key = layer_key(node.layer)
            if build and key not in self.layers:
                if node.op in WEIGHTED:
                    self.layers[key] = _build(node, xs)
                elif node.op == "Rescaling" and not all(
                        np.isscalar(node.spec[k]) for k in ("scale", "offset")):
                    self.layers[key] = _Rescale(node.spec["scale"],
                                                node.spec["offset"])
            m = self.layers[key] if key in self.layers else None
            t[node.out] = _OPS[node.op](node, m, xs)
        outs = [t[r] for r in self._out_refs]
        if len(outs) == 1:
            return outs[0]
        return dict(zip(self.output_names, outs))

    def forward(self, x):
        if isinstance(x, dict):
            missing = set(self.input_names) - set(x)
            if missing:
                raise ValueError(f"Missing model inputs: {sorted(missing)}")
            return self._run(x)
        if len(self.input_names) != 1:
            raise ValueError(f"Model has {len(self.input_names)} inputs; "
                             f"pass a dict")
        return self._run({self.input_names[0]: x})

    def weighted_nodes(self) -> Dict[str, Node]:
        """Keras layer name -> its first node, for each weighted layer."""
        out: Dict[str, Node] = {}
        for n in self._nodes:
            if n.op in WEIGHTED:
                out.setdefault(n.layer, n)
        return out

    def keras_state_dict(self, layers: Sequence) -> Dict[str, torch.Tensor]:
        """This module's ``state_dict`` with every weighted layer filled
        from ``layers``, Keras-layout arrays by layer name
        (``models.keras_import.KerasLayer`` or ``(name, class_name,
        [arrays])``).  Raises on arrays for a layer the model has not, on a
        weighted layer without arrays, and on a shape mismatch."""
        from sparkdl_tpu_torch.models.keras_import import KerasLayer

        sd = self.state_dict()
        want = self.weighted_nodes()
        seen = set()
        for entry in layers:
            layer = KerasLayer(*entry)
            node = want.get(layer.name)
            if node is None:
                raise KeyError(f"Keras arrays for layer {layer.name!r}, which "
                               f"is not a weighted layer of the model")
            if layer.name in seen:
                raise ValueError(f"Keras arrays for layer {layer.name!r} "
                                 f"given twice")
            seen.add(layer.name)
            for k, tensor in _keras_tensors(node, layer.weights).items():
                full = f"layers.{layer_key(layer.name)}.{k}"
                if tuple(tensor.shape) != tuple(sd[full].shape):
                    raise ValueError(
                        f"Shape mismatch for {layer.name!r} {k}: the config "
                        f"gives {tuple(sd[full].shape)}, the arrays "
                        f"{tuple(tensor.shape)}")
                sd[full] = tensor.contiguous()
        missing = sorted(set(want) - seen)
        if missing:
            raise ValueError(f"No Keras arrays for weighted layers "
                             f"{missing[:5]} ({len(missing)} in all)")
        return sd

    def load_keras_layers(self, layers: Sequence) -> "KerasModel":
        """Fill the weighted layers from Keras-layout arrays
        (:meth:`keras_state_dict`)."""
        self.load_state_dict(self.keras_state_dict(layers))
        return self


# keras weight names of each weighted class, in Keras' array order
_KERAS_WEIGHT_NAMES = {
    "Conv2D": ("kernel", "bias"),
    "DepthwiseConv2D": ("kernel", "bias"),
    "SeparableConv2D": ("depthwise_kernel", "pointwise_kernel", "bias"),
    "Dense": ("kernel", "bias"),
    "BatchNormalization": ("gamma", "beta", "moving_mean",
                           "moving_variance"),
}


def state_dict_from_jax(module: KerasModel, variables: Dict[str, Dict[str, Any]]
                        ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` from the JAX converter's
    ``ModelFunction.variables`` of the same model: ``{layer: {weight
    name: array}}`` in Keras layout, as numpy (this module imports no
    JAX)."""
    nodes = module.weighted_nodes()
    layers = []
    for name, weights in variables.items():
        node = nodes.get(name)
        if node is None:
            raise KeyError(f"JAX variables for {name!r}, which is not a "
                           f"weighted layer of the model")
        layers.append((name, node.op, [weights[k] for k in
                                       _KERAS_WEIGHT_NAMES[node.op]
                                       if k in weights]))
    return module.keras_state_dict(layers)


# -- the entry ---------------------------------------------------------------------------
def read_keras_source(source) -> Tuple[dict, list]:
    """(model config, weighted layers) of ``source``: a ``.h5`` / ``.keras``
    path (read with h5py, imported inside the readers), a ``KerasFile``,
    or an object with ``to_json()`` and ``layers`` whose items have
    ``name`` and ``get_weights()`` (a Keras model, read without importing
    Keras)."""
    from sparkdl_tpu_torch.models.keras_import import (KerasFile, KerasLayer,
                                                       read_h5, read_keras)

    if isinstance(source, (str, bytes, os.PathLike)):
        path = os.fsdecode(source)
        if path.endswith(".keras"):
            source = read_keras(path)
        elif path.endswith(".h5") and not path.endswith(".weights.h5"):
            source = read_h5(path)
        else:
            raise ValueError(f"{path}: a Keras model file is a full-model "
                             f".h5 or a .keras (a .weights.h5 has no model "
                             f"config)")
    if isinstance(source, KerasFile):
        if source.model_config is None:
            raise ValueError("KerasFile has no model config (read from a "
                             ".weights.h5?)")
        return source.model_config, list(source.layers)
    if hasattr(source, "to_json") and hasattr(source, "layers"):
        config = json.loads(source.to_json())
        layers = [KerasLayer(l.name, "", [np.asarray(w)
                                          for w in l.get_weights()])
                  for l in source.layers if l.get_weights()]
        return config, layers
    raise TypeError(f"Cannot read a Keras model from "
                    f"{type(source).__name__}: pass a .h5 / .keras path, a "
                    f"KerasFile, or an object with to_json() and layers")


def keras_input_hw(model_config: dict) -> Optional[Tuple[int, int]]:
    """(height, width) of a single image input's ``batch_shape``, None
    where the model has another input or leaves the size free."""
    shapes = [shape for _, _, shape in read_graph(model_config).inputs]
    if len(shapes) == 1 and len(shapes[0]) == 4 and shapes[0][1] \
            and shapes[0][2]:
        return int(shapes[0][1]), int(shapes[0][2])
    return None


def keras_to_model_function(source) -> ModelFunction:
    """Convert a Keras model (see :func:`read_keras_source`) into a
    :class:`ModelFunction` over a :class:`KerasModel` on the CPU (the
    engine copies it to the card)."""
    config, layers = read_keras_source(source)
    module = KerasModel(config).load_keras_layers(layers)
    return ModelFunction.from_module(
        module, input_names=tuple(module.input_names),
        output_names=tuple(module.output_names))
