"""Keras weights -> the port's ``state_dict``, without Keras (port of
``sparkdl_tpu/models/keras_import.py``).

The JAX package reads weights through a live Keras model; the machine with
the card has no Keras, so the port reads the files itself (h5py, imported
inside the readers) into a list of weighted layers, :class:`KerasLayer`
``(name, class_name, [arrays], config)``, and :func:`import_weights` places
that list into a model's ``state_dict``:

  * **by name**: a Keras layer whose name is the name of a port module
    (the last part of its path: ResNet's ``conv2_block1.conv2_block1_0_conv``
    is ``conv2_block1_0_conv``) fills that module;
  * **by creation order**: the other layers (Keras auto-names them,
    ``conv2d_42``, with a per-session counter) are sorted per kind on that
    counter and paired with the model's ``auto_order``, a list of
    ``(kind, module path)``.

Keras HWIO / [in, out] kernels are transposed as ``models/convert.py``
transposes the JAX package's.  The readers:

  * :func:`read_h5`: a legacy full-model ``model.save("m.h5")`` (the
    ``model_weights`` group, its ``layer_names`` and each layer's
    ``weight_names`` attributes; classes and configs from the
    ``model_config`` attribute);
  * :func:`read_keras`: a ``.keras`` zip (names, classes and configs from
    ``config.json``, arrays from ``model.weights.h5``);
  * :func:`read_weights_h5`: a Keras 3 ``save_weights("m.weights.h5")``,
    which keys each layer ``layers/<snake_case class>[_k]/vars/<i>`` (the
    k-th layer of that class in ``model.layers`` order) and holds no names:
    the names come from the committed table ``data/keras_layers.json`` of
    each zoo model's weighted Keras layers in ``model.layers`` order.  The
    table stores Keras' auto names renumbered from 0 in creation order
    (``model.layers`` is topological, not creation order), so the
    creation-order pairing holds for a table name as for a file's.
"""

from __future__ import annotations

import functools
import io
import json
import os
import re
import zipfile
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from sparkdl_tpu_torch.models.convert import (_tensor, depthwise_to_torch,
                                              kernel_to_torch,
                                              pointwise_to_torch)

# Keras layer classes that carry importable weights -> kind.
WEIGHTED = {
    "Conv2D": "conv",
    "Dense": "dense",
    "BatchNormalization": "bn",
    "SeparableConv2D": "sepconv",
    "DepthwiseConv2D": "depthconv",
    # keras.layers.Normalization: [mean, variance, count]; count is dropped
    "Normalization": "norm",
}
# keras' snake_case of each class: the group name in a .weights.h5
SNAKE = {"Conv2D": "conv2d", "Dense": "dense",
         "BatchNormalization": "batch_normalization",
         "SeparableConv2D": "separable_conv2d",
         "DepthwiseConv2D": "depthwise_conv2d",
         "Normalization": "normalization"}

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "keras_layers.json")


class KerasLayer(NamedTuple):
    """One weighted Keras layer: its name, class, arrays in Keras layout
    and order, and its Keras config where the file has one."""
    name: str
    class_name: str
    weights: List[np.ndarray]
    config: Optional[dict] = None


class KerasFile(NamedTuple):
    """A weights file read: its weighted layers, every layer's
    ``(class_name, config)`` in model order where the file has a model
    config (None for a ``.weights.h5``), and that whole model config
    (``{"class_name": "Functional" | "Sequential", "config": ...}``, the
    graph the converter builds, ``graph/keras_convert.py``).  A Keras
    model held in memory as its config and arrays is
    :func:`keras_file`'s."""
    layers: List[KerasLayer]
    layer_configs: Optional[List[Tuple[str, dict]]]
    model_config: Optional[dict] = None


# -- the importer ---------------------------------------------------------------
_AUTO_SUFFIX = re.compile(r"^(.*?)(?:_(\d+))?$")


def _creation_counter(name: str) -> int:
    m = _AUTO_SUFFIX.match(name)
    return int(m.group(2)) if m.group(2) else -1


def _module_names(model: nn.Module) -> Dict[str, str]:
    """Last part of each module path -> the path, for names that occur
    once (InceptionV3's units each hold a ``conv`` and a ``bn``: those
    never match a Keras name)."""
    seen: Dict[str, List[str]] = {}
    for path, _ in model.named_modules():
        if path:
            seen.setdefault(path.rsplit(".", 1)[-1], []).append(path)
    return {leaf: paths[0] for leaf, paths in seen.items()
            if len(paths) == 1}


def _split_bn(layer: KerasLayer, module: nn.Module):
    """Keras BN weight order: [gamma if scale][beta if center][mean, var].
    The flags come from the layer's config where the file has one, else
    from the target module (a port BatchNorm without ``weight`` has no
    scale)."""
    cfg = layer.config or {}
    scale = bool(cfg.get("scale", getattr(module, "weight", None) is not None))
    center = bool(cfg.get("center", True))
    w = list(layer.weights)
    if len(w) != scale + center + 2:
        raise ValueError(f"{layer.name}: {len(w)} BatchNormalization arrays, "
                         f"want {scale + center + 2} (scale={scale}, "
                         f"center={center})")
    gamma = w.pop(0) if scale else None
    beta = w.pop(0) if center else None
    return gamma, beta, w[0], w[1]


def _port_tensors(kind: str, layer: KerasLayer, module: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """The port tensors (key -> tensor) of one Keras layer."""
    w = layer.weights
    out: Dict[str, torch.Tensor] = {}
    if kind in ("conv", "dense"):
        out["weight"] = kernel_to_torch(w[0], layer.name)
        rest = w[1:]
    elif kind == "sepconv":
        out["depthwise_weight"] = depthwise_to_torch(w[0])
        out["pointwise_weight"] = pointwise_to_torch(w[1])
        rest = w[2:]
    elif kind == "depthconv":
        out["depthwise_weight"] = depthwise_to_torch(w[0])
        rest = w[1:]
    elif kind == "bn":
        gamma, beta, mean, var = _split_bn(layer, module)
        if gamma is not None:
            out["weight"] = _tensor(gamma)
        if beta is not None:
            out["bias"] = _tensor(beta)
        out["running_mean"] = _tensor(mean)
        out["running_var"] = _tensor(var)
        out["num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        return out
    else:  # norm: [mean, variance, count]; post_scale defaults to 1
        mean = _tensor(w[0]).reshape(-1)
        out["mean"] = mean
        out["var"] = _tensor(w[1]).reshape(-1)
        out["post_scale"] = torch.ones_like(mean)
        return out
    if len(rest) > 1:
        raise ValueError(f"{layer.name}: {len(w)} arrays for a "
                         f"{layer.class_name}")
    if rest:
        out["bias"] = _tensor(rest[0])
    return out


def import_weights(model: nn.Module, layers: Sequence,
                   auto_order: Optional[Sequence[Tuple[str, str]]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` (any device, ``meta`` too: only its
    structure and shapes are read) filled from the weighted Keras
    ``layers`` (:class:`KerasLayer` or ``(name, class_name, arrays)``
    tuples; layers of other classes, or without arrays, are skipped).

    Layers match by name first; the rest by creation order per kind against
    ``auto_order``'s ``(kind, module path)`` entries.  Raises on a layer
    left unmatched with no ``auto_order``, on a shape mismatch, on a port
    tensor filled twice or never, and on layers ``auto_order`` leaves
    unconsumed.  Load the result with ``strict=True``."""
    expected = model.state_dict()
    names = _module_names(model)
    modules = dict(model.named_modules())
    sd: Dict[str, torch.Tensor] = {}

    def assign(path: str, kind: str, layer: KerasLayer) -> None:
        for key, t in _port_tensors(kind, layer, modules[path]).items():
            full = f"{path}.{key}"
            if full not in expected:
                raise KeyError(f"Keras layer {layer.name!r} gives {key!r}, "
                               f"which port module {path!r} does not have")
            if full in sd:
                raise ValueError(f"port tensor {full} filled twice (Keras "
                                 f"layer {layer.name!r})")
            if tuple(t.shape) != tuple(expected[full].shape):
                raise ValueError(
                    f"Shape mismatch importing {layer.name!r} into {full}: "
                    f"port {tuple(expected[full].shape)} vs keras "
                    f"{tuple(t.shape)}")
            sd[full] = t.contiguous()

    unmatched: List[Tuple[str, KerasLayer]] = []
    for entry in layers:
        layer = KerasLayer(*entry)
        kind = WEIGHTED.get(layer.class_name)
        if kind is None or not len(layer.weights):
            continue
        path = names.get(layer.name)
        if path is None:
            unmatched.append((kind, layer))
        else:
            assign(path, kind, layer)
    if unmatched:
        if auto_order is None:
            raise KeyError(f"No port module found for keras layers "
                           f"{[l.name for _, l in unmatched]} and no "
                           f"auto_order provided")
        by_kind: Dict[str, List[KerasLayer]] = {}
        for kind, layer in unmatched:
            by_kind.setdefault(kind, []).append(layer)
        for entries in by_kind.values():
            entries.sort(key=lambda l: _creation_counter(l.name))
        cursors = {k: 0 for k in by_kind}
        for kind, path in auto_order:
            entries = by_kind.get(kind, [])
            i = cursors.get(kind, 0)
            if i >= len(entries):
                raise ValueError(
                    f"Keras model has only {len(entries)} unmatched {kind!r} "
                    f"layers; auto_order asks for more (at {path})")
            cursors[kind] = i + 1
            assign(path, kind, entries[i])
        leftover = {k: len(v) - cursors[k] for k, v in by_kind.items()
                    if len(v) != cursors[k]}
        if leftover:
            raise ValueError(
                f"Unconsumed keras weighted layers by kind: {leftover}")
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise ValueError(f"{len(missing)} port tensors without a Keras "
                         f"weight: {missing[:5]}")
    return sd


# -- the readers ------------------------------------------------------------------
def _layer_configs(model_config: dict) -> List[Tuple[str, dict]]:
    return [(l["class_name"], l.get("config", {}))
            for l in model_config["config"]["layers"]]


def _vars(group) -> List[np.ndarray]:
    vs = group["vars"] if "vars" in group else {}
    return [np.asarray(vs[k][()]) for k in sorted(vs, key=int)]


def _by_class_group(f, configs: Sequence[Tuple[str, str, Optional[dict]]]
                    ) -> List[KerasLayer]:
    """The weighted layers of a Keras 3 weights file ``f`` (``layers/
    <snake>[_k]/vars/<i>``) named by ``configs``, the model's layers as
    ``(name, class_name, config)`` in ``model.layers`` order: the k-th
    layer of a class is group ``<snake>_k`` (``<snake>`` for k = 0)."""
    groups = f["layers"]
    counts: Dict[str, int] = {}
    out = []
    for name, cls, cfg in configs:
        k = counts.get(cls, 0)
        counts[cls] = k + 1
        if cls not in WEIGHTED:
            continue
        key = SNAKE[cls] + (f"_{k}" if k else "")
        if key not in groups:
            raise ValueError(f"weights file has no group layers/{key} for "
                             f"layer {name!r} ({cls})")
        out.append(KerasLayer(name, cls, _vars(groups[key]), cfg))
    for cls, snake in SNAKE.items():
        extra = f"{snake}_{counts.get(cls, 0)}" if counts.get(cls) else snake
        if extra in groups and _vars(groups[extra]):
            raise ValueError(f"weights file has more {cls} layers than the "
                             f"model (layers/{extra})")
    return out


def keras_file(model_config: dict, layers: Sequence) -> KerasFile:
    """A :class:`KerasFile` of a model held in memory: its model config
    (``json.loads(model.to_json())``) and its weighted layers
    (:class:`KerasLayer` or ``(name, class_name, [arrays])``)."""
    return KerasFile([KerasLayer(*entry) for entry in layers],
                     _layer_configs(model_config), model_config)


def read_h5(path: str) -> KerasFile:
    """A legacy full-model ``.h5`` (``model.save("m.h5")``)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "model_config" not in f.attrs or "model_weights" not in f:
            raise ValueError(f"{path}: not a full-model .h5 (no "
                             f"model_config / model_weights); save the "
                             f"model with model.save(), or its weights "
                             f"with save_weights('*.weights.h5')")
        raw = f.attrs["model_config"]
        model_config = json.loads(raw.decode() if isinstance(raw, bytes)
                                  else raw)
        configs = _layer_configs(model_config)
        by_name = {c.get("name"): (cls, c) for cls, c in configs}
        mw = f["model_weights"]
        layers = []
        for lname in mw.attrs["layer_names"]:
            lname = lname.decode() if isinstance(lname, bytes) else lname
            cls, cfg = by_name.get(lname, (None, None))
            g = mw[lname]
            arrays = []
            for wn in g.attrs["weight_names"]:
                wn = wn.decode() if isinstance(wn, bytes) else wn
                arrays.append(np.asarray(g[wn][()]))
            if cls in WEIGHTED and arrays:
                layers.append(KerasLayer(lname, cls, arrays, cfg))
    return KerasFile(layers, configs, model_config)


def read_keras(path: str) -> KerasFile:
    """A ``.keras`` zip (``model.save("m.keras")``)."""
    import h5py

    with zipfile.ZipFile(path) as z:
        model_config = json.loads(z.read("config.json"))
        weights = io.BytesIO(z.read("model.weights.h5"))
    configs = _layer_configs(model_config)
    with h5py.File(weights, "r") as f:
        layers = _by_class_group(
            f, [(c.get("name"), cls, c) for cls, c in configs])
    return KerasFile(layers, configs, model_config)


@functools.lru_cache(maxsize=None)
def keras_layer_table() -> Dict[str, list]:
    """The committed table: zoo model name -> its weighted Keras layers in
    ``model.layers`` order, each ``[name, class_name, [var shapes]]``."""
    with open(TABLE_PATH) as f:
        return json.load(f)


def read_weights_h5(path: str, model_name: str) -> KerasFile:
    """A Keras 3 ``save_weights("m.weights.h5")`` of zoo model
    ``model_name``; names from :func:`keras_layer_table`."""
    import h5py

    table = keras_layer_table()[model_name]
    with h5py.File(path, "r") as f:
        if "layers" not in f:
            raise ValueError(f"{path}: not a Keras 3 .weights.h5 (no "
                             f"'layers' group)")
        layers = _by_class_group(f, [(n, cls, None) for n, cls, _ in table])
    return KerasFile(layers, None)


def read_weights_file(path: str, model_name: str) -> KerasFile:
    """:func:`read_weights_h5`, :func:`read_h5` or :func:`read_keras` by
    the file's suffix."""
    if path.endswith(".weights.h5"):
        return read_weights_h5(path, model_name)
    if path.endswith(".h5"):
        return read_h5(path)
    if path.endswith(".keras"):
        return read_keras(path)
    raise ValueError(f"{path}: weights files are .weights.h5, .h5 or "
                     f".keras")
