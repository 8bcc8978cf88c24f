"""TFInputGraph: uniform import of legacy TensorFlow model formats (port of
``sparkdl_tpu/graph/input.py``), without TensorFlow.

The reference's six constructors — a live Graph and Session, a GraphDef, a
``Saver`` checkpoint and a SavedModel, the last two with or without a
``signature_def`` — produce one canonical form: a frozen GraphDef and the
feed/fetch naming, compiled by :func:`graph.tf_import.graphdef_to_torch`
to a :class:`ModelFunction` keyed by LOGICAL names.

Freezing is this module's own work (the JAX package calls TensorFlow's
``convert_variables_to_constants``): the graph is pruned to the fetches'
transitive inputs; each ``VariableV2``, and each ``VarHandleOp`` with its
``ReadVariableOp``\\ s, becomes a Const.  A checkpoint's or SavedModel's
values are read from its tensor bundle (``graph/bundle.py``) under the key
that the graph's ``RestoreV2`` node gives the variable: its
``tensor_names`` constant, matched to the ``Assign`` or
``AssignVariableOp`` that consumes each of its outputs.  ``fromGraph``
reads only the objects the caller passes: ``graph.as_graph_def()``
serialized, and the variables' values through ``sess.run``.  The
messages themselves are read by ``graph/proto.py`` (no protobuf package).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.graph import proto as _proto
from sparkdl_tpu_torch.graph.bundle import BundleReader, latest_checkpoint
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.tf_import import (as_graph_def, check_supported,
                                               graphdef_to_torch)
from sparkdl_tpu_torch.graph.utils import op_name, tensor_name

_VARIABLE_OPS = frozenset({"VariableV2", "Variable", "VarHandleOp"})
_RESOURCE_READ = "ReadVariableOp"


class _Renamed:
    """``fn`` with the logical feed and fetch names of a signature: a dict
    input keyed by logical names is re-keyed to graph tensor names, a dict
    output keyed by graph tensor names to logical names."""

    def __init__(self, fn, input_mapping: Dict[str, str],
                 output_mapping: Dict[str, str]):
        self.fn = fn
        self.input_mapping = dict(input_mapping)
        self.output_mapping = dict(output_mapping)

    def __call__(self, module, x):
        if isinstance(x, dict):
            x = {self.input_mapping.get(k, k): v for k, v in x.items()}
        y = self.fn(module, x)
        if isinstance(y, dict):
            return {self.output_mapping.get(k, k): v for k, v in y.items()}
        return y


@dataclass
class TFInputGraph:
    """A frozen GraphDef + feed/fetch naming, ready to compile.

    ``input_mapping`` maps each logical input name to its graph tensor,
    ``output_mapping`` each graph tensor to its logical output name (the
    reference's feed/fetch-mapping builders)."""

    graph_def: _proto.GraphDef
    input_mapping: Dict[str, str]    # logical name -> graph tensor name
    output_mapping: Dict[str, str]   # graph tensor name -> logical name
    _model_function: Optional[ModelFunction] = field(default=None, repr=False)

    @property
    def input_names(self) -> List[str]:
        return list(self.input_mapping)

    @property
    def output_names(self) -> List[str]:
        return list(self.output_mapping.values())

    def model_function(self) -> ModelFunction:
        """Compile (once) to a ModelFunction keyed by LOGICAL names."""
        if self._model_function is None:
            feeds = list(self.input_mapping.values())
            fetches = list(self.output_mapping)
            raw = graphdef_to_torch(self.graph_def, feeds, fetches)
            logical_in = {v: k for k, v in self.input_mapping.items()}
            self._model_function = ModelFunction(
                fn=_Renamed(raw.fn, self.input_mapping, self.output_mapping),
                module=raw.module,
                input_names=tuple(logical_in[f] for f in feeds),
                output_names=tuple(self.output_mapping[f] for f in fetches))
        return self._model_function

    # -- constructors (the reference's six) --------------------------------
    @classmethod
    def _named(cls, graph_def, feed_names, fetch_names) -> "TFInputGraph":
        return cls(graph_def=graph_def,
                   input_mapping={n: tensor_name(n) for n in feed_names},
                   output_mapping={tensor_name(n): n for n in fetch_names})

    @classmethod
    def fromGraph(cls, graph, sess, feed_names: Sequence[str],
                  fetch_names: Sequence[str]) -> "TFInputGraph":
        """From a live ``tf.compat.v1`` Graph and Session, read by duck
        typing (``graph.as_graph_def().SerializeToString()``, ``sess.run``
        of the variables the fetches need)."""
        gd = as_graph_def(graph.as_graph_def())
        frozen = freeze(gd, fetch_names, _session_values(gd, sess))
        return cls._named(frozen, feed_names, fetch_names)

    @classmethod
    def fromGraphDef(cls, graph_def, feed_names: Sequence[str],
                     fetch_names: Sequence[str]) -> "TFInputGraph":
        """From an already-frozen GraphDef: TensorFlow's (read through its
        ``SerializeToString``), its bytes, a path, or this package's parsed
        :class:`~sparkdl_tpu_torch.graph.proto.GraphDef`."""
        return cls._named(as_graph_def(graph_def), feed_names, fetch_names)

    @classmethod
    def fromCheckpoint(cls, checkpoint_dir: str, feed_names: Sequence[str],
                       fetch_names: Sequence[str]) -> "TFInputGraph":
        """From a TF ``Saver`` checkpoint directory (the latest checkpoint
        and its stored ``.meta`` graph)."""
        graph_def, _ = _load_checkpoint(checkpoint_dir, fetch_names)
        return cls._named(graph_def, feed_names, fetch_names)

    @classmethod
    def fromCheckpointWithSignature(cls, checkpoint_dir: str,
                                    signature_def_key: str) -> "TFInputGraph":
        """From a checkpoint whose stored MetaGraph carries a
        signature_def."""
        graph_def, meta = _load_checkpoint(checkpoint_dir, None,
                                           signature_def_key)
        in_map, out_map = _signature_mappings(meta, signature_def_key)
        return cls(graph_def=graph_def, input_mapping=in_map,
                   output_mapping=out_map)

    @classmethod
    def fromSavedModel(cls, saved_model_dir: str, tag_set: str,
                       feed_names: Sequence[str],
                       fetch_names: Sequence[str]) -> "TFInputGraph":
        """From a SavedModel with explicit feed/fetch names."""
        graph_def, _ = _load_saved_model(saved_model_dir, tag_set,
                                         fetch_names)
        return cls._named(graph_def, feed_names, fetch_names)

    @classmethod
    def fromSavedModelWithSignature(cls, saved_model_dir: str, tag_set: str,
                                    signature_def_key: str) -> "TFInputGraph":
        """From a SavedModel using its signature_def feeds/fetches."""
        graph_def, meta = _load_saved_model(saved_model_dir, tag_set, None,
                                            signature_def_key)
        in_map, out_map = _signature_mappings(meta, signature_def_key)
        return cls(graph_def=graph_def, input_mapping=in_map,
                   output_mapping=out_map)


# ---------------------------------------------------------------------------
# freezing


def _closure(nodes: Dict[str, _proto.NodeDef], roots: Sequence[str]
             ) -> set:
    """The names of ``roots`` and every node they reach through data and
    control inputs (``extract_sub_graph``'s closure)."""
    seen, stack = set(), [op_name(r) for r in roots]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        if name not in nodes:
            raise ValueError(f"{name!r} not found in graph")
        seen.add(name)
        stack.extend(op_name(r.lstrip("^")) for r in nodes[name].input)
    return seen


def _const_node(name: str, value: np.ndarray) -> _proto.NodeDef:
    t = _proto.tensor_from_numpy(value)
    dtype = _proto.AttrValue()
    dtype.kind, dtype.type = "type", t.dtype
    return _proto.NodeDef(name=name, op="Const", attr={
        "value": _proto.AttrValue.of_tensor(t), "dtype": dtype})


def _through_identity(nodes, ref: str) -> str:
    """The node behind ``ref``, past any chain of Identity nodes."""
    src, seen = op_name(ref), set()
    while nodes[src].op == "Identity" and src not in seen:
        seen.add(src)
        src = op_name(nodes[src].input[0])
    return src


def _variable_of(nodes, name: str) -> str:
    """The variable that a ``ReadVariableOp`` reads."""
    return _through_identity(nodes, nodes[name].input[0])


def freeze(graph_def: _proto.GraphDef, fetch_names: Sequence[str],
           values: Callable[[List[str]], Dict[str, np.ndarray]]
           ) -> _proto.GraphDef:
    """``graph_def`` pruned to the fetches' transitive inputs, each
    variable (``VariableV2``; ``VarHandleOp`` and its ``ReadVariableOp``\\ s)
    replaced by a Const holding ``values(variable names)[name]``.  An op
    the importer cannot run raises ``NotImplementedError`` before any value
    is read (a TF2 function-library SavedModel's
    ``StatefulPartitionedCall``, as under the JAX importer)."""
    nodes = {n.name: n for n in graph_def.node}
    keep = _closure(nodes, fetch_names)
    kept = [n for n in graph_def.node if n.name in keep]
    check_supported(kept, allowed=_VARIABLE_OPS | {_RESOURCE_READ})
    variables = sorted({n.name for n in kept if n.op in _VARIABLE_OPS}
                       | {_variable_of(nodes, n.name) for n in kept
                          if n.op == _RESOURCE_READ})
    vals = values(variables) if variables else {}
    out = []
    for n in kept:
        if n.op in _VARIABLE_OPS:
            out.append(_const_node(n.name, vals[n.name]))
        elif n.op == _RESOURCE_READ:
            out.append(_const_node(n.name, vals[_variable_of(nodes, n.name)]))
        else:
            out.append(n)
    frozen = _proto.GraphDef(node=out)
    # drop the handles that only the reads needed
    by_name = {n.name: n for n in out}
    live = _closure(by_name, fetch_names)
    frozen.node = [n for n in out if n.name in live]
    return frozen


def restore_keys(graph_def: _proto.GraphDef) -> Dict[str, str]:
    """Variable name -> checkpoint key, from the graph's ``RestoreV2``
    nodes: output ``k`` restores ``tensor_names[k]`` into the variable of
    the ``Assign`` / ``AssignVariableOp`` that consumes it (through
    Identity nodes)."""
    nodes = {n.name: n for n in graph_def.node}
    consumers: Dict[str, List[Tuple[_proto.NodeDef, int]]] = {}
    for n in graph_def.node:
        for j, ref in enumerate(n.input):
            if not ref.startswith("^"):
                consumers.setdefault(tensor_name(ref), []).append((n, j))
    keys: Dict[str, str] = {}
    for r in graph_def.node:
        if r.op != "RestoreV2" or len(r.input) < 2:
            continue
        src = _through_identity(nodes, r.input[1])
        if nodes[src].op != "Const":
            continue
        names = _proto.tensor_values(nodes[src].attr["value"].tensor,
                                     f"Const node {src!r}").reshape(-1)
        for k, key in enumerate(names):
            stack = list(consumers.get(f"{r.name}:{k}", []))
            while stack:
                c, j = stack.pop()
                if c.op == "Identity":
                    stack.extend(consumers.get(f"{c.name}:0", []))
                elif c.op in ("Assign", "AssignVariableOp") and j == 1:
                    keys[_through_identity(nodes, c.input[0])] = \
                        key.decode("utf-8")
    return keys


def _bundle_values(graph_def: _proto.GraphDef, prefix: str):
    keys = restore_keys(graph_def)

    def values(names: List[str]) -> Dict[str, np.ndarray]:
        missing = [n for n in names if n not in keys]
        if missing:
            raise ValueError(
                f"variables {missing} have no checkpoint key: no RestoreV2 "
                f"output is assigned to them")
        reader = BundleReader(prefix)
        return {n: reader.tensor(keys[n]) for n in names}

    return values


def _session_values(graph_def: _proto.GraphDef, sess):
    nodes = {n.name: n for n in graph_def.node}
    reads: Dict[str, str] = {}
    for n in graph_def.node:
        if n.op == _RESOURCE_READ:
            reads.setdefault(_variable_of(nodes, n.name), n.name)

    def values(names: List[str]) -> Dict[str, np.ndarray]:
        tensors = []
        for name in names:
            if nodes[name].op == "VarHandleOp":
                if name not in reads:
                    raise ValueError(f"resource variable {name!r} has no "
                                     f"ReadVariableOp to read it through")
                tensors.append(reads[name] + ":0")
            else:
                tensors.append(name + ":0")
        got = sess.run(tensors)
        return {n: np.asarray(v) for n, v in zip(names, got)}

    return values


# ---------------------------------------------------------------------------
# checkpoints and SavedModels


def _get_signature(meta: _proto.MetaGraphDef, signature_def_key: str):
    if signature_def_key not in meta.signature_def:
        raise ValueError(
            f"signature_def {signature_def_key!r} not found; available: "
            f"{sorted(meta.signature_def)}")
    return meta.signature_def[signature_def_key]


def _signature_fetches(meta, signature_def_key: str) -> List[str]:
    outputs = _get_signature(meta, signature_def_key).outputs
    return [outputs[k].name for k in sorted(outputs)]


def _signature_mappings(meta, signature_def_key: str
                        ) -> Tuple[Dict[str, str], Dict[str, str]]:
    sig = _get_signature(meta, signature_def_key)
    in_map = {k: sig.inputs[k].name for k in sorted(sig.inputs)}
    out_map = {sig.outputs[k].name: k for k in sorted(sig.outputs)}
    return in_map, out_map


def _load_checkpoint(checkpoint_dir: str,
                     fetch_names: Optional[Sequence[str]],
                     signature_def_key: Optional[str] = None):
    ckpt = latest_checkpoint(checkpoint_dir)
    if ckpt is None:
        raise ValueError(f"No checkpoint found under {checkpoint_dir!r}")
    # the stored MetaGraphDef carries any signature_defs
    with open(ckpt + ".meta", "rb") as f:
        meta = _proto.MetaGraphDef.parse(f.read())
    if fetch_names is None:
        fetch_names = _signature_fetches(meta, signature_def_key)
    frozen = freeze(meta.graph_def, fetch_names,
                    _bundle_values(meta.graph_def, ckpt))
    return frozen, meta


def _load_saved_model(saved_model_dir: str, tag_set: str,
                      fetch_names: Optional[Sequence[str]],
                      signature_def_key: Optional[str] = None):
    tags = tag_set.split(",") if isinstance(tag_set, str) else list(tag_set)
    path = os.path.join(saved_model_dir, "saved_model.pb")
    if not os.path.exists(path):
        raise ValueError(f"No saved_model.pb under {saved_model_dir!r}")
    with open(path, "rb") as f:
        sm = _proto.SavedModel.parse(f.read())
    metas = [m for m in sm.meta_graphs if set(m.tags) == set(tags)]
    if not metas:
        raise RuntimeError(
            f"MetaGraphDef associated with tags {tags} could not be found "
            f"in SavedModel {saved_model_dir!r}; available tag sets: "
            f"{[sorted(m.tags) for m in sm.meta_graphs]}")
    meta = metas[0]
    if fetch_names is None:
        fetch_names = _signature_fetches(meta, signature_def_key)
    prefix = os.path.join(saved_model_dir, "variables", "variables")
    frozen = freeze(meta.graph_def, fetch_names,
                    _bundle_values(meta.graph_def, prefix))
    return frozen, meta


# The reference exported the class under this name too.
ModelInput = TFInputGraph
