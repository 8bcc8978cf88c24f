"""The device mesh and the weight-sharding policy (port of
``sparkdl_tpu/parallel/mesh.py``).

The port's own small types stand in for ``jax.sharding``'s:

  * :class:`Mesh`: a grid of ``torch.device``s with ``axis_names ==
    ("data", "model")`` and a ``shape`` mapping (axis name -> size);
  * :class:`PartitionSpec`: a tuple subclass, one entry per dimension
    (``None``, an axis name, or a tuple of axis names);
  * :class:`NamedSharding`: a (mesh, spec) pair.

``get_mesh()`` in one process is the one device
:func:`~sparkdl_tpu_torch.resolve_device` gives, shape (1, 1).  In a
``torch.distributed`` group of W ranks it holds one entry per rank (each
rank's ``cuda:<rank % device_count>``, or the CPU), shape (W, 1), as
``jax.devices()`` spans every host of a multi-controller run.  The port
runs one card per process: a fit's data axis spans the ranks of a group
(``parallel.train``), an engine's mesh is this process's one device.

The policy functions (:func:`match_partition_rules`,
:func:`default_partition_rules`, :func:`resolve_param_shardings`,
:func:`partition_digest`, :func:`param_sharding_stats`, ...) keep the JAX
package's arithmetic and error messages, and read only ``mesh.shape[axis]``
and ``mesh.axis_names``, so a shape-only stand-in for a mesh works with
them too.

Trees and the paths rules match against:

  * nested dicts, lists and tuples of arrays (numpy, torch, or anything
    with ``shape`` and ``dtype``) flatten as JAX flattens them: dict keys
    in sorted order, ``None`` an empty subtree, and a leaf's path is its
    keys and indices joined by ``/`` (``a/b/0/kernel``);
  * an ``nn.Module`` is the flat dict of its ``state_dict`` (tensors, in
    sorted name order) without BatchNorm's ``num_batches_tracked``, which
    the JAX variables tree does not hold; a leaf's path is its
    ``state_dict`` name with ``.`` turned into ``/``
    (``block1_conv1/weight``).  A spec tree for a module is a dict keyed by
    those ``state_dict`` names.

:func:`default_partition_rules` splits what JAX's splits: a flax
``kernel`` / ``embedding`` on its last dimension and, for a module, a
``weight`` of rank 2 or more on its first dimension (torch's output
channels or features, the dimension flax keeps last), so a module's
per-chip bytes under the default policy equal the JAX variables'.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """Per-dimension sharding of one array: ``None`` (not split), an axis
    name, or a tuple of axis names; ``PartitionSpec()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A (data, model) grid of devices.  ``ranks`` holds, for each entry,
    the index of the process that owns that device."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS,
                                                             MODEL_AXIS),
                 ranks=None):
        grid = np.asarray(devices, dtype=object)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != grid.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{grid.ndim}-d device grid")
        self.ranks = (np.zeros(grid.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(grid.shape))

    @property
    def shape(self) -> dict:
        return {n: int(s) for n, s in zip(self.axis_names,
                                          self.devices.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices.flat), self.axis_names,
                tuple(self.devices.shape), tuple(self.ranks.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={list(self.devices.flat)})"


class NamedSharding:
    """An array's layout on ``mesh``: ``spec`` names the mesh axis (if
    any) each of its dimensions is split over."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and tuple(self.spec) == tuple(other.spec))

    def __hash__(self) -> int:
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec!r})"


def _rank_device(rank: int, like: torch.device) -> torch.device:
    """The device rank ``rank`` of a group runs on, when this process runs
    on ``like``: ``cuda:<rank % device_count>``, or the CPU."""
    if like.type == "cuda":
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return torch.device(like.type)


def _global_devices() -> Tuple[list, list]:
    """(devices, ranks) of every process: one device per rank of the
    ``torch.distributed`` group, or this process's one device."""
    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.parallel import distributed

    local = resolve_device()
    count = distributed.process_count()
    if count == 1:
        return [local], [0]
    return [_rank_device(r, local) for r in range(count)], list(range(count))


def get_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
             devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over the devices of every process (one
    per rank in a group; this process's one device otherwise), or over
    ``devices`` (all owned by this process).  ``num_devices`` keeps the
    first N."""
    if devices is not None:
        from sparkdl_tpu_torch.parallel import distributed

        devs = [torch.device(d) for d in devices]
        ranks = [distributed.process_index()] * len(devs)
    else:
        devs, ranks = _global_devices()
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(
                f"Requested {num_devices} devices; only {len(devs)} present")
        devs, ranks = devs[:num_devices], ranks[:num_devices]
    n = len(devs)
    if n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n} devices")
    shape = (n // model_parallel, model_parallel)
    return Mesh(np.asarray(devs, dtype=object).reshape(shape),
                (DATA_AXIS, MODEL_AXIS),
                ranks=np.asarray(ranks).reshape(shape))


def batch_sharding(mesh, ndim: int = 1) -> NamedSharding:
    """Axis 0 (the batch) split across the data axis, the rest
    replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def replicated_sharding(mesh) -> NamedSharding:
    """Every device holds the whole array."""
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# trees: JAX's flattening order and leaf paths


def _is_spec(x) -> bool:
    return isinstance(x, (PartitionSpec, NamedSharding))


def _module_leaves(module: nn.Module) -> dict:
    """A module's tree: its ``state_dict`` tensors by name, without
    ``num_batches_tracked``."""
    return {k: v for k, v in module.state_dict(keep_vars=True).items()
            if not k.endswith("num_batches_tracked")}


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None,
                           _prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's order (see the module docstring);
    ``is_leaf`` stops the walk at a subtree.  Partition specs are always
    leaves."""
    if is_leaf is not None and is_leaf(tree):
        return [(_prefix, tree)]
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        leaves = _module_leaves(tree)
        return [(_prefix + tuple(k.split(".")), leaves[k])
                for k in sorted(leaves)]
    if _is_spec(tree):
        return [(_prefix, tree)]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k], is_leaf,
                                                   _prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in tree_flatten_with_path(t, is_leaf,
                                                   _prefix + (i,))]
    return [(_prefix, tree)]


def tree_structure(tree, is_leaf: Optional[Callable] = None):
    """A comparable description of ``tree``'s containers (a module is the
    flat dict of its ``state_dict`` names)."""
    if is_leaf is not None and is_leaf(tree):
        return "*"
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        return ("dict", tuple(sorted(_module_leaves(tree))),
                ("*",) * len(_module_leaves(tree)))
    if _is_spec(tree):
        return "*"
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys,
                tuple(tree_structure(tree[k], is_leaf) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(tree_structure(t, is_leaf) for t in tree))
    return "*"


def tree_unflatten_like(tree, leaves: list):
    """``leaves`` (in :func:`tree_flatten_with_path` order) put back into
    ``tree``'s containers; a module's come back as a dict by
    ``state_dict`` name."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, nn.Module):
            return {k: next(it) for k in sorted(_module_leaves(t))}
        if _is_spec(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            items = [build(x) for x in t]
            if hasattr(t, "_fields"):
                return type(t)(*items)
            return type(t)(items)
        return next(it)

    return build(tree)


def _leaf_shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _leaf_nbytes(leaf) -> int:
    shape = _leaf_shape(leaf)
    n = int(np.prod(shape, dtype=np.int64))
    dtype = getattr(leaf, "dtype", np.float64)
    if isinstance(dtype, torch.dtype):
        return n * torch.empty((), dtype=dtype).element_size()
    return n * np.dtype(dtype).itemsize


# ---------------------------------------------------------------------------
# weight sharding: partition rules


def param_path_str(path) -> str:
    """``/``-joined name of one leaf from its path (keys and indices): the
    spelling every rule regex matches against."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def match_partition_rules(rules, params):
    """Tree of ``PartitionSpec`` for ``params`` by ``rules``: an ordered
    sequence of ``(regex, spec)`` pairs, the FIRST whose regex
    ``re.search``-matches the leaf's path winning; ``spec`` is a
    ``PartitionSpec`` or a callable ``(leaf) -> PartitionSpec``.  Scalars
    (rank 0 or one element) are never partitioned; a leaf no rule matches
    raises ``ValueError`` naming it."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def get_spec(path, leaf):
        name = param_path_str(path)
        shape = _leaf_shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()  # never partition scalar values
        for pat, spec in compiled:
            if pat.search(name) is not None:
                return spec(leaf) if callable(spec) else spec
        raise ValueError(
            f"Partition rule not found for param: {name!r} "
            f"(shape {shape}); add a rule (a catch-all (r'.*', "
            f"PartitionSpec()) replicates the rest)")

    flat = tree_flatten_with_path(params)
    return tree_unflatten_like(params, [get_spec(p, l) for p, l in flat])


def default_partition_rules(mesh) -> List[Tuple[str, Any]]:
    """The per-zoo-family default rule set: a flax ``kernel`` /
    ``embedding`` splits its LAST dimension and a module's ``weight`` of
    rank >= 2 its FIRST (both the output features / channels) across the
    mesh's ``model`` axis, iff that axis is > 1 and the dimension divides
    it; everything else (biases, BatchNorm scales and statistics, scalars)
    stays replicated."""
    model = int(mesh.shape[MODEL_AXIS])

    def split_last_dim(leaf):
        shape = _leaf_shape(leaf)
        if (model > 1 and len(shape) >= 2 and shape[-1] % model == 0):
            return P(*([None] * (len(shape) - 1)), MODEL_AXIS)
        return P()

    def split_first_dim(leaf):
        shape = _leaf_shape(leaf)
        if (model > 1 and len(shape) >= 2 and shape[0] % model == 0):
            return P(MODEL_AXIS, *([None] * (len(shape) - 1)))
        return P()

    return [
        (r"(^|/)(kernel|embedding)$", split_last_dim),
        (r"(^|/)weight$", split_first_dim),
        (r".*", P()),
    ]


def _axis_shards(mesh, spec) -> int:
    """How many ways ``spec`` splits a leaf on ``mesh`` (1 = replicated)."""
    shards = 1
    for entry in tuple(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            shards *= int(mesh.shape[axis])
    return shards


def spec_shards_leaf(mesh, spec, shape) -> bool:
    """True iff ``spec`` divides a leaf of ``shape`` on ``mesh``, dimension
    by dimension."""
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        n = 1
        for axis in axes:
            n *= int(mesh.shape[axis])
        if dim >= len(shape) or shape[dim] % n:
            return False
    return True


def resolve_param_shardings(params, mesh, rules=None, specs=None):
    """``(shardings, specs)`` trees for ``params``: per-leaf
    ``NamedSharding`` and the matched ``PartitionSpec``.

    ``rules``: a rule list, or a callable ``mesh -> rule list``; ``None``
    uses the default rules.  ``specs``: an explicit per-leaf tree
    mirroring ``params`` (``PartitionSpec`` or ``NamedSharding`` leaves; a
    structure mismatch raises), which takes precedence over ``rules``.
    Any spec that does not divide its leaf on this mesh falls back to
    replicated for that leaf."""
    if specs is not None:
        params_def = tree_structure(params)
        specs_def = tree_structure(specs, is_leaf=_is_spec)
        if specs_def != params_def:
            raise ValueError(
                f"param shardings must mirror the params pytree "
                f"structure (specs {specs_def} vs params {params_def}) "
                f"— a flat or reordered spec tree would silently pair "
                f"specs with the wrong leaves")
        flat_s = [s.spec if isinstance(s, NamedSharding) else s
                  for _, s in tree_flatten_with_path(specs, _is_spec)]
    else:
        if rules is None:
            rules = default_partition_rules(mesh)
        elif callable(rules):
            rules = rules(mesh)
        matched = match_partition_rules(rules, params)
        flat_s = [s for _, s in tree_flatten_with_path(matched, _is_spec)]
    flat_p = [l for _, l in tree_flatten_with_path(params)]
    resolved = []
    for leaf, spec in zip(flat_p, flat_s):
        if tuple(spec) and not spec_shards_leaf(mesh, spec, _leaf_shape(leaf)):
            spec = P()  # indivisible on this mesh: replicate the leaf
        resolved.append(spec)
    out_specs = tree_unflatten_like(params, resolved)
    shardings = tree_unflatten_like(
        params, [NamedSharding(mesh, s) for s in resolved])
    return shardings, out_specs


def spec_is_replicated(spec) -> bool:
    """True iff ``spec`` names no mesh axis (``P()``, ``P(None, None)``)."""
    return all(entry is None for entry in tuple(spec))


def specs_all_replicated(specs) -> bool:
    """True iff every spec in the tree replicates."""
    return all(spec_is_replicated(s)
               for _, s in tree_flatten_with_path(specs, _is_spec))


def spec_to_json(spec) -> list:
    """A ``PartitionSpec`` as a JSON-able per-dimension list (``None`` |
    axis name | list of axis names)."""
    out: list = []
    for entry in tuple(spec):
        if isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append(None if entry is None else str(entry))
    return out


def partition_digest(specs=None) -> str:
    """sha256 over the sorted ``path=spec`` lines of a resolved policy;
    ``"replicated"`` for no policy or an all-replicated one (every
    replicated spelling digests alike)."""
    if specs is None:
        return "replicated"
    flat = tree_flatten_with_path(specs, _is_spec)
    lines = sorted(
        f"{param_path_str(p)}="
        f"{[] if spec_is_replicated(s) else spec_to_json(s)}"
        for p, s in flat)
    if all(line.endswith("=[]") for line in lines):
        return "replicated"
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def param_sharding_stats(mesh, params, specs=None) -> dict:
    """Device-memory accounting of a (possibly sharded) param tree: total
    bytes, per-device bytes under ``specs`` (``None`` = all replicated),
    the largest replicated leaf and the sharded/replicated ratio."""
    leaves = [l for _, l in tree_flatten_with_path(params)]
    if specs is None:
        flat_s = [None] * len(leaves)
    else:
        flat_s = [s for _, s in tree_flatten_with_path(specs, _is_spec)]
    total = 0
    per_chip = 0
    largest_replicated = 0
    sharded_leaves = 0
    for leaf, spec in zip(leaves, flat_s):
        size = _leaf_nbytes(leaf)
        total += size
        shards = 1 if spec is None else _axis_shards(mesh, spec)
        if shards > 1:
            sharded_leaves += 1
            per_chip += size // shards
        else:
            per_chip += size
            largest_replicated = max(largest_replicated, size)
    return {
        "mesh_shape": {str(n): int(mesh.shape[n]) for n in mesh.axis_names},
        "param_bytes_total": total,
        "param_bytes_per_chip": per_chip,
        "largest_replicated_leaf_bytes": largest_replicated,
        "sharded_leaves": sharded_leaves,
        "total_leaves": len(leaves),
        "sharded_vs_replicated_ratio": (round(per_chip / total, 4)
                                        if total else 1.0),
    }
