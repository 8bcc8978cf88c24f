"""The device mesh and the weight-sharding policy (port of
``sparkdl_tpu/parallel/mesh.py``).

The port's own small types stand in for ``jax.sharding``'s:

  * :class:`Mesh`: a grid of ``torch.device``s with ``axis_names ==
    ("data", "model")`` and a ``shape`` mapping (axis name -> size);
  * :class:`PartitionSpec`: a tuple subclass, one entry per dimension
    (``None``, an axis name, or a tuple of axis names);
  * :class:`NamedSharding`: a (mesh, spec) pair.

``get_mesh()`` in one process covers every visible card (``cuda:0`` ...
``cuda:<n-1>``), as ``jax.devices()`` covers every local chip; on the CPU,
or when the default device names one card (``set_default_device
("cuda:1")``), it is that one device.  In a ``torch.distributed`` group of
W ranks it holds every rank's slots, rank-major (one a rank, its
``cuda:<rank % device_count>`` or the CPU, unless
``distributed.initialize(local_slots=...)`` gave each k), shape (W*k, 1),
as ``jax.devices()`` spans every host of a multi-controller run, process
by process.  ``devices=`` may name a device more
than once: each entry is a *slot*, so ``["cpu"] * 8`` stands in for JAX's
8 virtual CPU devices and ``["cuda:0"] * k`` for k cards on one card.  An
engine scores, and a fit trains, on a mesh of this process's devices (in
one process a fit's default mesh is ``get_mesh()``, as JAX's is); in a
group a step's data axis spans the ranks and each rank's own rows, and
its model axis lies within a rank or spans whole ranks (each rank of a
row holding its own shards of every split weight); each rank runs its
slots of the rows it touches (:func:`local_rows`; ``parallel.train``).

:func:`place` is ``jax.device_put`` under ``NamedSharding``s: a split leaf
becomes one slice per slot, a replicated one one copy per distinct device.

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


def _global_devices() -> Tuple[list, list]:
    """(devices, ranks) of every process: every rank's slots of the
    ``torch.distributed`` group, rank-major (``distributed.global_slots``:
    one slot a rank unless ``initialize`` gave it several); in one process
    every visible card when the default device is ``cuda`` without an
    index and more than one card is visible, else that one device (the
    CPU, or one card).  The default mesh of an engine and of a fit
    alike."""
    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.parallel import distributed

    local = resolve_device()
    if distributed.process_count() > 1:
        slots = distributed.global_slots(local)
        return ([d for row in slots for d in row],
                [r for r, row in enumerate(slots) for _ in row])
    if local.type == "cuda" and local.index is None:
        n = torch.cuda.device_count()
        if n > 1:
            return [torch.device("cuda", i) for i in range(n)], [0] * n
    return [local], [0]


def get_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
             devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over the devices of every process (every
    rank's slots, rank-major, in a group; every visible card, or the CPU,
    in one process; see the module docstring), or over ``devices`` (slots
    owned by this process; a device may repeat).  ``num_devices`` keeps
    the first N.  In a group of W ranks holding k slots each (rank-major),
    ``model_parallel`` m gives W*k/m data rows:

      * m divides k: each row lies within one rank, which holds k/m rows
        (data parallel over the ranks and the rank's own rows);
      * k divides m (m > k): each row spans m/k whole ranks, each holding
        k contiguous model positions of its row: a split weight's shards
        belong to different processes (one process: m = 2 on two ranks
        of one slot, or m = 4 on two ranks of two slots);
      * anything else splits a rank's slots over rows unevenly, which
        :func:`local_rows` refuses."""
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


class LocalRows(Mesh):
    """This process's slots of the rows of a mesh it touches
    (:func:`local_rows`), a mesh of its own: ``rows`` are their indices in
    the whole mesh, ``row_ranks`` each row's ranks (ascending) and
    ``positions`` this rank's model positions in each of them (the same
    for every row); ``model_size`` is the whole mesh's model axis."""

    def __init__(self, devices, axis_names, ranks, rows, row_ranks,
                 positions, model_size):
        super().__init__(devices, axis_names, ranks=ranks)
        self.rows = tuple(rows)
        self.row_ranks = tuple(tuple(r) for r in row_ranks)
        self.positions = tuple(positions)
        self.model_size = int(model_size)

    @property
    def spans_ranks(self) -> bool:
        """Whether this rank's rows hold slots of other ranks too."""
        return any(len(r) > 1 for r in self.row_ranks)


def _row_blocks(row) -> List[Tuple[int, int, int]]:
    """A row's ranks as (rank, first position, slots) runs."""
    blocks: List[List[int]] = []
    for pos, r in enumerate(int(v) for v in row):
        if blocks and blocks[-1][0] == r:
            blocks[-1][2] += 1
        else:
            blocks.append([r, pos, 1])
    return [tuple(b) for b in blocks]


def local_rows(mesh) -> LocalRows:
    """This process's slots of the rows of ``mesh`` it touches
    (:class:`LocalRows`; the mesh itself in one process): what a step
    runs here, while the data axis of ``mesh`` spans every rank.

    Supported layouts (what :func:`get_mesh` gives, see its docstring):
    every row within one rank, each rank holding the same number of whole
    rows; or every row spanning the same number of whole ranks, each rank
    in one row and holding the same number of contiguous model positions
    there.  A rank whose slots of a row are not contiguous, a row whose
    ranks hold unequal numbers of its slots, rows over different numbers
    of ranks, a rank in several rows that span ranks, unequal rows per
    rank, or a rank with no slot raise ``ValueError`` (the same on every
    rank)."""
    from sparkdl_tpu_torch.parallel import distributed

    ranks = np.asarray(mesh.ranks)
    shape = dict(mesh.shape)
    blocks = [_row_blocks(row) for row in ranks]
    for g, bl in enumerate(blocks):
        who = [b[0] for b in bl]
        if len(set(who)) != len(who) or len({b[2] for b in bl}) > 1:
            raise ValueError(
                f"mesh {shape}: data row {g} holds slots of ranks "
                f"{ranks[g].tolist()}; a row's ranks must each hold the "
                f"same number of contiguous slots of it (get_mesh's "
                f"rank-major layout with a model_parallel that divides, "
                f"or is a multiple of, each rank's slots)")
    widths = sorted({len(bl) for bl in blocks})
    me, count = distributed.process_index(), distributed.process_count()
    rows = [sum(any(b[0] == r for b in bl) for bl in blocks)
            for r in range(count)]
    if len(widths) > 1 or (widths[0] > 1 and max(rows) > 1):
        raise ValueError(
            f"mesh {shape}: its rows hold slots of {[len(b) for b in blocks]}"
            f" ranks, the ranks {rows} rows: supported are rows that each "
            f"lie within one rank, or rows that each span the same number "
            f"of whole ranks with every rank in one row (get_mesh's "
            f"rank-major layout with a model_parallel that divides, or is "
            f"a multiple of, each rank's slots)")
    if rows[me] == 0 or (count > 1 and len(set(rows)) > 1):
        raise ValueError(
            f"mesh {shape} gives the ranks {rows} data rows: in a "
            f"group every rank holds the same number of whole rows (the "
            f"default mesh, get_mesh(), spans every rank's slots)")
    mine = [g for g, bl in enumerate(blocks) if any(b[0] == me for b in bl)]
    _, start, n = next(b for b in blocks[mine[0]] if b[0] == me)
    cols = list(range(start, start + n))
    devices = np.asarray(mesh.devices)[mine][:, cols]
    return LocalRows(devices, mesh.axis_names, ranks[mine][:, cols],
                     rows=mine,
                     row_ranks=[[b[0] for b in blocks[g]] for g in mine],
                     positions=cols,
                     model_size=int(np.asarray(mesh.devices).shape[1]))


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


def model_split_dim(mesh, spec) -> Optional[int]:
    """The dimension ``spec`` splits a leaf on over ``mesh``'s model axis
    (None: the leaf is whole in every slot).  A split on the data axis
    raises: an engine and a train step split weights on the model axis
    only."""
    if _axis_shards(mesh, spec) == 1:
        return None
    for dim, entry in enumerate(tuple(spec)):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        if DATA_AXIS in axes and int(mesh.shape[DATA_AXIS]) > 1:
            raise NotImplementedError(
                f"a weight split on the data axis ({spec!r}): weights are "
                f"split on the model axis only")
        if MODEL_AXIS in axes:
            return dim
    return None


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
    # a module's specs are keyed by ``state_dict`` names: spelled with
    # ``/`` as its leaves' paths are, so the digest is JAX's for the same
    # tree
    lines = sorted(
        f"{param_path_str(p).replace('.', '/')}="
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


# ---------------------------------------------------------------------------
# placement: jax.device_put under NamedShardings


def _slot_index(mesh, spec, shape, coords: dict) -> tuple:
    """The slice of a leaf of ``shape`` that the slot at mesh coordinates
    ``coords`` (axis name -> index) holds under ``spec``."""
    index = []
    for dim, size in enumerate(shape):
        entry = tuple(spec)[dim] if dim < len(tuple(spec)) else None
        if entry is None:
            index.append(slice(None))
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        k, n = 0, 1
        for axis in axes:  # the first axis named is the slowest, as in JAX
            k = k * int(mesh.shape[axis]) + int(coords[axis])
            n *= int(mesh.shape[axis])
        step = size // n
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index)


class Shard:
    """One slot's piece of a placed leaf (JAX's ``addressable_shards``
    entry): its device, its index into the whole and its data."""

    def __init__(self, device: torch.device, index: tuple,
                 data: torch.Tensor):
        self.device = device
        self.index = index
        self.data = data


class Placed:
    """A leaf placed on a mesh by :func:`place`: ``slots`` holds one tensor
    per slot, in the mesh's flat order.  Slots on one device that hold the
    same slice share one tensor."""

    def __init__(self, sharding: NamedSharding, shape: tuple, dtype,
                 slots: List[torch.Tensor], indices: List[tuple]):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.slots = slots
        self._indices = indices

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def addressable_shards(self) -> List[Shard]:
        devs = list(self.sharding.mesh.devices.flat)
        return [Shard(d, i, t) for d, i, t in
                zip(devs, self._indices, self.slots)]

    def slot(self, data: int, model: int) -> torch.Tensor:
        """The tensor of the slot at row ``data``, column ``model``."""
        cols = int(self.sharding.mesh.devices.shape[1])
        return self.slots[data * cols + model]


def place(tree, shardings):
    """``tree``'s leaves (tensors or numpy arrays) placed on the mesh of
    ``shardings`` (one ``NamedSharding`` for every leaf, or a tree of them
    mirroring ``tree``): each leaf becomes a :class:`Placed`.  A split
    leaf is sliced per slot along its spec, each slice on its slot's
    device; a replicated leaf is copied once per distinct device.  Slots
    that repeat a device share that device's copy of a slice (so
    ``["cuda:0"] * 8`` does not hold eight copies of a replicated leaf),
    and a whole leaf already on a slot's device is taken as it is."""
    flat = tree_flatten_with_path(tree)
    if isinstance(shardings, NamedSharding):
        flat_sh = [shardings] * len(flat)
    else:
        flat_sh = [s for _, s in tree_flatten_with_path(shardings, _is_spec)]
        if len(flat_sh) != len(flat):
            raise ValueError(f"{len(flat_sh)} shardings for {len(flat)} "
                             f"leaves")
    placed = []
    for (_, leaf), sh in zip(flat, flat_sh):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        mesh = sh.mesh
        shape = tuple(t.shape)
        copies: dict = {}
        slots, indices = [], []
        for pos, dev in zip(np.ndindex(*mesh.devices.shape),
                            mesh.devices.flat):
            dev = torch.device(dev)
            coords = dict(zip(mesh.axis_names, pos))
            index = _slot_index(mesh, sh.spec, shape, coords)
            key = (str(dev), tuple((s.start, s.stop) for s in index))
            piece = copies.get(key)
            if piece is None:
                if all(s.start is None for s in index):
                    piece = t if t.device == dev else t.to(dev)
                else:
                    # a storage of its own (a view would hold the whole
                    # leaf), in the leaf's memory format where the slice
                    # keeps it dense (a channels_last conv weight's)
                    piece = t[index].to(dev).clone(
                        memory_format=torch.preserve_format)
                copies[key] = piece
            slots.append(piece)
            indices.append(index)
        placed.append(Placed(sh, shape, t.dtype, slots, indices))
    return tree_unflatten_like(tree, placed)

