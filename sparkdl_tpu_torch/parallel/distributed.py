"""Multi-process scaffolding over ``torch.distributed`` (port of
``sparkdl_tpu/parallel/distributed.py``).

One process per card, as the JAX package runs one controller per host:
:func:`initialize` joins a ``torch.distributed`` process group over
``tcp://``, each rank then runs on its own ``cuda:<rank % device_count>``
(:func:`sparkdl_tpu_torch.resolve_device` gives it), input files are
sharded per rank by a deterministic stride (:func:`shard_files`), and the
fits in :mod:`sparkdl_tpu_torch.parallel.train` all-reduce gradients
across the group.  Everything is a no-op in the one-process case.

A rank holds one *slot* (its device) unless it asks for several:
``initialize(..., local_slots=...)`` stands in for a host's local
devices (JAX's ``local_device_ids``, or its CPU devices under
``--xla_force_host_platform_device_count``): ``k`` slots of this rank's
device, or a list of devices, which may repeat (``["cuda:0"] * 2``, two
slots of one card).  Every rank must hold the same number; ``initialize``
all-gathers the counts, so that every rank raises the same
``ValueError`` and none waits.  :func:`global_slots` gives every rank's
slots, in rank order, which ``mesh.get_mesh()`` lays out rank-major.

Backend: ``nccl`` when every rank can have a card of its own (CUDA is up
and the group is no larger than the cards of this host), ``gloo``
otherwise; ``backend=`` overrides.  NCCL refuses two ranks on one card,
so ranks that share a card run over gloo, whose collectives on CUDA
tensors stage them through the host.

Sub-groups of a mesh (:func:`mesh_groups`): where a mesh's data row holds
slots of several ranks, the ranks of a row form a *row group* (where a
split weight's outputs are gathered and its inputs' gradients summed)
and the ranks at the same place in every row a *column group* (where the
gradients of the data rows meet).  ``torch.distributed.new_group`` is
collective, so every rank builds every group of a layout at once, in one
order, and keeps them (:func:`shutdown` destroys them).  A
:class:`RankGroup`'s collectives: :meth:`RankGroup.all_reduce` (a sum, in
place) and :meth:`RankGroup.all_gather` (each member's tensor, in rank
order); under gloo a CUDA tensor is copied into a pinned host buffer,
reduced or gathered there and copied back, so no collective depends on
what gloo takes on the card; under nccl they run on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_INITIALIZED = False

# slot codes: a card's index, the CPU, or this rank's default device
# (``resolve_device()``, read where the slots are)
_CPU_SLOT = -1
_DEFAULT_SLOT = -2
_SLOTS: Optional[np.ndarray] = None  # [ranks, slots] codes, from initialize


def _group_up() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def default_backend(num_processes: int) -> str:
    """``nccl`` iff CUDA is up and each of ``num_processes`` ranks gets a
    card of its own on this host, else ``gloo``."""
    if (torch.cuda.is_available()
            and torch.cuda.device_count() >= int(num_processes)):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_slots: Union[None, int, Sequence] = None,
               **kwargs) -> bool:
    """Join the process group.  Returns True if ``torch.distributed`` was
    initialized here (or already was by this function), False for the
    one-process run (a no-op).

    As the JAX package's: with none of the three arguments given, or
    ``num_processes`` 0 or 1, nothing is initialized.  Otherwise
    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0, ``num_processes`` the world size and ``process_id`` this rank.
    ``local_slots``: this rank's slots (see the module docstring): None
    for one, an int ``k`` for ``k`` slots of this rank's device, or a list
    of devices (``"cpu"``, ``"cuda"`` for this rank's card, ``"cuda:<i>"``;
    a device may repeat).  Ranks that name unequal numbers of slots, or a
    card this host does not have, raise ``ValueError`` on every rank and
    leave no group behind.  ``backend=`` picks the backend (default
    :func:`default_backend`); the other keyword arguments go to
    ``init_process_group``."""
    global _INITIALIZED, _SLOTS
    if _INITIALIZED:
        logger.info("torch.distributed already initialized; skipping")
        return True
    explicit = any(v is not None
                   for v in (coordinator_address, num_processes, process_id))
    if not explicit or num_processes in (0, 1):
        logger.info("single-process run; torch.distributed not initialized")
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id together (nothing here reads a cluster's "
            "environment)")
    addr = str(coordinator_address)
    if "://" not in addr:
        addr = f"tcp://{addr}"
    backend = kwargs.pop("backend", None) or default_backend(num_processes)
    rank = int(process_id)
    mine = _slot_codes(local_slots, rank)
    if torch.cuda.is_available():
        cards = [c for c in (mine or []) if c >= 0]
        torch.cuda.set_device(cards[0] if cards
                              else rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend=backend, init_method=addr, world_size=int(num_processes),
        rank=rank, **kwargs)
    try:
        _SLOTS = _gather_slots(mine)
    except ValueError:
        torch.distributed.destroy_process_group()
        raise
    _INITIALIZED = True
    logger.info("torch.distributed initialized: process %d/%d over %s",
                process_index(), process_count(), backend)
    return True


def _slot_codes(local_slots, rank: int) -> Optional[List[int]]:
    """This rank's slots as codes (a card's index, ``_CPU_SLOT``,
    ``_DEFAULT_SLOT``), or None when it names something this host cannot
    give (reported by :func:`_gather_slots` on every rank)."""
    if local_slots is None:
        return [_DEFAULT_SLOT]
    if isinstance(local_slots, (int, np.integer)):
        return [_DEFAULT_SLOT] * int(local_slots) or None
    codes: List[int] = []
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in local_slots:
        dev = torch.device(d)
        if dev.type == "cpu":
            codes.append(_CPU_SLOT)
        elif dev.type == "cuda" and cards:
            index = rank % cards if dev.index is None else dev.index
            if not 0 <= index < cards:
                return None
            codes.append(index)
        else:
            return None
    return codes or None


def _gather_slots(mine: Optional[List[int]]) -> np.ndarray:
    """Every rank's slot codes, ``[ranks, slots]``: the counts first, so
    that unequal or unusable slots raise the same ``ValueError`` on every
    rank before anything waits on them."""
    counts = allgather_ints(-1 if mine is None else len(mine))
    bad = [r for r, n in enumerate(counts.tolist()) if n < 0]
    if bad:
        raise ValueError(
            f"rank(s) {bad} named local_slots this host cannot give (no "
            f"slot, a card index past torch.cuda.device_count(), or a "
            f"device type other than cpu and cuda)")
    if len(set(counts.tolist())) > 1:
        raise ValueError(
            f"the ranks hold {counts.tolist()} slots: every rank of a group "
            f"must hold the same number (initialize(local_slots=...))")
    return _allgather_vector(mine)


def global_slots(like: Optional[torch.device] = None
                 ) -> List[List[torch.device]]:
    """Every rank's slots, in rank order (one list per rank; ``[[device]]``
    in one process).  A rank's default slot is the device it runs on when
    this process runs on ``like`` (default :func:`sparkdl_tpu_torch.
    resolve_device`): ``cuda:<rank % device_count>``, or the CPU.  In a
    group joined without :func:`initialize` each rank holds its default
    slot."""
    if like is None:
        from sparkdl_tpu_torch import resolve_device

        like = resolve_device()
    count = process_count()
    table = (_SLOTS if _SLOTS is not None and len(_SLOTS) == count
             else np.full((count, 1), _DEFAULT_SLOT))

    def device(rank: int, code: int) -> torch.device:
        if code == _DEFAULT_SLOT:
            if like.type == "cuda":
                return torch.device(
                    "cuda", rank % max(1, torch.cuda.device_count()))
            return torch.device(like.type)
        if code == _CPU_SLOT:
            return torch.device("cpu")
        return torch.device("cuda", int(code))

    return [[device(r, int(c)) for c in row] for r, row in enumerate(table)]


def shutdown() -> None:
    """Leave the process group (if this module joined one), destroying
    the sub-groups :func:`mesh_groups` made first."""
    global _INITIALIZED, _SLOTS
    if _group_up():
        for pg in _MADE:
            torch.distributed.destroy_process_group(pg)
    _MADE.clear()
    _LAYOUTS.clear()
    if _INITIALIZED and _group_up():
        torch.distributed.destroy_process_group()
    _INITIALIZED = False
    _SLOTS = None


class RankGroup:
    """The ranks ``ranks`` (ascending) of a process group that meet in a
    collective: ``pg`` is their ``torch.distributed`` group (None: the
    whole group; unused for one rank).  A group of one rank runs no
    collective."""

    def __init__(self, ranks: Sequence[int], pg=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.pg = pg

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"RankGroup({list(self.ranks)})"

    def _staged(self, t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """(the tensor the collective runs on, whether it is a host copy
        of ``t``): a pinned host copy of a CUDA tensor under gloo."""
        if t.is_cuda and backend() != "nccl":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host, True
        return t.contiguous(), False

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group's ranks, in place; returns ``t``."""
        if self.size == 1:
            return t
        buf, staged = self._staged(t)
        torch.distributed.all_reduce(buf, group=self.pg)
        if staged or buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``t`` (the same shape and type on each), in the
        order of :attr:`ranks`, on ``t``'s device."""
        if self.size == 1:
            return [t]
        buf, staged = self._staged(t)
        out = [torch.empty_like(buf) for _ in self.ranks]
        torch.distributed.all_gather(out, buf, group=self.pg)
        return [o.to(t.device) for o in out] if staged else out

    def differentiable_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the group through which autograd carries the
        gradient back (``torch.distributed.nn``: its backward sums the
        gradient over the same group); the tensor itself for one rank."""
        if self.size == 1:
            return t
        from torch.distributed.nn.functional import all_reduce

        kwargs = {} if self.pg is None else {"group": self.pg}
        return all_reduce(t, **kwargs)


# the sub-groups made that this rank is in, and the layouts they serve
_MADE: list = []
_LAYOUTS: Dict[tuple, Tuple[List[RankGroup], List[RankGroup]]] = {}


def mesh_groups(ranks) -> Tuple[List[RankGroup], List[RankGroup]]:
    """(row groups, column groups) of a mesh whose ``ranks`` grid
    ([data, model]) names the owner of each slot, in a layout
    ``mesh.local_rows`` accepts (every row over as many ranks): row
    group g holds the ranks with slots in data row g; column group j
    holds the j-th rank of every row (its rows' ranks in ascending
    order), the ranks that hold the same model positions in different
    rows, where the data rows' gradients meet.  Where every row lies within one rank, each row group
    is that rank and the one column group is every rank of the mesh.

    Collective: every rank of the process group calls it with the same
    grid, at the same point (``new_group`` is called for every group of
    more than one rank that is not the whole process group, including
    groups this rank is not in, in one order).  The groups are kept per
    layout until :func:`shutdown`."""
    grid = np.asarray(ranks, np.int64)
    key = tuple(map(tuple, grid.tolist()))
    cached = _LAYOUTS.get(key)
    if cached is not None:
        return cached
    rows = [sorted({int(r) for r in row}) for row in grid]
    cols = [sorted({row[j] for row in rows}) for j in range(len(rows[0]))]
    world = list(range(process_count()))
    made: Dict[tuple, Any] = {}

    def group(members: List[int]) -> RankGroup:
        t = tuple(members)
        if len(t) == 1 or list(t) == world:
            return RankGroup(t, None)
        if t not in made:
            made[t] = torch.distributed.new_group(list(t))
            if process_index() in t:
                _MADE.append(made[t])
        return RankGroup(t, made[t])

    out = ([group(r) for r in rows], [group(c) for c in cols])
    _LAYOUTS[key] = out
    return out


def process_index() -> int:
    return torch.distributed.get_rank() if _group_up() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _group_up() else 1


def backend() -> Optional[str]:
    """The group's backend name (``"gloo"``, ``"nccl"``), None without a
    group."""
    return str(torch.distributed.get_backend()) if _group_up() else None


def local_device(index: Optional[int] = None) -> torch.device:
    """The card rank ``index`` (default this rank) runs on: its first
    card among the slots ``initialize`` was given, else ``cuda:<index %
    device_count>``."""
    idx = process_index() if index is None else int(index)
    if _SLOTS is not None and idx < len(_SLOTS):
        cards = [int(c) for c in _SLOTS[idx] if c >= 0]
        if cards:
            return torch.device("cuda", cards[0])
    return torch.device("cuda", idx % max(1, torch.cuda.device_count()))


def shard_files(paths: Sequence[str], index: Optional[int] = None,
                count: Optional[int] = None) -> List[str]:
    """Deterministic per-rank shard of a file list, ``sorted(paths)[index::
    count]``: every rank derives the same global order with no
    coordination, and shard sizes differ by at most one file."""
    idx = process_index() if index is None else int(index)
    cnt = process_count() if count is None else int(count)
    if cnt < 1:
        raise ValueError(f"count must be >= 1, got {cnt}")
    if not (0 <= idx < cnt):
        raise ValueError(f"index {idx} out of range for count {cnt}")
    return sorted(paths)[idx::cnt]


def local_batch_size(global_batch_size: int,
                     count: Optional[int] = None) -> int:
    """Rows THIS rank contributes per global batch."""
    cnt = process_count() if count is None else int(count)
    if global_batch_size % cnt:
        raise ValueError(
            f"global batch {global_batch_size} is not divisible by "
            f"{cnt} processes")
    return global_batch_size // cnt


def _collective_device() -> torch.device:
    """Where a collective's buffer lives: this rank's card under nccl,
    the host under gloo."""
    return local_device() if backend() == "nccl" else torch.device("cpu")


def allgather_ints(value: int) -> np.ndarray:
    """Every rank's ``value``, in rank order (JAX's
    ``multihost_utils.process_allgather`` of a scalar); ``[value]`` in
    one process."""
    return _allgather_vector([int(value)])[:, 0]


def _allgather_vector(values: Sequence[int]) -> np.ndarray:
    """Every rank's ``values`` (the same length on every rank) as a
    ``[ranks, len]`` array, in rank order."""
    if not _group_up():
        return np.asarray([list(values)], np.int64).reshape(1, -1)
    dev = _collective_device()
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64,
                        device=dev)
    out = [torch.zeros_like(mine) for _ in range(process_count())]
    torch.distributed.all_gather(out, mine)
    return torch.stack(out).cpu().numpy()


def put_sharded(sharding, data: Any, device: Optional[torch.device] = None):
    """This rank's LOCAL rows (a host array or a tree of them) as tensors
    on this rank's device (``device``, default
    :func:`sparkdl_tpu_torch.resolve_device`): the global batch is the
    rows of every data row of the mesh, in row order, which the steps'
    collectives combine.  Where a data row holds slots of several ranks,
    the ranks of that row pass the SAME rows (JAX's replica contract for
    ``make_array_from_process_local_data``: replicas hold identical local
    data).  ``sharding`` is taken for the JAX signature; the port puts no
    batch on another rank's card."""
    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.parallel.engine import _tree_map

    del sharding
    dev = resolve_device(device)
    return _tree_map(
        lambda a: (a.to(dev) if isinstance(a, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(a)).to(dev)),
        data)
