"""Multi-process scaffolding over ``torch.distributed`` (port of
``sparkdl_tpu/parallel/distributed.py``).

One process per card, as the JAX package runs one controller per host:
:func:`initialize` joins a ``torch.distributed`` process group over
``tcp://``, each rank then runs on its own ``cuda:<rank % device_count>``
(:func:`sparkdl_tpu_torch.resolve_device` gives it), input files are
sharded per rank by a deterministic stride (:func:`shard_files`), and the
fits in :mod:`sparkdl_tpu_torch.parallel.train` all-reduce gradients
across the group.  Everything is a no-op in the one-process case.

Backend: ``nccl`` when every rank can have a card of its own (CUDA is up
and the group is no larger than the cards of this host), ``gloo``
otherwise; ``backend=`` overrides.  NCCL refuses two ranks on one card,
so ranks that share a card run over gloo, whose collectives on CUDA
tensors stage them through the host.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_INITIALIZED = False


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
               **kwargs) -> bool:
    """Join the process group.  Returns True if ``torch.distributed`` was
    initialized here (or already was by this function), False for the
    one-process run (a no-op).

    As the JAX package's: with none of the three arguments given, or
    ``num_processes`` 0 or 1, nothing is initialized.  Otherwise
    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0, ``num_processes`` the world size and ``process_id`` this rank.
    ``backend=`` picks the backend (default :func:`default_backend`); the
    other keyword arguments go to ``init_process_group``."""
    global _INITIALIZED
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
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend=backend, init_method=addr, world_size=int(num_processes),
        rank=rank, **kwargs)
    _INITIALIZED = True
    logger.info("torch.distributed initialized: process %d/%d over %s",
                process_index(), process_count(), backend)
    return True


def shutdown() -> None:
    """Leave the process group (if this module joined one)."""
    global _INITIALIZED
    if _INITIALIZED and _group_up():
        torch.distributed.destroy_process_group()
    _INITIALIZED = False


def process_index() -> int:
    return torch.distributed.get_rank() if _group_up() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _group_up() else 1


def backend() -> Optional[str]:
    """The group's backend name (``"gloo"``, ``"nccl"``), None without a
    group."""
    return str(torch.distributed.get_backend()) if _group_up() else None


def local_device(index: Optional[int] = None) -> torch.device:
    """The card rank ``index`` (default this rank) runs on:
    ``cuda:<index % device_count>``."""
    idx = process_index() if index is None else int(index)
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
    if not _group_up():
        return np.asarray([int(value)], np.int64)
    dev = _collective_device()
    mine = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    out = [torch.zeros_like(mine) for _ in range(process_count())]
    torch.distributed.all_gather(out, mine)
    return torch.cat(out).cpu().numpy()


def put_sharded(sharding, data: Any, device: Optional[torch.device] = None):
    """This rank's LOCAL rows (a host array or a tree of them) as tensors
    on this rank's device (``device``, default
    :func:`sparkdl_tpu_torch.resolve_device`): the global batch is the
    rows of every rank, in rank order, which the fits' collectives
    combine.  ``sharding`` is taken for the JAX signature; the port puts
    no batch on another rank's card."""
    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.parallel.engine import _tree_map

    del sharding
    dev = resolve_device(device)
    return _tree_map(
        lambda a: (a.to(dev) if isinstance(a, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(a)).to(dev)),
        data)
