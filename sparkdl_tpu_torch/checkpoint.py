"""Checkpoint save/restore (port of ``sparkdl_tpu/checkpoint.py``).

The JAX package writes orbax directories; the port writes one
``torch.save`` file per checkpoint directory (``<path>/tree.pt``), loaded
with ``weights_only=True`` as ``persistence.py`` loads stage tensors.  A
tree is nested dicts, lists and tuples of tensors, numpy arrays (saved as
tensors: ``weights_only`` loads no numpy object), numbers, strings and
None.  The JAX package's orbax checkpoints are not read.

:class:`TrainCheckpointer` keeps the JAX package's epoch-granular layout
(``<dir>/epoch_<k>``), cadence, ``latest()`` and single-writer rule, so an
interrupted fit resumes at the last saved epoch.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_FILE = "tree.pt"


def _storable(tree: Any) -> Any:
    """``tree`` with numpy arrays as CPU tensors and tensors detached on
    the CPU."""
    if isinstance(tree, dict):
        return {k: _storable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_storable(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_pytree(path: str, tree: Any, *, force: bool = True) -> str:
    """Save ``tree`` to the directory ``path``.  The file is written into a
    temporary directory that is renamed into place, so a reader never sees
    a half-written checkpoint."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not force:
            raise FileExistsError(f"{path} exists; pass force=True")
        shutil.rmtree(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_storable(tree), os.path.join(tmp, _FILE))
    os.replace(tmp, path)
    return path


def restore_pytree(path: str, template: Optional[Any] = None) -> Any:
    """Restore a tree saved by :func:`save_pytree` (arrays come back as CPU
    tensors).  ``template`` is accepted for the JAX package's signature;
    the file carries its own structure and dtypes."""
    del template
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      weights_only=True)


class TrainCheckpointer:
    """Epoch-granular save/resume for fits.

    Layout: ``<dir>/epoch_<k>`` checkpoints holding ``{"state": ...,
    "epoch": k}``.  ``latest()`` finds the newest epoch so an interrupted
    fit restarts where it stopped.
    """

    def __init__(self, directory: str, every_epochs: int = 1):
        self.directory = os.path.abspath(directory)
        self.every_epochs = max(1, int(every_epochs))
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:06d}")

    def due(self, epoch: int) -> bool:
        """Whether the cadence saves at ``epoch`` — check this BEFORE
        copying device state to the host so skipped epochs pay nothing."""
        return epoch % self.every_epochs == 0

    @staticmethod
    def is_writer() -> bool:
        """Single-writer rule: rank 0 of ``torch.distributed`` writes when
        a process group is initialized; a single process always does."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def maybe_save(self, epoch: int, state: Any) -> Optional[str]:
        """Save ``state`` (any tree, e.g. {"params":..., "opt_state":...})
        if the epoch hits the cadence and this process writes; returns the
        path if saved."""
        if not self.due(epoch) or not self.is_writer():
            return None
        path = self._path(epoch)
        save_pytree(path, {"state": state, "epoch": epoch})
        logger.info("checkpointed epoch %d -> %s", epoch, path)
        return path

    def latest(self) -> Optional[Tuple[int, str]]:
        if not os.path.isdir(self.directory):
            return None
        epochs = []
        for name in os.listdir(self.directory):
            if name.startswith("epoch_") and not name.endswith(".tmp"):
                try:
                    epochs.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        if not epochs:
            return None
        e = max(epochs)
        return e, self._path(e)

    def restore_latest(self, template: Optional[Any] = None
                       ) -> Optional[Tuple[int, Any]]:
        """(epoch, state) of the newest checkpoint, or None."""
        found = self.latest()
        if found is None:
            return None
        epoch, path = found
        tree = restore_pytree(path, template)
        logger.info("resuming from %s (epoch %d)", path, epoch)
        return epoch, tree["state"]
