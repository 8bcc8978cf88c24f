"""Numerical checks, opt-in (port of ``sparkdl_tpu/utils/debug.py``).

* ``enable_nan_checks()``: the JAX package turns on ``jax_debug_nans``
  (any NaN produced inside a jitted program raises at the op that made
  it).  Torch has no such flag; its counterpart here is
  ``torch.autograd.set_detect_anomaly(True)``, which names the backward op
  that produced a NaN and the forward op it came from.  It does not catch a
  NaN produced in the forward: the epoch-boundary loss check does.
* ``warn_or_raise_nonfinite_loss(step_losses, epoch)``: what the train
  loops call at each epoch boundary (a host sync per step would stall the
  device): raises naming the first diverged step when checks are enabled,
  warns otherwise.
* ``check_finite(tree)``: a host-side assert over nested dicts, lists and
  tuples of arrays and tensors (params, gradients, features).
* ``checks_enabled()``: on after ``enable_checks()`` or with
  ``SPARKDL_DEBUG_NANS`` set (not "", "0" or "false").

As in the JAX package, ``disable_checks`` turns anomaly mode off only if
this module turned it on: a user's own setting survives.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ENABLED: bool = False
_ANOMALY_SET_BY_US: bool = False


def checks_enabled() -> bool:
    return _ENABLED or os.environ.get("SPARKDL_DEBUG_NANS", "") not in (
        "", "0", "false", "False")


def enable_checks(nan_debug: bool = True) -> None:
    """Turn on numerical checks for this process.  ``nan_debug=True`` also
    turns on anomaly mode (:func:`enable_nan_checks`): NaNs localised in
    backward at several times the step's cost; False keeps only the cheap
    epoch-boundary loss check."""
    global _ENABLED
    _ENABLED = True
    if nan_debug:
        enable_nan_checks()


def disable_checks() -> None:
    """Turn checks off; turns anomaly mode off only if this module turned
    it on."""
    global _ENABLED, _ANOMALY_SET_BY_US
    _ENABLED = False
    if _ANOMALY_SET_BY_US:
        torch.autograd.set_detect_anomaly(False)
        _ANOMALY_SET_BY_US = False


def enable_nan_checks() -> None:
    """Anomaly mode on (the counterpart of ``jax_debug_nans``), owned by
    this module only if it was off."""
    global _ANOMALY_SET_BY_US
    if not torch.is_anomaly_enabled():
        torch.autograd.set_detect_anomaly(True)
        _ANOMALY_SET_BY_US = True
    logger.info("autograd anomaly mode enabled: NaNs in backward raise at "
                "the producing op")


def warn_or_raise_nonfinite_loss(step_losses, epoch: int) -> None:
    """``step_losses``: the epoch's per-step losses as host floats.  Raises
    (checks enabled) naming the first non-finite step, or warns."""
    arr = np.asarray(step_losses, dtype=np.float64)
    if arr.size == 0 or np.isfinite(arr).all():
        return
    first_bad = int(np.nonzero(~np.isfinite(arr))[0][0])
    msg = (f"non-finite loss at epoch {epoch + 1} (first at step "
           f"{first_bad + 1}/{arr.size})")
    if checks_enabled():
        raise FloatingPointError(
            msg + "; utils.debug.enable_nan_checks() localizes the "
                  "producing op")
    logger.warning("%s — set SPARKDL_DEBUG_NANS=1 to fail fast", msg)


def _leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX's flattening order, each path entry written as
    JAX writes its key: ``['k']`` for a dict key, ``[i]`` for a list or
    tuple index, ``.name`` for a namedtuple field.  ``None`` is no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (f"[{i}]",))
    else:
        yield path, tree


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_floating_point() and t.dtype not in (torch.float32,
                                                     torch.float64):
            t = t.float()  # bf16 / f16: numpy has no bf16
        return t.cpu().numpy()
    return np.asarray(leaf)


def check_finite(tree: Any, what: str = "value") -> None:
    """Raise ``FloatingPointError`` if any float leaf of ``tree`` (nested
    dicts, lists and tuples of numpy arrays and tensors, CUDA tensors copied
    to the host) holds a non-finite value; integer leaves are skipped.  The
    message names the bad leaves as the JAX package does."""
    bad: List[str] = []
    for path, leaf in _leaves_with_path(tree):
        arr = _host(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append("/".join(path) or "<root>")
    if bad:
        raise FloatingPointError(
            f"non-finite {what}: {bad[:5]}{'...' if len(bad) > 5 else ''} "
            f"(enable_nan_checks() localizes the producing op)")
