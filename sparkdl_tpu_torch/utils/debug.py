"""The epoch-boundary loss check of ``sparkdl_tpu/utils/debug.py`` (its
trimmed copy): ``warn_or_raise_nonfinite_loss`` raises naming the first
diverged step when ``SPARKDL_DEBUG_NANS`` is set (not "", "0" or "false"),
and warns otherwise."""

from __future__ import annotations

import os

import numpy as np

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def checks_enabled() -> bool:
    return os.environ.get("SPARKDL_DEBUG_NANS", "") not in (
        "", "0", "false", "False")


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
        raise FloatingPointError(msg)
    logger.warning("%s — set SPARKDL_DEBUG_NANS=1 to fail fast", msg)
