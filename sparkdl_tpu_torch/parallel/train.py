"""Head fits on one device (port of the single-device part of
``sparkdl_tpu/parallel/train.py``).

``fit_data_parallel`` fits a dict of parameters on host arrays (x, y) with
``torch.autograd`` and a ``torch.optim`` optimizer, on the device
:func:`~sparkdl_tpu_torch.resolve_device` gives (``cuda`` unless the CPU
was asked for).  It draws the same batches as the JAX fit on a one-device
mesh (:func:`_epoch_batches` is a copy of JAX's), takes the loss mean over
each batch, and fetches the step losses once per group of
``steps_per_execution`` steps.

Not ported yet (queue A item 6 of ROADMAP.md): the device mesh and
multi-process input, BatchNorm-statistics training (``train_fn`` /
``stats``), checkpointing and the streaming fit.  Those arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.utils import debug
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_EPS = 1e-7
_LATER = "not ported yet (ROADMAP.md queue A item 6)"


# ---------------------------------------------------------------------------
# losses: fn(pred, y) -> per-example loss vector [B]

def _categorical_crossentropy(pred, y):
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    return -torch.sum(y * torch.log(p), dim=-1)


def _sparse_categorical_crossentropy(pred, y):
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    idx = y.long()
    return -torch.log(torch.gather(p, -1, idx[:, None])[:, 0])


def _binary_crossentropy(pred, y):
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    p = p.reshape(p.shape[0], -1)
    yb = y.reshape(y.shape[0], -1).to(p.dtype)
    return -torch.mean(yb * torch.log(p) + (1 - yb) * torch.log(1 - p),
                       dim=-1)


def _mse(pred, y):
    d = (pred - y).reshape(pred.shape[0], -1)
    return torch.mean(d * d, dim=-1)


def _mae(pred, y):
    d = torch.abs(pred - y).reshape(pred.shape[0], -1)
    return torch.mean(d, dim=-1)


LOSSES: Dict[str, Callable] = {
    "categorical_crossentropy": _categorical_crossentropy,
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "mse": _mse,
    "mae": _mae,
}


def resolve_loss(loss) -> Callable:
    if callable(loss):
        return loss
    fn = LOSSES.get(str(loss))
    if fn is None:
        raise ValueError(f"Unknown loss {loss!r}; known: {sorted(LOSSES)}")
    return fn


def softmax_cross_entropy(logits: torch.Tensor, y: torch.Tensor
                          ) -> torch.Tensor:
    """Per-example cross entropy of integer labels on logits (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    return F.cross_entropy(logits, y.long(), reduction="none")


# ---------------------------------------------------------------------------
# train step


def make_train_step(predict_fn: Callable, loss,
                    optimizer: torch.optim.Optimizer, params) -> Callable:
    """``step(x, y) -> loss``: one optimizer step of ``optimizer`` (built
    over the tensors of ``params``) on the batch mean of
    ``loss(predict_fn(params, x), y)``.  The loss comes back as a 0-d
    device tensor, not fetched."""
    loss_fn = resolve_loss(loss)

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        lval = torch.mean(loss_fn(predict_fn(params, x), y))
        lval.backward()
        optimizer.step()
        return lval.detach()

    return step


def _epoch_batches(x: np.ndarray, y: np.ndarray, batch_size: int,
                   epoch: int, shuffle: bool, seed: int,
                   num_steps: Optional[int] = None):
    """One epoch of fixed-shape batches: the last ragged batch is wrapped
    with leading samples so every batch has the full shape.  Per-epoch
    seeding keeps the order deterministic.  ``num_steps`` pins the number
    of batches yielded (wrapping modularly).  A copy of the JAX package's,
    so both fits draw the same index sequence."""
    n = x.shape[0]
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)
    steps = -(-n // batch_size) if num_steps is None else int(num_steps)
    for s in range(steps):
        off = s * batch_size
        idx = order[off:off + batch_size]
        if len(idx) < batch_size:
            # Modular wrap keeps the batch exactly batch_size even when the
            # dataset is smaller than the shortfall (n < batch_size - len).
            idx = np.take(order, np.arange(off, off + batch_size) % n)
        yield x[idx], y[idx]


def _run_grouped_steps(step: Callable, spe: int, batches: Iterable,
                       device: torch.device) -> List[float]:
    """Drive one epoch's batches through ``step`` in groups of ``spe``:
    the group's steps are enqueued back to back and its losses fetched in
    one device-to-host copy.  Returns the per-step loss series, the same
    for every ``spe``."""
    losses: List[float] = []
    group: List[torch.Tensor] = []

    def flush():
        losses.extend(torch.stack(group).cpu().tolist())
        group.clear()

    for bx, by in batches:
        group.append(step(torch.from_numpy(bx).to(device),
                          torch.from_numpy(by).to(device)))
        if len(group) == spe:
            flush()
    if group:
        flush()
    return losses


def fit_data_parallel(predict_fn: Callable, params, x: np.ndarray,
                      y: np.ndarray, *,
                      optimizer: Optional[Callable] = None,
                      loss="categorical_crossentropy",
                      batch_size: int = 32,
                      epochs: int = 1,
                      shuffle: bool = True,
                      seed: int = 0,
                      device: DeviceLike = None,
                      checkpoint_dir: Optional[str] = None,
                      train_fn: Optional[Callable] = None,
                      stats=None,
                      steps_per_execution: int = 1
                      ) -> Tuple[Dict[str, np.ndarray], List[float]]:
    """Fit ``params`` (a dict of host arrays) on (x, y) on one device.

    ``predict_fn(params, x) -> pred`` on tensors; ``loss(pred, y) -> [B]``
    (a name from :data:`LOSSES` or a callable); ``optimizer(tensors) ->
    torch.optim.Optimizer`` (default Adam, lr 1e-3, as JAX's default).
    The batch is ``min(batch_size, n)``.  ``steps_per_execution`` steps
    run per loss fetch, with the same loss series as 1.  Returns (fitted
    params as host arrays, per-epoch mean losses); a non-finite epoch
    mean warns, or raises under ``SPARKDL_DEBUG_NANS=1``."""
    if checkpoint_dir is not None:
        raise NotImplementedError(f"checkpoint_dir: {_LATER}")
    if train_fn is not None or stats is not None:
        raise NotImplementedError(f"train_fn/stats: {_LATER}")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(f"multi-process input: {_LATER}")
    dev = resolve_device(device)
    batch_size = min(int(batch_size), max(1, x.shape[0]))
    tensors = {k: torch.tensor(np.asarray(v), device=dev, requires_grad=True)
               for k, v in params.items()}
    opt = (optimizer(list(tensors.values())) if optimizer is not None
           else torch.optim.Adam(list(tensors.values()), lr=1e-3))
    step = make_train_step(predict_fn, loss, opt, tensors)
    spe = max(1, int(steps_per_execution))
    epoch_losses: List[float] = []
    for epoch in range(epochs):
        step_losses = _run_grouped_steps(
            step, spe, _epoch_batches(x, y, batch_size, epoch, shuffle, seed),
            dev)
        if not step_losses:
            raise ValueError("fit produced no batches (zero-row dataset?)")
        mean = float(np.mean(step_losses))
        if not np.isfinite(mean):
            debug.warn_or_raise_nonfinite_loss(step_losses, epoch)
        epoch_losses.append(mean)
    fitted = {k: t.detach().cpu().numpy() for k, t in tensors.items()}
    return fitted, epoch_losses
