"""Fits on one device (port of the single-device part of
``sparkdl_tpu/parallel/train.py``).

``fit_data_parallel`` fits a tree of parameters (nested dicts of host
arrays or tensors) on host arrays (x, y) with ``torch.autograd`` and a
``torch.optim`` optimizer, on the device
:func:`~sparkdl_tpu_torch.resolve_device` gives (``cuda`` unless the CPU
was asked for).  It draws the same batches as the JAX fit on a one-device
mesh (:func:`_epoch_batches` is a copy of JAX's), takes the loss mean over
each batch, and fetches the step losses once per group of
``steps_per_execution`` steps.  With ``train_fn`` + ``stats`` the step
also carries BatchNorm statistics (JAX's ``make_train_step_with_stats``);
with ``checkpoint_dir`` the params, the optimizer's ``state_dict`` and the
statistics are saved on the epoch cadence and a fit resumes from the
newest checkpoint (``checkpoint.py``).  Steps run eagerly: the JAX
package's compiled step has no counterpart yet.
``fit_data_parallel_stream`` runs the same loop over a re-iterable chunk
source, holding O(chunk + batch) rows (:func:`_stream_epoch_batches` is a
copy of JAX's).

Not ported yet (ROADMAP.md queue A item 4): the device mesh and
multi-process input (either fit in a ``torch.distributed`` group of more
than one process raises ``NotImplementedError``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.param.converters import (NamedOptimizer,
                                                required_positional)
from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map
from sparkdl_tpu_torch.utils import debug
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)

_EPS = 1e-7
_LATER = ("not ported yet (ROADMAP.md queue A item 4: the device mesh and "
          "multi-process input)")


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


def make_train_step_with_stats(train_fn: Callable, loss,
                               optimizer: torch.optim.Optimizer, params,
                               stats: Dict[str, Any]) -> Callable:
    """Like :func:`make_train_step` for models whose ``train_fn({"params":
    ..., "batch_stats": ...}, x) -> (pred, new_stats)`` updates BatchNorm
    statistics: ``stats["batch_stats"]`` holds the current statistics and
    each step replaces it with the new ones (detached)."""
    loss_fn = resolve_loss(loss)

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        pred, new_stats = train_fn(
            {"params": params, "batch_stats": stats["batch_stats"]}, x)
        lval = torch.mean(loss_fn(pred, y))
        lval.backward()
        optimizer.step()
        stats["batch_stats"] = _tree_map(lambda t: t.detach(), new_stats)
        return lval.detach()

    return step


# one optimizer factory per zero-argument factory, pinned with it so that
# its id is not reused (the JAX package's _OPT_INSTANCES)
_OPT_INSTANCES: Dict[int, Tuple[Callable, Callable]] = {}
_DEFAULT_OPTIMIZER = NamedOptimizer("adam")


def clear_optimizer_instances() -> None:
    _OPT_INSTANCES.clear()


def _resolve_optimizer(optimizer) -> Callable:
    """None, a zero-argument factory or a factory ``params -> Optimizer``
    (``SparkDLTypeConverters.toOptimizer``'s forms) -> a factory ``params
    -> Optimizer``.  A zero-argument factory is called once and its
    result kept, as the JAX package keeps one optax transformation per
    factory; the default is Adam at lr 1e-3 (optax's)."""
    if optimizer is None:
        return _DEFAULT_OPTIMIZER
    if not required_positional(optimizer):
        inst = _OPT_INSTANCES.get(id(optimizer))
        if inst is None:
            inst = (optimizer, optimizer())
            _OPT_INSTANCES[id(optimizer)] = inst
        return inst[1]
    return optimizer


def _epoch_batches(x: np.ndarray, y: np.ndarray, batch_size: int,
                   epoch: int, shuffle: bool, seed: int,
                   num_steps: Optional[int] = None):
    """One epoch of fixed-shape batches: the last ragged batch is wrapped
    with leading samples so every batch has the full shape.  Per-epoch
    seeding keeps the order deterministic (and so resumable).
    ``num_steps`` pins the number of batches yielded (wrapping modularly).
    A copy of the JAX package's, so both fits draw the same index
    sequence."""
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


def _stream_epoch_batches(chunks: Iterable, batch_size: int,
                          num_steps: Optional[int] = None):
    """Fixed-shape batches from a stream of (x_chunk, y_chunk) pairs: the
    larger-than-RAM counterpart of :func:`_epoch_batches`, buffering at most
    O(chunk + batch) rows.  The ragged tail is wrapped with rows kept from
    the first batch (the same wrap to the full shape, without holding the
    epoch).  With ``num_steps`` the stream is truncated or extended (whole
    kept batches) to exactly that many steps.  A copy of the JAX
    package's, but for one repair: a stream shorter than one batch under a
    pinned count repeats its wrapped full batch, where JAX's repeats the
    rows before the wrap (a short batch)."""
    buf_x: list = []
    buf_y: list = []
    buffered = 0
    head: Optional[Tuple[np.ndarray, np.ndarray]] = None
    emitted = 0

    def drain_batches():
        nonlocal buffered, head, emitted
        while buffered >= batch_size:
            x = np.concatenate([np.asarray(c) for c in buf_x], axis=0)
            y = np.concatenate([np.asarray(c) for c in buf_y], axis=0)
            buf_x.clear()
            buf_y.clear()
            bx, by = x[:batch_size], y[:batch_size]
            rest_x, rest_y = x[batch_size:], y[batch_size:]
            if len(rest_x):
                buf_x.append(rest_x)
                buf_y.append(rest_y)
            buffered = len(rest_x)
            if head is None:
                head = (bx.copy(), by.copy())
            emitted += 1
            yield bx, by

    for cx, cy in chunks:
        cx, cy = np.asarray(cx), np.asarray(cy)
        if cx.shape[0] == 0:
            continue
        buf_x.append(cx)
        buf_y.append(cy)
        buffered += cx.shape[0]
        for b in drain_batches():
            yield b
            if num_steps is not None and emitted >= num_steps:
                return
    # ragged tail: wrap with kept rows to the full batch shape
    if buffered and (num_steps is None or emitted < num_steps):
        x = np.concatenate([np.asarray(c) for c in buf_x], axis=0)
        y = np.concatenate([np.asarray(c) for c in buf_y], axis=0)
        short = head is None  # stream smaller than one batch
        if short:
            head = (x, y)
        pad = batch_size - x.shape[0]
        while pad > 0:
            take = min(pad, head[0].shape[0])
            x = np.concatenate([x, head[0][:take]], axis=0)
            y = np.concatenate([y, head[1][:take]], axis=0)
            pad -= take
        if short:
            # the kept batch is the wrapped one (JAX keeps the rows before
            # the wrap, and a pinned count then repeats a short batch)
            head = (x, y)
        emitted += 1
        yield x, y
    # short stream under a pinned step count: repeat the kept batch
    while num_steps is not None and emitted < num_steps and head is not None:
        emitted += 1
        yield head


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


def _leaf(value, device: torch.device, grad: bool) -> torch.Tensor:
    """A new tensor on ``device`` holding ``value`` (host array or
    tensor), a leaf that requires grad when ``grad``."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to(device, copy=True)
    else:
        t = torch.from_numpy(np.array(value)).to(device)
    return t.requires_grad_(grad)


def _host(tree):
    """A tree of tensors as numpy arrays."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _single_process(what: str) -> None:
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(f"{what} in a process group: {_LATER}")


def _fit(predict_fn: Callable, params, epoch_batches: Callable[[int], Iterable],
         no_rows: str, *, optimizer, loss, epochs: int, device: DeviceLike,
         checkpoint_dir: Optional[str], checkpoint_every_epochs: int,
         metrics: Optional[Metrics], train_fn: Optional[Callable], stats,
         steps_per_execution: int) -> Tuple[Any, List[float]]:
    """The loop both fits share: ``epoch_batches(epoch)`` gives the epoch's
    (x, y) host batches; ``no_rows`` is the ``ValueError`` an epoch without
    a batch raises.  See :func:`fit_data_parallel` for the rest."""
    dev = resolve_device(device)
    make_opt = _resolve_optimizer(optimizer)
    with_stats = train_fn is not None
    tensors = _tree_map(lambda v: _leaf(v, dev, True), params)
    opt = make_opt(_tree_leaves(tensors))
    stats_ref = {"batch_stats": _tree_map(lambda v: _leaf(v, dev, False),
                                          stats if stats is not None else {})}

    start_epoch = 0
    ckptr = None
    if checkpoint_dir:
        from sparkdl_tpu_torch.checkpoint import TrainCheckpointer

        ckptr = TrainCheckpointer(checkpoint_dir, checkpoint_every_epochs)
        resumed = ckptr.restore_latest()
        if resumed is not None:
            start_epoch, state = resumed
            with torch.no_grad():
                for t, v in zip(_tree_leaves(tensors),
                                _tree_leaves(state["params"])):
                    t.copy_(v)
            opt.load_state_dict(state["opt_state"])
            if with_stats:
                stats_ref["batch_stats"] = _tree_map(
                    lambda v: _leaf(v, dev, False), state["batch_stats"])

    def ckpt_state():  # save_pytree copies the tensors to the host
        state = {"params": tensors, "opt_state": opt.state_dict()}
        if with_stats:
            state["batch_stats"] = stats_ref["batch_stats"]
        return state

    if with_stats:
        step = make_train_step_with_stats(train_fn, loss, opt, tensors,
                                          stats_ref)
    else:
        step = make_train_step(predict_fn, loss, opt, tensors)
    metrics = metrics if metrics is not None else Metrics()
    spe = max(1, int(steps_per_execution))
    epoch_losses: List[float] = []
    for epoch in range(start_epoch, epochs):
        step_losses = _run_grouped_steps(step, spe, epoch_batches(epoch), dev)
        if not step_losses:
            raise ValueError(no_rows)
        mean = float(np.mean(step_losses))
        if not np.isfinite(mean):
            debug.warn_or_raise_nonfinite_loss(step_losses, epoch)
        epoch_losses.append(mean)
        metrics.record_time("epoch_loss", mean)
        if ckptr is not None and ckptr.due(epoch + 1) and ckptr.is_writer():
            # copied to the host only on epochs the cadence saves
            ckptr.maybe_save(epoch + 1, ckpt_state())
    if with_stats:
        return ({"params": _host(tensors),
                 "batch_stats": _host(stats_ref["batch_stats"])},
                epoch_losses)
    return _host(tensors), epoch_losses


def fit_data_parallel(predict_fn: Callable, params, x: np.ndarray,
                      y: np.ndarray, *,
                      optimizer=None,
                      loss="categorical_crossentropy",
                      batch_size: int = 32,
                      epochs: int = 1,
                      shuffle: bool = True,
                      seed: int = 0,
                      device: DeviceLike = None,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_every_epochs: int = 1,
                      metrics: Optional[Metrics] = None,
                      train_fn: Optional[Callable] = None,
                      stats=None,
                      steps_per_execution: int = 1) -> Tuple[Any, List[float]]:
    """Fit ``params`` (nested dicts of host arrays or tensors; tensors are
    copied, never trained in place) on (x, y) on one device.

    ``predict_fn(params, x) -> pred`` on tensors; ``loss(pred, y) -> [B]``
    (a name from :data:`LOSSES` or a callable); ``optimizer``: a factory
    ``params -> torch.optim.Optimizer``, a zero-argument factory returning
    one, or None (Adam at lr 1e-3, as JAX's default).  The batch is
    ``min(batch_size, n)``.  ``steps_per_execution`` steps run per loss
    fetch, with the same loss series as 1.

    With ``train_fn`` + ``stats`` (a tree of BatchNorm statistics),
    ``train_fn({"params": p, "batch_stats": s}, x) -> (pred, new_stats)``
    runs each step and the fitted value is ``{"params": ..., "batch_stats":
    ...}`` (estimator ``trainBatchStats=True``).  With ``checkpoint_dir``,
    the params, the optimizer's ``state_dict`` and the statistics are saved
    every ``checkpoint_every_epochs`` epochs, and a fit resumes from the
    newest checkpoint there.  Returns (the fitted value as host arrays,
    per-epoch mean losses); a non-finite epoch mean warns, or raises under
    ``SPARKDL_DEBUG_NANS=1``."""
    _single_process("a fit")
    batch_size = min(int(batch_size), max(1, x.shape[0]))
    return _fit(
        predict_fn, params,
        lambda epoch: _epoch_batches(x, y, batch_size, epoch, shuffle, seed),
        "fit produced no batches (zero-row dataset?)",
        optimizer=optimizer, loss=loss, epochs=epochs, device=device,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every_epochs=checkpoint_every_epochs, metrics=metrics,
        train_fn=train_fn, stats=stats,
        steps_per_execution=steps_per_execution)


def fit_data_parallel_stream(predict_fn: Callable, params,
                             epoch_source: Callable[[], Iterable], *,
                             optimizer=None,
                             loss="categorical_crossentropy",
                             batch_size: int = 32,
                             epochs: int = 1,
                             steps_per_epoch: Optional[int] = None,
                             device: DeviceLike = None,
                             checkpoint_dir: Optional[str] = None,
                             checkpoint_every_epochs: int = 1,
                             metrics: Optional[Metrics] = None,
                             train_fn: Optional[Callable] = None,
                             stats=None,
                             steps_per_execution: int = 1
                             ) -> Tuple[Any, List[float]]:
    """Like :func:`fit_data_parallel` but over a re-iterable chunk source:
    ``epoch_source() -> iterator of (x_chunk, y_chunk)`` host arrays, called
    once per epoch.  Host memory stays O(chunk + batch): a dataset larger
    than host RAM streams from disk every epoch.

    The batch is ``batch_size`` whatever the stream's length: a stream
    shorter than one batch is wrapped up to it (:func:`_stream_epoch_batches`,
    JAX's semantics, not the in-memory fit's clamp).  ``steps_per_epoch``
    pins the steps of every epoch (the stream is truncated or extended);
    without it the stream's own length decides.  Empty leading chunks are
    skipped; an epoch with no rows raises ``ValueError("epoch_source
    yielded no rows")``.  A fit in a ``torch.distributed`` group of more
    than one process raises ``NotImplementedError``."""
    _single_process("a streaming fit")
    batch_size = int(batch_size)

    def epoch_chunks():
        it = iter(epoch_source())
        first = next(it, None)
        while first is not None and np.asarray(first[0]).shape[0] == 0:
            first = next(it, None)  # skip empty leading chunks
        if first is None:
            raise ValueError("epoch_source yielded no rows")

        def prefixed(f):
            # not itertools.chain: chain pins its argument tuple (and so
            # the first chunk) for the whole epoch; the peeked chunk must
            # die once it has been consumed
            yield f
            del f
            yield from it

        return prefixed(first)

    return _fit(
        predict_fn, params,
        lambda epoch: _stream_epoch_batches(epoch_chunks(), batch_size,
                                            num_steps=steps_per_epoch),
        "epoch_source yielded no rows",
        optimizer=optimizer, loss=loss, epochs=epochs, device=device,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every_epochs=checkpoint_every_epochs, metrics=metrics,
        train_fn=train_fn, stats=stats,
        steps_per_execution=steps_per_execution)
