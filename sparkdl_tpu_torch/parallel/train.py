"""Fits over the device mesh (port of ``sparkdl_tpu/parallel/train.py``).

``fit_data_parallel`` fits a tree of parameters (nested dicts of host
arrays or tensors) on host arrays (x, y) with ``torch.autograd`` and a
``torch.optim`` optimizer, on the device
:func:`~sparkdl_tpu_torch.resolve_device` gives (``cuda`` unless the CPU
was asked for).  It draws the JAX fit's batches (:func:`_epoch_batches` is
a copy of JAX's), takes the loss mean over each batch, and fetches the
step losses once per group of ``steps_per_execution`` steps.  With
``train_fn`` + ``stats`` the step also carries BatchNorm statistics (JAX's
``make_train_step_with_stats``); with ``checkpoint_dir`` the params, the
optimizer's ``state_dict`` and the statistics are saved on the epoch
cadence and a fit resumes from the newest checkpoint (``checkpoint.py``).
``fit_data_parallel_stream`` runs the same loop over a re-iterable chunk
source, holding O(chunk + batch) rows (:func:`_stream_epoch_batches` is a
copy of JAX's).

Multi-process fits follow JAX's global-batch rules.  In a
``torch.distributed`` group of W ranks (:mod:`.distributed`) the mesh's
data axis spans the ranks, ``batch_size`` is the GLOBAL batch (rounded up
to the data axis), each rank draws ``max(dp // W, batch // W)`` rows a
step from its own shard, and the steps of an epoch come from the
all-gathered global row count, a short shard wrapping modularly, so every
rank runs the same steps.  A rank with no rows raises on every rank.  Each
step all-reduces the gradients (and the loss) to the global batch's mean
before ``optimizer.step``, so every rank applies the same update; with
``train_fn`` + ``stats`` the BatchNorm statistics are the global batch's
(``models/layers.py flax_batch_norm_train`` all-reduces its sums).

The step on the card is a captured CUDA graph (the counterpart of JAX's
compiled step): the fit's first step runs eagerly on a side stream (it
makes the optimizer's lazy state, the gradients and cuDNN's plans), then
one graph per group length is captured from static input buffers:
forward, loss, backward and ``optimizer.step`` of k = ``steps_per_execution``
steps over a stacked ``[k, B, ...]`` input (JAX's ``lax.scan``), one
replay and one loss fetch a group; a ragged tail group gets its own graph.
Inside a process group the all-reduce runs on the host between two graphs
a step (forward and backward, then the update): mode ``split``.  The steps
stay eager (mode ``eager``) on the CPU, under autograd anomaly mode
(``utils.debug.enable_nan_checks``: its checks sync with the host), with
an optimizer that cannot be captured (one made with ``capturable=False``,
or a type not known to be graph-safe), with a CPU ``torch.Generator``
feeding the model, with batch statistics in a process group (their
all-reduce sits inside the forward), and in a fit whose known step count
replays its graphs too few times to pay for capturing them
(:data:`BREAK_EVEN_REPLAYS`); the reason is logged.  The fit's ``Metrics`` count the mode
(``train.step_mode.<mode>``), the captures (``train.captures``), and gauge
the graphs' pool bytes, the capture seconds and the host microseconds a
step.  A capture that fails raises.  The graphs and their pool are
released when the fit returns.
"""

from __future__ import annotations

import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch import DeviceLike, resolve_device
from sparkdl_tpu_torch.param.converters import (NamedOptimizer,
                                                required_positional)
from sparkdl_tpu_torch.parallel import distributed
from sparkdl_tpu_torch.parallel import mesh as mesh_lib
from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map
from sparkdl_tpu_torch.utils import debug
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)

_EPS = 1e-7


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


class TrainStep:
    """``step(x, y) -> loss``: one optimizer step on a batch.

    ``loss_of(x, y)`` gives the batch's mean loss (and updates BatchNorm
    statistics in place, for a step with them); the step zeroes the
    gradients, runs it and its backward, and in a process group of W
    ranks all-reduces the gradients and the loss (one flat buffer) and
    divides them by W, the global batch's mean, before
    ``optimizer.step``.  The loss comes back as a 0-d device tensor, not
    fetched.  Its pieces (:meth:`forward_backward`, :meth:`pack`,
    :meth:`reduce`, :meth:`unpack`) are what a fit captures into graphs.
    ``mesh`` and ``param_shardings`` record the layout (one card per
    process: every weight replicated); :meth:`opt_state_shardings` gives
    the optimizer state's."""

    def __init__(self, loss_of: Callable, optimizer: torch.optim.Optimizer,
                 params, *, mesh=None, param_shardings=None,
                 params_template=None):
        self.loss_of = loss_of
        self.optimizer = optimizer
        self.params = _tree_leaves(params)
        self.mesh = mesh
        self.replicated = (mesh_lib.replicated_sharding(mesh)
                           if mesh is not None else None)
        self.param_shardings = param_shardings
        self._template = params_template
        self.world = distributed.process_count()
        self._flat: Optional[torch.Tensor] = None

    def opt_state_shardings(self):
        """The sharding of each tensor of the optimizer's state now
        (:func:`resolve_opt_state_shardings`; the state is made at the
        first step), or None for a step made without ``param_specs``."""
        if self.param_shardings is None:
            return None
        return resolve_opt_state_shardings(
            self.optimizer, self._template, self.param_shardings,
            self.replicated)

    def forward_backward(self, x, y) -> torch.Tensor:
        """Zero the gradients, then the local batch's mean loss and its
        backward; returns the loss, detached."""
        self.optimizer.zero_grad(set_to_none=True)
        lval = self.loss_of(x, y)
        lval.backward()
        return lval.detach()

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def pack(self, lval: torch.Tensor) -> torch.Tensor:
        """The gradients and the loss in one flat buffer (made at the first
        call, reused after, so a graph writes a static tensor)."""
        grads = self._grads()
        n = sum(g.numel() for g in grads) + 1
        dtype = lval.dtype
        for g in grads:
            dtype = torch.promote_types(dtype, g.dtype)
        flat = self._flat
        if (flat is None or flat.numel() != n or flat.dtype != dtype
                or flat.device != lval.device):
            flat = self._flat = torch.empty(n, dtype=dtype,
                                            device=lval.device)
        torch.cat([g.reshape(-1).to(dtype) for g in grads]
                  + [lval.reshape(1).to(dtype)], out=flat)
        return flat

    def reduce(self) -> None:
        """Sum the flat buffer over the group (on the host under gloo)."""
        torch.distributed.all_reduce(self._flat)

    def unpack(self) -> torch.Tensor:
        """Divide the summed buffer by the group's size and write it back
        into the gradients; returns the global mean loss (a view of the
        buffer)."""
        flat = self._flat
        flat.div_(self.world)
        off = 0
        for g in self._grads():
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return flat[-1]

    def __call__(self, x, y) -> torch.Tensor:
        lval = self.forward_backward(x, y)
        if self.world > 1:
            self.pack(lval)
            self.reduce()
            lval = self.unpack().clone()
        self.optimizer.step()
        return lval


def _refuse_real_split(param_shardings, params) -> None:
    """The port's documented deviation: one card per process, so a policy
    that splits a weight across devices raises."""
    flat_sh = [s for _, s in mesh_lib.tree_flatten_with_path(
        param_shardings, mesh_lib._is_spec)]
    for (path, leaf), sh in zip(mesh_lib.tree_flatten_with_path(params),
                                flat_sh):
        spec = sh.spec
        if (mesh_lib._axis_shards(sh.mesh, spec) > 1
                and mesh_lib.spec_shards_leaf(sh.mesh, spec,
                                              tuple(leaf.shape))):
            raise NotImplementedError(
                f"param_specs split {mesh_lib.param_path_str(path)!r} "
                f"({spec!r}) across devices; the port runs one card per "
                f"process and holds every weight whole (ROADMAP.md §C, "
                f"documented deviations)")


def resolve_param_specs(param_specs, params, mesh):
    """``param_specs`` -> a tree of ``NamedSharding`` matching ``params``:
    a tree of ``PartitionSpec`` (the structure of ``params``) or a
    callable ``(path_str, leaf) -> PartitionSpec`` applied per leaf
    (:func:`~.mesh.param_path_str` spelling)."""
    if callable(param_specs):
        flat = mesh_lib.tree_flatten_with_path(params)
        return mesh_lib.tree_unflatten_like(
            params, [mesh_lib.NamedSharding(
                mesh, param_specs(mesh_lib.param_path_str(p), l))
                for p, l in flat])
    flat = mesh_lib.tree_flatten_with_path(param_specs, mesh_lib._is_spec)
    return mesh_lib.tree_unflatten_like(
        param_specs, [mesh_lib.NamedSharding(mesh, s) for _, s in flat])


def resolve_opt_state_shardings(optimizer: torch.optim.Optimizer,
                                params_template, param_shardings,
                                replicated):
    """A sharding for each tensor of ``optimizer``'s state, in its
    ``state_dict()["state"]`` layout (param index -> state key ->
    sharding): a state tensor of its param's shape (Adam's moments, a
    momentum buffer) inherits the param's sharding, anything else (step
    counts, scalars) is replicated.  The optimizer's state is made at its
    first step: before it the result is empty."""
    flat_sh = [s for _, s in mesh_lib.tree_flatten_with_path(
        param_shardings, mesh_lib._is_spec)]
    shapes = [tuple(l.shape) for _, l in
              mesh_lib.tree_flatten_with_path(params_template)]
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out: Dict[int, Dict[str, Any]] = {}
    for i, p in enumerate(params):
        st = optimizer.state.get(p)
        if not st:
            continue
        out[i] = {}
        for key, value in st.items():
            same = (isinstance(value, torch.Tensor) and i < len(shapes)
                    and tuple(value.shape) == shapes[i])
            out[i][key] = flat_sh[i] if same else replicated
    return out


def make_train_step(predict_fn: Callable, loss,
                    optimizer: torch.optim.Optimizer, params, *,
                    mesh=None, param_specs=None,
                    params_template=None) -> TrainStep:
    """A :class:`TrainStep` on the batch mean of ``loss(predict_fn(params,
    x), y)``, ``optimizer`` built over the tensors of ``params``.

    ``mesh`` (default :func:`~.mesh.get_mesh` in a process group, else
    the params' device) is recorded with its layouts.  ``param_specs``
    (with ``params_template``, default ``params``): a tree of
    ``PartitionSpec`` or a ``(path, leaf) -> PartitionSpec`` rule, resolved
    as JAX's; a spec that really splits a weight across devices raises
    ``NotImplementedError`` (one card per process), one that replicates on
    this mesh is taken."""
    loss_fn = resolve_loss(loss)

    def loss_of(x, y):
        return torch.mean(loss_fn(predict_fn(params, x), y))

    return _step(loss_of, optimizer, params, mesh, param_specs,
                 params_template)


def make_train_step_with_stats(train_fn: Callable, loss,
                               optimizer: torch.optim.Optimizer, params,
                               stats: Dict[str, Any], *, mesh=None,
                               param_specs=None,
                               params_template=None) -> TrainStep:
    """Like :func:`make_train_step` for models whose ``train_fn({"params":
    ..., "batch_stats": ...}, x) -> (pred, new_stats)`` updates BatchNorm
    statistics: ``stats["batch_stats"]`` holds the current statistics and
    each step writes the new ones INTO those tensors (in place, so a
    captured step updates static tensors); in a process group they are the
    global batch's."""
    loss_fn = resolve_loss(loss)

    def loss_of(x, y):
        current = stats["batch_stats"]
        pred, new_stats = train_fn(
            {"params": params, "batch_stats": current}, x)
        with torch.no_grad():
            for old, new in zip(_tree_leaves(current),
                                _tree_leaves(new_stats)):
                if new.data_ptr() != old.data_ptr():
                    old.copy_(new)
        return torch.mean(loss_fn(pred, y))

    return _step(loss_of, optimizer, params, mesh, param_specs,
                 params_template)


def _step(loss_of, optimizer, params, mesh, param_specs,
          params_template) -> TrainStep:
    if mesh is None:
        # the step runs where its tensors are: the ranks' devices in a
        # group, else the params' one device
        leaves = _tree_leaves(params)
        mesh = (mesh_lib.get_mesh() if distributed.process_count() > 1
                or not leaves else mesh_lib.get_mesh(
                    devices=[leaves[0].device]))
    param_shardings = template = None
    if param_specs is not None:
        template = params_template if params_template is not None else params
        param_shardings = resolve_param_specs(param_specs, template, mesh)
        _refuse_real_split(param_shardings, template)
    return TrainStep(loss_of, optimizer, params, mesh=mesh,
                     param_shardings=param_shardings,
                     params_template=template)


# one optimizer factory per zero-argument factory, pinned with it so that
# its id is not reused (the JAX package's _OPT_INSTANCES)
_OPT_INSTANCES: Dict[int, Tuple[Callable, Callable]] = {}
_DEFAULT_OPTIMIZER = NamedOptimizer("adam")


def clear_train_step_cache() -> None:
    """Drop the kept optimizer instances (JAX's clears its compiled steps
    too; the port keeps a fit's graphs for the fit only)."""
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


def optimizer_capturable(optimizer: torch.optim.Optimizer
                         ) -> Tuple[bool, str]:
    """(True, "") when ``optimizer``'s step can be captured in a CUDA
    graph: one made with ``capturable=True``, an optimizer class that says
    ``capturable = True`` (the port's own, whose counters live on the
    device), or ``torch.optim.SGD`` (no host-side state).  Else (False,
    why)."""
    cap = optimizer.defaults.get("capturable")
    if cap is None:
        cap = getattr(type(optimizer), "capturable", None)
    name = type(optimizer).__name__
    if cap is True or type(optimizer) is torch.optim.SGD:
        return True, ""
    if cap is False:
        return False, f"{name} was built with capturable=False"
    return False, f"{name} is not known to be capturable"


# A captured step pays for its capture after this many replays.  Capturing
# traces the step's Python once more and instantiates its graph (0.12-0.40
# s a step on config 5's InceptionV3 at batch 16), and each replay saves
# the part of the eager step's host time the card does not hide (19-92 ms
# there): SGD and Adam, f32 and TF32, break even after 3.0-13.3 replays
# (H100, chip_smoke.py [train], PERF.md).
BREAK_EVEN_REPLAYS = 10


def capture_plan(steps_per_epoch: int, epochs: int, spe: int
                 ) -> Tuple[int, int]:
    """(steps replayed, steps captured) of a fit of ``epochs`` epochs of
    ``steps_per_epoch`` steps in groups of ``spe``: its first step is the
    eager warm-up, each epoch's steps then run in groups of ``spe`` and a
    ragged tail, and each distinct group length is captured once."""
    lengths = set()
    for n in ([steps_per_epoch - 1]
              + ([steps_per_epoch] if epochs > 1 else [])):
        if n >= spe:
            lengths.add(spe)
        if n > 0 and n % spe:
            lengths.add(n % spe)
    return max(0, steps_per_epoch * epochs - 1), sum(lengths)


def step_mode(device: torch.device, optimizer: torch.optim.Optimizer,
              with_stats: bool, generators: Sequence = (),
              fit_steps: Optional[Tuple[int, int]] = None, spe: int = 1
              ) -> Tuple[str, str]:
    """(mode, reason) of a fit's steps: ``captured`` (one graph per group
    length), ``split`` (a process group: two graphs a step around the
    host all-reduce) or ``eager`` (with the reason).  ``fit_steps``: the
    fit's (steps an epoch, epochs to run) when known before its first
    step, else None (a stream of unknown length: captured); a fit whose
    graphs would be replayed fewer than :data:`BREAK_EVEN_REPLAYS` times a
    captured step runs eagerly."""
    if device.type != "cuda":
        return "eager", "the CPU runs its steps eagerly"
    if torch.is_anomaly_enabled():
        return "eager", ("autograd anomaly mode (utils.debug."
                         "enable_nan_checks) checks each backward op's "
                         "output on the host")
    ok, why = optimizer_capturable(optimizer)
    if not ok:
        return "eager", why
    if any(g.device.type != "cuda" for g in generators):
        return "eager", ("a CPU torch.Generator feeds the model (its draws "
                         "are made on the host every step)")
    mode = "captured"
    if distributed.process_count() > 1:
        if with_stats:
            return "eager", ("batch statistics in a process group: their "
                             "all-reduce runs inside the forward")
        mode = "split"  # one step a pair of graphs, whatever spe
    if fit_steps is not None:
        replayed, traced = capture_plan(
            *fit_steps, max(1, int(spe)) if mode == "captured" else 1)
        if replayed < BREAK_EVEN_REPLAYS * max(1, traced):
            return "eager", (
                f"a fit of {replayed + 1} steps would replay its "
                f"{traced} captured step(s) {replayed} times, fewer than "
                f"{BREAK_EVEN_REPLAYS} each: the capture would cost more "
                f"than it saves")
    return mode, ""


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# one side stream per device for the fits' warm-up steps and captures:
# cuBLAS keeps a workspace per stream for the life of the process, so a new
# stream per fit would leave one behind per fit
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_SIDE_LOCK = named_lock("train.side_streams")


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    with _SIDE_LOCK:
        s = _SIDE_STREAMS.get(device)
        if s is None:
            s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
            # make the stream's cuBLAS workspaces now, in small segments of
            # their own: made inside a fit's first step they would sit in
            # one of its large segments and keep it reserved after the fit
            with torch.cuda.stream(s):
                a = torch.ones(8, 8, device=device)
                torch.addmm(a, a, a)
                torch.mm(a, a)
            s.synchronize()
        return s


class _StepGraphs:
    """A fit's captured steps, all in one graph pool: for mode
    ``captured`` one graph per group length k over a static ``[k, B,
    ...]`` input that runs k whole steps and writes their k losses; for
    mode ``split`` two graphs of one step (forward and backward into the
    flat buffer, then the update from it) with the group's all-reduce
    between them on the host.  :meth:`release` drops them and their
    pool."""

    def __init__(self, step: TrainStep, mode: str, device: torch.device,
                 generators: Sequence = ()):
        self.step = step
        self.mode = mode
        self.device = device
        self.generators = list(generators)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[int, tuple] = {}
        self.pool_bytes = 0
        self.captures = 0
        self.capture_s = 0.0
        self.setup_s = 0.0  # wall time of run() spent capturing

    def warm_up(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One real step, eagerly, on a side stream: it makes the
        optimizer's lazy state, the gradients, the flat buffer and cuDNN's
        plans outside any graph."""
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            lval = self.step(x, y)
        cur.wait_stream(side)
        return lval

    def _capture(self, body: Callable) -> Tuple[Any, Any]:
        from sparkdl_tpu_torch.parallel.engine import _CAPTURE_LOCK

        with _CAPTURE_LOCK:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_stats(self.device).get(
                "reserved_bytes.all.current", 0)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                graph.register_generator_state(gen)
            try:
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=_side_stream(self.device),
                                      capture_error_mode="thread_local"):
                    out = body()
            except Exception as e:
                raise RuntimeError(
                    f"CUDA-graph capture of the training step failed: "
                    f"{e}") from e
            torch.cuda.synchronize(self.device)
            self.capture_s += time.perf_counter() - t0
            self.pool_bytes += max(0, torch.cuda.memory_stats(
                self.device).get("reserved_bytes.all.current", 0) - reserved)
            self.captures += 1
        return graph, out

    def _entry(self, k: int, x_shape, x_dtype, y_shape, y_dtype) -> tuple:
        """(static x, static y, graphs, loss output) for a group of k:
        the k-step graph in mode ``captured``, the one pair of one-step
        graphs (whatever k) in mode ``split``."""
        key = k if self.mode == "captured" else 1
        entry = self.graphs.get(key)
        if entry is not None:
            return entry
        step = self.step
        if self.mode == "captured":
            xs = torch.zeros((k,) + x_shape, dtype=x_dtype,
                             device=self.device)
            ys = torch.zeros((k,) + y_shape, dtype=y_dtype,
                             device=self.device)
            graph, losses = self._capture(lambda: torch.stack(
                [step(xs[i], ys[i]) for i in range(k)]))
            entry = (xs, ys, (graph,), losses)
        else:
            xs = torch.zeros(x_shape, dtype=x_dtype, device=self.device)
            ys = torch.zeros(y_shape, dtype=y_dtype, device=self.device)
            grad_graph, _ = self._capture(
                lambda: step.pack(step.forward_backward(xs, ys)))

            def update():
                lval = step.unpack()
                step.optimizer.step()
                return lval

            update_graph, lval = self._capture(update)
            entry = (xs, ys, (grad_graph, update_graph), lval)
        self.graphs[key] = entry
        return entry

    def run(self, bx: np.ndarray, by: np.ndarray) -> torch.Tensor:
        """Replay the steps of a group of k stacked host batches ``[k, B,
        ...]``; returns the k losses on the device."""
        k = bx.shape[0]
        t0 = time.perf_counter()
        xs, ys, graphs, out = self._entry(
            k, tuple(bx.shape[1:]), _torch_dtype(bx.dtype),
            tuple(by.shape[1:]), _torch_dtype(by.dtype))
        self.setup_s += time.perf_counter() - t0
        if self.mode == "captured":
            xs.copy_(torch.from_numpy(np.ascontiguousarray(bx)))
            ys.copy_(torch.from_numpy(np.ascontiguousarray(by)))
            graphs[0].replay()
            return out
        gx, gy = _upload(bx, self.device), _upload(by, self.device)
        losses = torch.empty(k, dtype=out.dtype, device=self.device)
        for i in range(k):
            xs.copy_(gx[i])
            ys.copy_(gy[i])
            graphs[0].replay()
            self.step.reduce()
            graphs[1].replay()
            losses[i].copy_(out)
        return losses

    def release(self) -> None:
        """Drop the graphs and give their pool back to the card."""
        if not self.graphs:
            return
        torch.cuda.synchronize(self.device)
        self.graphs.clear()
        for p in self.step.params:
            p.grad = None  # the last gradients live in the pool
        self.step._flat = None
        self.pool = None
        torch.cuda.empty_cache()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class _StepRunner:
    """Drives one epoch's batches through the fit's step in groups of
    ``spe``, eagerly or through :class:`_StepGraphs`, and fetches each
    group's losses in one device-to-host copy.  Returns the per-step loss
    series, the same for every mode and ``spe``.  ``host_s`` / ``timed``:
    the host seconds spent enqueueing the steps after the fit's first
    (its warm-up) and outside captures, and how many steps they cover."""

    def __init__(self, step: TrainStep, spe: int, device: torch.device,
                 mode: str, generators: Sequence = ()):
        self.step = step
        self.spe = spe
        self.device = device
        self.mode = mode
        self.graphs = (_StepGraphs(step, mode, device, generators)
                       if mode != "eager" else None)
        self.steps = 0
        self.fetches = 0
        self.host_s = 0.0
        self.timed = 0

    def _fetch(self, losses: torch.Tensor) -> List[float]:
        self.fetches += 1
        return losses.reshape(-1).cpu().tolist()

    def _eager(self, group) -> torch.Tensor:
        out = []
        for bx, by in group:
            t0 = time.perf_counter()
            out.append(self.step(_upload(bx, self.device),
                                 _upload(by, self.device)))
            if self.steps:
                self.host_s += time.perf_counter() - t0
                self.timed += 1
            self.steps += 1
        return torch.stack(out)

    def _replay(self, group) -> torch.Tensor:
        if not self.steps:  # the warm-up: one real step, eagerly
            (bx, by), = group
            out = self.graphs.warm_up(_upload(bx, self.device),
                                      _upload(by, self.device))
            self.steps += 1
            return out.reshape(1)
        setup = self.graphs.setup_s
        t0 = time.perf_counter()
        out = self.graphs.run(np.stack([g[0] for g in group]),
                              np.stack([g[1] for g in group]))
        self.host_s += (time.perf_counter() - t0
                        - (self.graphs.setup_s - setup))
        self.timed += len(group)
        self.steps += len(group)
        return out

    def run_epoch(self, batches: Iterable) -> List[float]:
        losses: List[float] = []
        group: List[Tuple[np.ndarray, np.ndarray]] = []
        run = self._eager if self.graphs is None else self._replay

        def own(a):
            # a view into a chunk would pin the chunk while it waits
            return a.copy() if (self.spe > 1 and a.base is not None) else a

        for bx, by in batches:
            group.append((own(bx), own(by)))
            if len(group) == self.spe or (self.graphs is not None
                                          and not self.steps):
                losses.extend(self._fetch(run(group)))
                group.clear()
        if group:
            losses.extend(self._fetch(run(group)))
        return losses

    def report(self, metrics: Metrics) -> None:
        metrics.incr(f"train.step_mode.{self.mode}")
        metrics.incr("train.steps", self.steps)
        metrics.incr("train.loss_fetches", self.fetches)
        if self.timed:
            metrics.gauge("train.host_us_per_step",
                          self.host_s / self.timed * 1e6)
        if self.graphs is not None:
            metrics.incr("train.captures", self.graphs.captures)
            metrics.gauge("train.graph_pool_bytes", self.graphs.pool_bytes)
            metrics.gauge("train.capture_s", self.graphs.capture_s)

    def release(self) -> None:
        if self.graphs is not None:
            self.graphs.release()


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


def _fit_mesh(mesh, batch_size: int, device: DeviceLike
              ) -> Tuple[Any, int, int]:
    """(mesh, data-axis size, global batch rounded up to it).  The port
    runs one card per process: the data axis is the group's ranks (the
    default mesh), or this fit's one device."""
    if mesh is None:
        mesh = (mesh_lib.get_mesh() if distributed.process_count() > 1
                else mesh_lib.get_mesh(devices=[resolve_device(device)]))
    dp = int(mesh.shape[mesh_lib.DATA_AXIS])
    if int(mesh.shape[mesh_lib.MODEL_AXIS]) > 1 \
            or mesh.size > distributed.process_count():
        raise NotImplementedError(
            f"a fit on mesh {mesh.shape} needs more than one device per "
            f"process; the port runs one card per process (a data axis of "
            f"the group's ranks, model axis 1; ROADMAP.md §C)")
    if batch_size % dp:
        batch_size += dp - batch_size % dp
        logger.info("global batch rounded up to %d (multiple of %d-way "
                    "data axis)", batch_size, dp)
    return mesh, dp, batch_size


def _fit(predict_fn: Callable, params, epoch_batches: Callable[[int], Iterable],
         no_rows: str, epoch_steps: Optional[int], *, optimizer, loss,
         epochs: int, device: DeviceLike, mesh,
         checkpoint_dir: Optional[str], checkpoint_every_epochs: int,
         metrics: Optional[Metrics], train_fn: Optional[Callable], stats,
         steps_per_execution: int, generators: Sequence = ()
         ) -> Tuple[Any, List[float]]:
    """The loop both fits share: ``epoch_batches(epoch)`` gives this
    rank's (x, y) host batches of the epoch, ``epoch_steps`` of them when
    known up front (None: a stream's own length); ``no_rows`` is the
    ``ValueError`` an epoch without a batch raises.  See
    :func:`fit_data_parallel` for the rest."""
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
                if with_stats:
                    for t, v in zip(_tree_leaves(stats_ref["batch_stats"]),
                                    _tree_leaves(state["batch_stats"])):
                        t.copy_(v)
            opt.load_state_dict(state["opt_state"])

    def ckpt_state():  # save_pytree copies the tensors to the host
        state = {"params": tensors, "opt_state": opt.state_dict()}
        if with_stats:
            state["batch_stats"] = stats_ref["batch_stats"]
        return state

    if with_stats:
        step = make_train_step_with_stats(train_fn, loss, opt, tensors,
                                          stats_ref, mesh=mesh)
    else:
        step = make_train_step(predict_fn, loss, opt, tensors, mesh=mesh)
    metrics = metrics if metrics is not None else Metrics()
    spe = max(1, int(steps_per_execution))
    fit_steps = (None if epoch_steps is None
                 else (epoch_steps, epochs - start_epoch))
    mode, why = step_mode(dev, opt, with_stats, generators, fit_steps, spe)
    if why and dev.type == "cuda":
        logger.info("training steps run eagerly: %s", why)
    runner = _StepRunner(step, spe, dev, mode, generators)
    epoch_losses: List[float] = []
    try:
        for epoch in range(start_epoch, epochs):
            step_losses = runner.run_epoch(epoch_batches(epoch))
            if not step_losses:
                raise ValueError(no_rows)
            mean = float(np.mean(step_losses))
            if not np.isfinite(mean):
                debug.warn_or_raise_nonfinite_loss(step_losses, epoch)
            epoch_losses.append(mean)
            metrics.record_time("epoch_loss", mean)
            if (ckptr is not None and ckptr.due(epoch + 1)
                    and ckptr.is_writer()):
                # copied to the host only on epochs the cadence saves
                ckptr.maybe_save(epoch + 1, ckpt_state())
        runner.report(metrics)
        if with_stats:
            return ({"params": _host(tensors),
                     "batch_stats": _host(stats_ref["batch_stats"])},
                    epoch_losses)
        return _host(tensors), epoch_losses
    finally:
        runner.release()


def fit_data_parallel(predict_fn: Callable, params, x: np.ndarray,
                      y: np.ndarray, *,
                      optimizer=None,
                      loss="categorical_crossentropy",
                      batch_size: int = 32,
                      epochs: int = 1,
                      shuffle: bool = True,
                      seed: int = 0,
                      mesh=None,
                      device: DeviceLike = None,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_every_epochs: int = 1,
                      metrics: Optional[Metrics] = None,
                      train_fn: Optional[Callable] = None,
                      stats=None,
                      steps_per_execution: int = 1,
                      generators: Sequence = ()) -> Tuple[Any, List[float]]:
    """Fit ``params`` (nested dicts of host arrays or tensors; tensors are
    copied, never trained in place) on (x, y) with data-parallel steps over
    ``mesh`` (default :func:`~.mesh.get_mesh`: this device, or one per
    rank of a process group).

    ``predict_fn(params, x) -> pred`` on tensors; ``loss(pred, y) -> [B]``
    (a name from :data:`LOSSES` or a callable); ``optimizer``: a factory
    ``params -> torch.optim.Optimizer``, a zero-argument factory returning
    one, or None (Adam at lr 1e-3, as JAX's default).  ``batch_size`` is
    the global batch, rounded up to the data axis; in one process it is
    clamped to the rows.  In a process group, (x, y) are THIS rank's
    shard (:func:`.distributed.shard_files`) and the module docstring's
    global-batch rules apply.  ``steps_per_execution`` steps run per
    replay and loss fetch, with the same loss series as 1.

    With ``train_fn`` + ``stats`` (a tree of BatchNorm statistics),
    ``train_fn({"params": p, "batch_stats": s}, x) -> (pred, new_stats)``
    runs each step and the fitted value is ``{"params": ..., "batch_stats":
    ...}`` (estimator ``trainBatchStats=True``).  With ``checkpoint_dir``,
    the params, the optimizer's ``state_dict`` and the statistics are saved
    every ``checkpoint_every_epochs`` epochs by rank 0, and a fit resumes
    from the newest checkpoint there.  ``generators``: the explicit
    ``torch.Generator``s the model draws from (registered with the captured
    graphs).  Returns (the fitted value as host arrays, per-epoch mean
    losses); a non-finite epoch mean warns, or raises under
    ``SPARKDL_DEBUG_NANS=1``."""
    mesh, dp, batch_size = _fit_mesh(mesh, int(batch_size), device)
    pc = distributed.process_count()
    steps_per_epoch = None
    if pc > 1:
        local_batch = max(dp // pc, batch_size // pc)
        counts = distributed.allgather_ints(x.shape[0])
        if int(np.min(counts)) == 0:
            # every rank sees the same counts: all raise, none waits
            raise ValueError(
                f"multi-process fit requires >=1 row on every rank; "
                f"per-rank row counts: {counts.tolist()} (fewer files than "
                f"processes? see distributed.shard_files)")
        global_rows = int(np.sum(counts))
        steps_per_epoch = max(1, -(-global_rows // (local_batch * pc)))
        batch_size = local_batch
    else:
        batch_size = min(batch_size, max(dp, (x.shape[0] // dp) * dp))
    return _fit(
        predict_fn, params,
        lambda epoch: _epoch_batches(x, y, batch_size, epoch, shuffle, seed,
                                     num_steps=steps_per_epoch),
        "fit produced no batches (zero-row dataset?)",
        steps_per_epoch if steps_per_epoch is not None
        else -(-x.shape[0] // batch_size),
        optimizer=optimizer, loss=loss, epochs=epochs, device=device,
        mesh=mesh, checkpoint_dir=checkpoint_dir,
        checkpoint_every_epochs=checkpoint_every_epochs, metrics=metrics,
        train_fn=train_fn, stats=stats,
        steps_per_execution=steps_per_execution, generators=generators)


def fit_data_parallel_stream(predict_fn: Callable, params,
                             epoch_source: Callable[[], Iterable], *,
                             optimizer=None,
                             loss="categorical_crossentropy",
                             batch_size: int = 32,
                             epochs: int = 1,
                             steps_per_epoch: Optional[int] = None,
                             mesh=None,
                             device: DeviceLike = None,
                             checkpoint_dir: Optional[str] = None,
                             checkpoint_every_epochs: int = 1,
                             metrics: Optional[Metrics] = None,
                             train_fn: Optional[Callable] = None,
                             stats=None,
                             steps_per_execution: int = 1,
                             generators: Sequence = ()
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
    yielded no rows")``.  In a process group ``steps_per_epoch`` is
    required (ranks cannot count an unseen stream in agreement), each rank
    draws ``max(dp // W, batch // W)`` rows a step from its own source,
    and every epoch first checks that every rank has rows (a rank without
    raises on every rank)."""
    mesh, dp, batch_size = _fit_mesh(mesh, int(batch_size), device)
    pc = distributed.process_count()
    if pc > 1:
        if steps_per_epoch is None:
            raise ValueError(
                "multi-process streaming fit requires steps_per_epoch "
                "(ranks cannot count an unseen stream in agreement); "
                "derive it from the global row count / global batch")
        batch_size = max(dp // pc, batch_size // pc)

    def epoch_chunks():
        it = iter(epoch_source())
        first = next(it, None)
        while first is not None and np.asarray(first[0]).shape[0] == 0:
            first = next(it, None)  # skip empty leading chunks
        if pc > 1:
            n_first = (0 if first is None
                       else int(np.asarray(first[0]).shape[0]))
            counts = distributed.allgather_ints(n_first)
            if int(np.min(counts)) == 0:
                raise ValueError(
                    f"multi-process streaming fit requires >=1 row on "
                    f"every rank at the start of each epoch; first-chunk "
                    f"rows per rank: {counts.tolist()}")
        elif first is None:
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
        "epoch_source yielded no rows", steps_per_epoch,
        optimizer=optimizer, loss=loss, epochs=epochs, device=device,
        mesh=mesh, checkpoint_dir=checkpoint_dir,
        checkpoint_every_epochs=checkpoint_every_epochs, metrics=metrics,
        train_fn=train_fn, stats=stats,
        steps_per_execution=steps_per_execution, generators=generators)
