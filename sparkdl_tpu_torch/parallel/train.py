"""Fits over the device mesh (port of ``sparkdl_tpu/parallel/train.py``).

``fit_data_parallel`` fits a tree of parameters (nested dicts of host
arrays or tensors) on host arrays (x, y) with ``torch.autograd`` and a
``torch.optim`` optimizer, on the mesh :func:`resolve_fit_mesh` gives
(the cards unless the CPU was asked for).  It draws the JAX fit's batches (:func:`_epoch_batches` is
a copy of JAX's), takes the loss mean over each batch, and fetches the
step losses once per group of ``steps_per_execution`` steps.  With
``train_fn`` + ``stats`` the step also carries BatchNorm statistics (JAX's
``make_train_step_with_stats``); with ``checkpoint_dir`` the params, the
optimizer's ``state_dict`` and the statistics are saved on the epoch
cadence and a fit resumes from the newest checkpoint (``checkpoint.py``).
``fit_data_parallel_stream`` runs the same loop over a re-iterable chunk
source, holding O(chunk + batch) rows (:func:`_stream_epoch_batches` is a
copy of JAX's).

Fits on a mesh of several slots in one process (every visible card by
default, as ``jax.devices()`` is; ``mesh.get_mesh(devices=["cuda:0"] *
k)`` for k slots of one card, ``["cpu"] * 8`` for JAX's 8 virtual
devices) split each global batch over the mesh's data groups in
contiguous rows, as JAX's batch sharding splits axis 0: each group runs
the forward and backward of its rows, the groups' gradients are averaged
over the global batch, and one optimizer step updates the weights (see
:class:`TrainStep`).  ``make_train_step(param_specs=...)`` splits chosen
weights over the ``model`` axis into trainable shards
(:class:`~.shard.ShardedTensor`), each with its own gradient and
optimizer state; checkpoints save each split weight whole.

Multi-process fits follow JAX's global-batch rules.  In a
``torch.distributed`` group of W ranks (:mod:`.distributed`) the mesh's
data axis spans the ranks and, where a rank holds several slots
(``distributed.initialize(local_slots=...)``), its own data groups; a
fit's model axis lies within a rank (:func:`resolve_fit_mesh` refuses a
row across ranks: see there).  ``batch_size`` is the GLOBAL batch
(rounded up to the data axis, dp = every rank's groups), each rank draws
``max(dp // W, batch // W)`` rows a step from its own shard and splits
them over its own groups, and the steps of an epoch come from the
all-gathered global row count, a short shard wrapping modularly, so
every rank runs the same steps.  A rank with no rows raises on every
rank.  Each step sums its groups' gradients into its leaves and shards,
then all-reduces them (and the loss, at its own type) over the ranks,
the same leaves and shards in the same order on every rank, to the
global batch's mean before ``optimizer.step``, so every rank applies the
same update; with ``train_fn`` + ``stats`` the BatchNorm statistics are
the global batch's (``models/layers.py flax_batch_norm_train`` sums them
across the rank's groups, then all-reduces them across the ranks).

The step on the card is a captured CUDA graph (the counterpart of JAX's
compiled step): the fit's first step runs eagerly on a side stream (it
makes the optimizer's lazy state, the gradients and cuDNN's plans), then
one graph per group length is captured from static input buffers:
forward, loss, backward and ``optimizer.step`` of k = ``steps_per_execution``
steps over a stacked ``[k, B, ...]`` input (JAX's ``lax.scan``), one
replay and one loss fetch a group; a ragged tail group gets its own graph.
Inside a process group the all-reduce runs on the host between two graphs
a step (forward and backward of every group of the rank, then the
update): mode ``split``.  On a mesh
whose slots all name one card the groups run one after another inside the
captured step.  The steps stay eager (mode ``eager``) on the CPU, on a
mesh across several cards, with batch statistics over several data groups
(their sums meet between the groups' threads), in a fit that starts while
another fit runs on its card (fitMultiple's slices), under autograd anomaly mode
(``utils.debug.enable_nan_checks``: its checks sync with the host), with
an optimizer that cannot be captured (one made with ``capturable=False``,
or a type not known to be graph-safe), with a CPU ``torch.Generator``
feeding the model, with batch statistics in a process group (their
all-reduce sits inside the forward), and in a fit whose known step count
replays its graphs too few times to pay for capturing them
(:data:`BREAK_EVEN_REPLAYS`); the reason is logged.  The fit's ``Metrics`` count the mode
(``train.step_mode.<mode>``), the captures (``train.captures``), and gauge
the graphs' pool bytes, the capture seconds, the host microseconds a
step and the data groups (``train.data_groups``).  A capture that fails raises.  The graphs and their pool are
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
    """``step(x, y) -> loss``: one optimizer step on a (global) batch.

    ``loss_of(params, stats, x, y)`` gives the mean loss of a batch's rows
    under the param tree ``params`` (and updates the BatchNorm statistics
    tree ``stats`` in place, for a step with them; None otherwise).  The
    step zeroes the gradients, runs the loss and its backward and then
    ``optimizer.step``; the loss comes back as a 0-d device tensor, not
    fetched.  ``mesh`` and ``param_shardings`` record the layout;
    :meth:`opt_state_shardings` gives the optimizer state's.

    On one slot (the params' device, or this rank's one device in a
    ``torch.distributed`` group of W ranks) the step trains the tensors of
    ``params`` themselves; in a group it all-reduces the gradients and the
    loss (one flat buffer, the loss beside it where its type differs) over
    the column group (every rank, where each data row lies within one
    rank) and divides them by its size, the global batch's mean, before
    ``optimizer.step``.  Its pieces (:meth:`forward_backward`,
    :meth:`pack`, :meth:`reduce`, :meth:`unpack`) are what a fit captures
    into graphs.

    Where this process holds several slots of the mesh (a mesh of its own
    slots, or its rows of a group's mesh, :func:`~.mesh.local_rows`) the
    step places the params first (:meth:`_place`): a leaf that
    ``param_shardings`` splits on the ``model`` axis becomes a
    :class:`~.shard.ShardedTensor` whose shards, one per model slot of
    its first data group, are new leaves that require grad; a replicated
    leaf is a leaf on the first slot's device (the given tensor itself
    when it is there already).  ``optimizer``'s
    param groups then hold those leaves, each shard in the place of its
    whole leaf, so each shard has its own gradient and its own state; the
    optimizer must be one whose update is elementwise (a split would take
    Lamb's trust ratio per shard).  A batch is split over the data axis in
    contiguous rows, as JAX splits axis 0: data group g runs the loss of
    rows ``[g*b/dp, (g+1)*b/dp)`` on its slots, through copies of the
    leaves on its devices (the leaves themselves where its slots are the
    first group's), and the step's loss is the mean of the groups' means,
    whose backward sums every group's gradient into the one set of leaves:
    the global batch's mean gradient, up to the order of the sum.  With
    statistics, each data group updates its own copy of them (refreshed
    from the first group's before each step) and the groups run in
    threads of their own that meet in every train-mode BatchNorm
    (``models.layers.GroupSums``), so μ and σ² are the global batch's.
    Each group's loss runs under ``models.layers.data_group(g)``, which
    a caller's ``fn`` may read to pick its own per-group state.  In a
    group the rank's groups run first (their gradients summed into its
    leaves and shards, the loss the mean of their means), then the flat
    all-reduce over the ranks; with statistics the groups' sums meet in
    the rank first, then one thread of the rank all-reduces them across
    the ranks, once a BatchNorm.

    **A model axis across ranks.**  Where a data row of ``mesh`` holds
    slots of several ranks (:func:`~.mesh.local_rows`), each rank places
    only its own shards of every split leaf (a :class:`~.shard.
    ShardedTensor` with a :class:`~.shard.RowSplit`: bounds and owners of
    every shard) on its slots, and nothing of the others'.  The ranks of
    a row pass the SAME rows (JAX's replica contract) and run the same
    forward: each split op computes this rank's slice, gathered over the
    *row group* where a whole value is needed, the gradient of its input
    summed over the row group backward (``parallel/shard.py``), so the
    replicated leaves' gradients agree within a row and each shard gets
    its own.  The gradients (and the loss) then meet over the *column
    group*, one rank a row (``distributed.mesh_groups``), and are divided
    by its size: each rank's part is already the mean over its own rows,
    so this is the mean over the mesh's data rows.  A column group of one
    rank (one data row) runs no all-reduce.  BatchNorm sums meet over the
    column group too (``models/layers.py``)."""

    def __init__(self, loss_of: Callable, optimizer: torch.optim.Optimizer,
                 params, *, mesh=None, param_shardings=None,
                 params_template=None, stats=None):
        self.loss_of = loss_of
        self.optimizer = optimizer
        self.mesh = mesh
        self.replicated = (mesh_lib.replicated_sharding(mesh)
                           if mesh is not None else None)
        self.param_shardings = param_shardings
        self._template = params_template
        self.world = distributed.process_count()
        self._flat: Optional[torch.Tensor] = None
        self._loss: Optional[torch.Tensor] = None
        self.tree = params
        self.stats = stats
        self._rows: Optional[List[tuple]] = None
        self._stats: List[Any] = [stats]
        self._pool = None
        local = mesh_lib.local_rows(mesh) if mesh is not None else None
        self.local = local
        me = distributed.process_index()
        self.row = self.columns = distributed.RankGroup([me])
        if self.world > 1 and local is None:
            self.columns = distributed.RankGroup(range(self.world))
        elif self.world > 1:
            rows, cols = distributed.mesh_groups(mesh.ranks)
            self.row = rows[local.rows[0]]
            self.columns = next(c for c in cols if me in c.ranks)
        if local is not None and (local.size > 1 or local.spans_ranks):
            self._place(local)
        self.params = [p for t in _tree_leaves(self.tree) for p in _pieces(t)]

    # -- placement on this process's slots of the mesh ---------------------
    def _place(self, local) -> None:
        from sparkdl_tpu_torch.parallel.shard import RowSplit, ShardedTensor

        mesh = self.mesh
        dp = int(local.shape[mesh_lib.DATA_AXIS])
        rows = [tuple(torch.device(d) for d in local.devices[g])
                for g in range(dp)]
        first = rows[0][0]
        owners = [int(r) for r in np.asarray(mesh.ranks)[local.rows[0]]]
        flat = mesh_lib.tree_flatten_with_path(self.tree)
        specs = ([None] * len(flat) if self.param_shardings is None else
                 [sh.spec for _, sh in mesh_lib.tree_flatten_with_path(
                     self.param_shardings, mesh_lib._is_spec)])
        leaves, swap, split = [], {}, False
        for (_, leaf), spec in zip(flat, specs):
            dim = (None if spec is None
                   else mesh_lib.model_split_dim(mesh, spec))
            if dim is None:
                new = (leaf if leaf.device == first
                       else _leaf(leaf, first, leaf.requires_grad))
            else:
                split = True
                index = [mesh_lib._slot_index(
                    mesh, spec, tuple(leaf.shape),
                    {mesh_lib.DATA_AXIS: 0, mesh_lib.MODEL_AXIS: m})[dim]
                    for m in range(local.model_size)]
                pieces = [leaf.detach().narrow(
                    dim, index[m].start, index[m].stop - index[m].start
                ).to(dev).clone(memory_format=torch.contiguous_format
                                ).requires_grad_(leaf.requires_grad)
                    for m, dev in zip(local.positions, rows[0])]
                row_split = None
                if local.spans_ranks:
                    row_split = RowSplit(
                        [s.start for s in index] + [index[-1].stop], owners,
                        local.positions, self.row)
                new = ShardedTensor(pieces, dim, row_split)
            if new is not leaf:
                swap[id(leaf)] = _pieces(new)
            leaves.append(new)
        if split:
            _require_elementwise(self.optimizer)
        if swap:
            if any(self.optimizer.state.values()):
                raise ValueError(
                    "the step places its params on the mesh before the "
                    "optimizer's first step; this optimizer already holds "
                    "state")
            for group in self.optimizer.param_groups:
                group["params"] = [n for q in group["params"]
                                   for n in swap.get(id(q), [q])]
        self.tree = mesh_lib.tree_unflatten_like(self.tree, leaves)
        self._rows = rows
        self._stats = [self.stats] + [
            _tree_map(lambda t, d=row[0]: t.detach().to(d, copy=True),
                      self.stats) if self.stats is not None else None
            for row in rows[1:]]

    def _view(self, g: int):
        """Data group ``g``'s param tree: the leaves themselves where its
        slots are the first group's, else copies on its devices that
        autograd carries the gradient back through."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        row = self._rows[g]
        if row == self._rows[0]:
            return self.tree

        def move(t):
            if isinstance(t, ShardedTensor):
                return t.like([s.to(row[m]) for m, s in
                               enumerate(t.shards)], t.split_dim)
            return t.to(row[0])

        return _tree_map(move, self.tree)

    @property
    def data_groups(self) -> int:
        """The data groups a batch is split over (1 on one slot)."""
        return 1 if self._rows is None else len(self._rows)

    def cards(self) -> List[torch.device]:
        """The distinct devices the step's groups and shards run on."""
        if self._rows is None:
            return [self.params[0].device] if self.params else []
        seen: Dict[str, torch.device] = {}
        for row in self._rows:
            for d in row:
                seen.setdefault(str(d), d)
        return list(seen.values())

    def opt_state_shardings(self):
        """The sharding of each tensor of the optimizer's state now
        (:func:`resolve_opt_state_shardings`; the state is made at the
        first step), or None for a step made without ``param_specs``."""
        if self.param_shardings is None:
            return None
        return resolve_opt_state_shardings(
            self.optimizer, self._template, self.param_shardings,
            self.replicated, owners=self._owners())

    def _owners(self) -> List[int]:
        """For each tensor in the optimizer's param groups, the index of
        the whole leaf (in the params tree's order) it is or is a shard
        of."""
        index = {id(p): i for i, t in enumerate(_tree_leaves(self.tree))
                 for p in _pieces(t)}
        return [index[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    # -- the step ----------------------------------------------------------
    def forward_backward(self, x, y) -> torch.Tensor:
        """Zero the gradients, then the batch's mean loss and its
        backward; returns the loss, detached."""
        self.optimizer.zero_grad(set_to_none=True)
        if self._rows is None:
            lval = self.loss_of(self.tree, self.stats, x, y)
        else:
            lval = self._groups_loss(x, y)
        lval.backward()
        return lval.detach()

    def _groups_loss(self, x, y) -> torch.Tensor:
        dp = len(self._rows)
        n = int(x.shape[0])
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"mesh's {dp} data groups")
        b = n // dp
        if self.stats is not None:
            with torch.no_grad():
                for st in self._stats[1:]:
                    for dst, src in zip(_tree_leaves(st),
                                        _tree_leaves(self.stats)):
                        dst.copy_(src)
        jobs = [(g, self._view(g), self._stats[g],
                 x.narrow(0, g * b, b).to(row[0]),
                 y.narrow(0, g * b, b).to(row[0]))
                for g, row in enumerate(self._rows)]
        if self.stats is not None and dp > 1:
            losses = self._threaded(jobs)
        else:
            from sparkdl_tpu_torch.models.layers import data_group

            # one group: its BatchNorms' sums meet over the column group
            # alone
            sums = self._sums(1) if self.stats is not None else None
            losses = []
            for g, p, st, xg, yg in jobs:
                with data_group(g, sums):
                    losses.append(self.loss_of(p, st, xg, yg))
        first = self._rows[0][0]
        total = losses[0]
        for lval in losses[1:]:
            total = total + lval.to(first)
        return total / dp

    def _threaded(self, jobs) -> List[torch.Tensor]:
        """Each group's loss in a thread of its own (the BatchNorms of the
        groups meet inside their forwards); the caller's default device
        and CUDA streams carry over.  A group that raises breaks the
        rendezvous, and its error is raised."""
        import contextlib
        import threading
        from concurrent.futures import ThreadPoolExecutor

        import sparkdl_tpu_torch
        from sparkdl_tpu_torch.models.layers import data_group

        if self._pool is None:
            self._pool = ThreadPoolExecutor(len(jobs),
                                            thread_name_prefix="train-group")
        sums = self._sums(len(jobs))
        where = sparkdl_tpu_torch._default()
        streams = {str(d): torch.cuda.current_stream(d)
                   for d in self.cards() if d.type == "cuda"}

        def run(job):
            g, p, st, xg, yg = job
            stream = streams.get(str(xg.device))
            try:
                with sparkdl_tpu_torch.default_device(where), \
                        data_group(g, sums), \
                        (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext()):
                    return self.loss_of(p, st, xg, yg)
            except BaseException:
                sums.abort()
                raise

        futures = [self._pool.submit(run, j) for j in jobs]
        errors = [f.exception() for f in futures]
        for e in errors:  # the group that failed, not one it left waiting
            if e is not None and not isinstance(e, threading.BrokenBarrierError):
                raise e
        for e in errors:
            if e is not None:
                raise e
        return [f.result() for f in futures]

    def _sums(self, groups: int):
        """The rendezvous of a step's BatchNorm sums: the rank's
        ``groups`` data groups, then the column group (one differentiable
        all-reduce a BatchNorm, issued by group 0's thread in forward
        order; none for a column group of one rank)."""
        from sparkdl_tpu_torch.models.layers import GroupSums

        cross = (self.columns.differentiable_all_reduce
                 if self.columns.size > 1 else None)
        return GroupSums(groups, cross)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def pack(self, lval: torch.Tensor) -> torch.Tensor:
        """The gradients in one flat buffer of their type (made at the
        first call, reused after, so a graph writes a static tensor), and
        the loss at its own type: in the buffer's last element where the
        types agree, else in a one-element tensor of its own reduced
        beside it (a float32 loss of a bf16 model stays float32; a
        float64 loss of float64 one-hot labels stays float64 without
        widening the float32 gradients the group all-reduces)."""
        grads = self._grads()
        dtype = grads[0].dtype if grads else lval.dtype
        for g in grads[1:]:
            dtype = torch.promote_types(dtype, g.dtype)
        carry = lval.dtype == dtype
        n = sum(g.numel() for g in grads) + int(carry)
        flat = self._flat
        if (flat is None or flat.numel() != n or flat.dtype != dtype
                or flat.device != lval.device):
            flat = self._flat = torch.empty(n, dtype=dtype,
                                            device=lval.device)
        if carry:
            self._loss = None
        elif (self._loss is None or self._loss.dtype != lval.dtype
              or self._loss.device != lval.device):
            self._loss = torch.empty(1, dtype=lval.dtype, device=lval.device)
        # a shard's gradient lives on its slot's card
        torch.cat([g.reshape(-1).to(flat.device, dtype) for g in grads]
                  + ([lval.reshape(1)] if carry else []), out=flat)
        if not carry:
            self._loss.copy_(lval.reshape(1))
        return flat

    def reduce(self) -> None:
        """Sum the flat buffer (and a loss of another type) over the
        column group (on the host under gloo; nothing for one rank)."""
        self.columns.all_reduce(self._flat)
        if self._loss is not None:
            self.columns.all_reduce(self._loss)

    def unpack(self) -> torch.Tensor:
        """Divide the summed buffer by the column group's size and write
        it back into the gradients; returns the mean loss over the data
        rows, at its own type (a view of the buffer or of the loss's
        tensor)."""
        flat = self._flat
        flat.div_(self.columns.size)
        off = 0
        for g in self._grads():
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        if self._loss is None:
            return flat[-1]
        return self._loss.div_(self.columns.size)[0]

    def __call__(self, x, y) -> torch.Tensor:
        lval = self.forward_backward(x, y)
        if self.columns.size > 1:
            self.pack(lval)
            self.reduce()
            lval = self.unpack().clone()
        self.optimizer.step()
        return lval

    # -- what a fit reads, saves and restores ------------------------------
    def host_params(self):
        """The params tree as numpy arrays, each split leaf whole."""
        from sparkdl_tpu_torch.parallel.shard import gather

        return _tree_map(lambda t: gather(t).detach().cpu().numpy(),
                         self.tree)

    def state_dict(self) -> Dict[str, Any]:
        """``{"params": ..., "opt_state": ...}`` with each split leaf whole
        (its shards concatenated) and the optimizer's ``state_dict`` in
        the layout of the whole leaves (a shard's state tensors
        concatenated along the split, the rest the first shard's), so a
        checkpoint reads the same whatever the mesh.  Where the shards
        span ranks both are all-gathered over the row group: every rank
        of a row calls this at once."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor, gather

        sd = self.optimizer.state_dict()
        leaves = _tree_leaves(self.tree)
        owners = self._owners()
        per_leaf: Dict[int, List[int]] = {}
        for pos, i in enumerate(owners):
            per_leaf.setdefault(i, []).append(pos)
        state: Dict[int, Dict[str, Any]] = {}
        for i in sorted(per_leaf):
            sts = [sd["state"].get(pos) for pos in per_leaf[i]]
            if any(st is None for st in sts):
                continue
            state[i] = dict(sts[0])
            leaf = leaves[i]
            if not isinstance(leaf, ShardedTensor):
                continue
            for k in sorted(state[i]):
                if _per_shard(state[i][k], leaf.shards[0]):
                    state[i][k] = leaf.like(
                        [st[k] for st in sts], leaf.split_dim).gather()
        groups = []
        for g_sd in sd["param_groups"]:
            ids: List[int] = []
            for pos in g_sd["params"]:
                if owners[pos] not in ids:
                    ids.append(owners[pos])
            groups.append(dict(g_sd, params=ids))
        return {"params": _tree_map(lambda t: gather(t).detach(), self.tree),
                "opt_state": {"state": state, "param_groups": groups}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict`'s layout: each whole leaf's values
        (split again over its shards) and the optimizer's state."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        leaves = _tree_leaves(self.tree)
        with torch.no_grad():
            for t, v in zip(leaves, _tree_leaves(state["params"])):
                v = torch.as_tensor(v)
                if isinstance(t, ShardedTensor):
                    for (off, n), s in zip(t.spans(), t.shards):
                        s.copy_(v.narrow(t.split_dim, off, n))
                else:
                    t.copy_(v)
        saved = state["opt_state"]
        owners = self._owners()
        per_leaf: Dict[int, List[int]] = {}
        for pos, i in enumerate(owners):
            per_leaf.setdefault(i, []).append(pos)
        st_out: Dict[int, Dict[str, Any]] = {}
        for i, st in saved["state"].items():
            i = int(i)
            spans = (leaves[i].spans() if isinstance(leaves[i], ShardedTensor)
                     else None)
            for m, pos in enumerate(per_leaf[i]):
                # each shard its own tensors: a step count shared by two
                # shards would be counted twice a step
                st_out[pos] = {
                    k: (v.narrow(leaves[i].split_dim, *spans[m]).clone()
                        if spans is not None and torch.is_tensor(v)
                        and tuple(v.shape) == tuple(leaves[i].shape)
                        else v.clone() if torch.is_tensor(v) else v)
                    for k, v in st.items()}
        groups = [dict(g, params=[pos for i in g["params"]
                                  for pos in per_leaf[int(i)]])
                  for g in saved["param_groups"]]
        self.optimizer.load_state_dict({"state": st_out,
                                        "param_groups": groups})

    def layout(self) -> Dict[str, Any]:
        """Where this rank's step runs: its row and column groups' ranks,
        its model positions in its row, and for each split leaf (by path)
        the owner rank of each shard and the indices of this rank's."""
        from sparkdl_tpu_torch.parallel.shard import ShardedTensor

        me = distributed.process_index()
        split = {}
        for path, t in mesh_lib.tree_flatten_with_path(self.tree):
            if isinstance(t, ShardedTensor):
                rs = t.row_split
                split[mesh_lib.param_path_str(path)] = dict(
                    owners=(rs.owners if rs is not None
                            else [me] * len(t.shards)),
                    local=(rs.local if rs is not None
                           else list(range(len(t.shards)))),
                    shards=[list(p.shape) for p in t.shards])
        return dict(row=list(self.row.ranks), column=list(self.columns.ranks),
                    positions=(list(self.local.positions)
                               if self.local is not None else [0]),
                    split=split)

    def close(self) -> None:
        """Stop the groups' threads, if any ran."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def _pieces(t) -> list:
    """The tensors an optimizer steps for one leaf: a split leaf's shards,
    else the leaf."""
    return list(t.shards) if hasattr(t, "shards") else [t]


def _per_shard(v, shard: torch.Tensor) -> bool:
    """Whether an optimizer state value is a tensor of its shard's shape
    (a moment), as opposed to a count or a scalar."""
    return torch.is_tensor(v) and tuple(v.shape) == tuple(shard.shape) \
        and v.dim() > 0


def _require_elementwise(optimizer: torch.optim.Optimizer) -> None:
    """A split weight trains shard by shard: its optimizer's update must
    be elementwise, so that each shard's update is its slice of the whole
    one."""
    from sparkdl_tpu_torch.param import converters as cv

    ok = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
          torch.optim.RMSprop, torch.optim.Adagrad, cv.OptaxAdam,
          cv.OptaxRMSprop, cv.OptaxAdagrad, cv.Lion)
    if not isinstance(optimizer, ok):
        raise NotImplementedError(
            f"{type(optimizer).__name__} over a split weight: its update "
            f"is not known to be elementwise (Lamb's trust ratio is a norm "
            f"over the whole tensor), so a shard's update would not be its "
            f"slice of the whole one")


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
                                replicated, owners: Optional[Sequence[int]]
                                = None):
    """A sharding for each tensor of ``optimizer``'s state, by whole leaf
    (the leaf's index in ``params_template``'s order -> state key ->
    sharding): a state tensor of its param's shape (Adam's moments, a
    momentum buffer) inherits the param's sharding, anything else (step
    counts, scalars) is replicated.  ``owners`` gives, for each tensor in
    the optimizer's param groups, the index of the leaf it is or is a
    shard of (default: one tensor per leaf, in order), so a split leaf's
    moments, which live per shard in shard-shaped tensors, report the
    leaf's sharding.  The optimizer's state is made at its first step:
    before it the result is empty."""
    flat_sh = [s for _, s in mesh_lib.tree_flatten_with_path(
        param_shardings, mesh_lib._is_spec)]
    params = [p for g in optimizer.param_groups for p in g["params"]]
    owners = list(range(len(params))) if owners is None else list(owners)
    out: Dict[int, Dict[str, Any]] = {}
    for i, p in zip(owners, params):
        st = optimizer.state.get(p)
        if not st or i in out:
            continue
        out[i] = {}
        for key, value in st.items():
            same = (isinstance(value, torch.Tensor) and i < len(flat_sh)
                    and tuple(value.shape) == tuple(p.shape))
            out[i][key] = flat_sh[i] if same else replicated
    return out


def make_train_step(predict_fn: Callable, loss,
                    optimizer: torch.optim.Optimizer, params, *,
                    mesh=None, param_specs=None,
                    params_template=None) -> TrainStep:
    """A :class:`TrainStep` on the batch mean of ``loss(predict_fn(params,
    x), y)``, ``optimizer`` built over the tensors of ``params``.

    ``mesh`` (default :func:`~.mesh.get_mesh` in a process group, else
    the params' device): on a mesh of several slots of this process the
    step splits each batch over the data groups and places the params on
    the slots (see :class:`TrainStep`; ``step.tree`` is then the placed
    tree and ``optimizer`` steps its leaves).  ``param_specs`` (with
    ``params_template``, default ``params``): a tree of ``PartitionSpec``
    or a ``(path, leaf) -> PartitionSpec`` rule, resolved as JAX's; a spec
    that splits a leaf on the ``model`` axis makes it a
    :class:`~.shard.ShardedTensor` of trainable shards.  In a process
    group the mesh's data axis spans the ranks (and each rank's own
    groups) and each rank runs its own rows (:func:`~.mesh.local_rows`).
    Where a row's slots span ranks each rank holds its own shards of every
    split leaf, and the ranks of that row must be given the SAME rows of
    each batch (JAX's replica contract): :class:`TrainStep`."""
    loss_fn = resolve_loss(loss)

    def loss_of(p, stats, x, y):
        return torch.mean(loss_fn(predict_fn(p, x), y))

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
    captured step updates static tensors); in a process group, and over
    the data groups of a mesh, they are the global batch's."""
    loss_fn = resolve_loss(loss)

    def loss_of(p, current, x, y):
        pred, new_stats = train_fn({"params": p, "batch_stats": current}, x)
        with torch.no_grad():
            for old, new in zip(_tree_leaves(current),
                                _tree_leaves(new_stats)):
                if new.data_ptr() != old.data_ptr():
                    old.copy_(new)
        return torch.mean(loss_fn(pred, y))

    return _step(loss_of, optimizer, params, mesh, param_specs,
                 params_template, stats=stats["batch_stats"])


def _step(loss_of, optimizer, params, mesh, param_specs,
          params_template, stats=None) -> TrainStep:
    pc = distributed.process_count()
    if mesh is None:
        # the step runs where its tensors are: the ranks' devices in a
        # group, else the params' one device
        leaves = _tree_leaves(params)
        mesh = (mesh_lib.get_mesh() if pc > 1
                else mesh_lib.get_mesh(devices=[
                    leaves[0].device if leaves else resolve_device()]))
    param_shardings = template = None
    if param_specs is not None:
        template = params_template if params_template is not None else params
        param_shardings = resolve_param_specs(param_specs, template, mesh)
    return TrainStep(loss_of, optimizer, params, mesh=mesh,
                     param_shardings=param_shardings,
                     params_template=template, stats=stats)


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
              fit_steps: Optional[Tuple[int, int]] = None, spe: int = 1,
              *, cards: int = 1, groups: int = 1, shared: bool = False,
              row: Sequence[int] = (), column: Sequence[int] = ()
              ) -> Tuple[str, str]:
    """(mode, reason) of a fit's steps: ``captured`` (one graph per group
    length), ``split`` (a process group: two graphs a step around the
    host all-reduce) or ``eager`` (with the reason).  ``fit_steps``: the
    fit's (steps an epoch, epochs to run) when known before its first
    step, else None (a stream of unknown length: captured); a fit whose
    graphs would be replayed fewer than :data:`BREAK_EVEN_REPLAYS` times a
    captured step runs eagerly.  On a mesh in one process: ``cards``, the
    distinct cards its slots name (a step across cards runs eagerly),
    ``groups``, its data groups (whose batch statistics meet between
    threads: eager), and ``shared``, another fit running on one of its
    cards at the start (fitMultiple's slices: eager, as a capture would
    share that fit's side stream).  ``row`` / ``column``: the ranks of
    the step's row and column groups (:meth:`TrainStep.layout`); a row of
    several ranks runs eagerly, its collectives inside the forward and
    backward."""
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
    if len(row) > 1:
        return "eager", (
            f"the model axis spans ranks {list(row)} (the row group): each "
            f"split op's output is all-gathered over them and its input's "
            f"gradient all-reduced, on the host under gloo, inside the "
            f"forward and backward, which no graph can hold; the gradients "
            f"then meet over the column group {list(column)}")
    if cards > 1:
        return "eager", (f"the mesh spans {cards} cards: a captured graph "
                         f"holds one card's work, and the data groups' "
                         f"gradients meet across the cards inside the step")
    pc = distributed.process_count()
    if groups > 1 and with_stats:
        return "eager", (f"batch statistics over {groups} data groups"
                         f"{f' of each of {pc} ranks' if pc > 1 else ''}: "
                         f"their sums meet between the groups' threads "
                         f"inside the forward"
                         f"{', then across the ranks' if pc > 1 else ''}")
    if shared:
        return "eager", ("another fit runs on this card at once "
                         "(fitMultiple's mesh slices): a capture would share "
                         "its side stream")
    mode = "captured"
    if pc > 1:
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


def resolve_fit_mesh(mesh=None, device: DeviceLike = None):
    """The mesh a fit runs on: ``mesh`` when given; in a process group
    :func:`~.mesh.get_mesh` (every rank's slots, rank-major); in one
    process the one device ``device`` names, or with no ``device`` the
    default mesh, as JAX's is (:func:`~.mesh.get_mesh`: every visible
    card, the CPU, or the one card the default device names).  This
    process's rows (:func:`~.mesh.local_rows`) are checked and each of
    their slots resolved, so a CUDA slot without a card raises
    ``RuntimeError``.

    A data row whose slots span ranks raises ``NotImplementedError``: a
    fit gives each rank its own rows of every global batch (its
    ``max(dp // W, batch // W)`` from its own shard), while the ranks of
    such a row are replicas that must pass the SAME rows (JAX's
    ``make_array_from_process_local_data``: "if any two hosts are
    replicas, host_local_data should be identical").  JAX's fit feeds
    them different rows there, whose result is wrong, so the port
    refuses it (ROADMAP.md §C); :func:`make_train_step` trains such a
    mesh with the caller passing each row's rows to its ranks."""
    pc = distributed.process_count()
    if mesh is None:
        mesh = (mesh_lib.get_mesh() if pc > 1 or device is None
                else mesh_lib.get_mesh(devices=[resolve_device(device)]))
    local = mesh_lib.local_rows(mesh)
    if local.spans_ranks:
        raise NotImplementedError(
            f"mesh {mesh.shape}: data row {local.rows[0]} holds slots of "
            f"ranks {list(local.row_ranks[0])}, so they are replicas that "
            f"must be given the same rows (JAX's replica contract for "
            f"make_array_from_process_local_data), while a fit gives each "
            f"rank its own rows of every global batch; JAX's fit breaks "
            f"that contract on such a mesh and the port refuses it "
            f"(ROADMAP.md §C): train it with make_train_step / "
            f"make_train_step_with_stats, passing the ranks of a row the "
            f"same rows, or use a model_parallel that divides each rank's "
            f"slots")
    for d in local.devices.flat:
        resolve_device(d)
    return mesh


def group_devices(mesh) -> List[torch.device]:
    """The device each of this process's data groups of a fit on ``mesh``
    runs its rows on (its first slot), in group order: every group in one
    process, this rank's own in a process group."""
    local = mesh_lib.local_rows(mesh)
    return [resolve_device(local.devices[g][0])
            for g in range(int(local.shape[mesh_lib.DATA_AXIS]))]


def _fit_mesh(mesh, batch_size: int, device: DeviceLike
              ) -> Tuple[Any, int, int]:
    """(mesh, data-axis size over every rank, global batch rounded up to
    it)."""
    mesh = resolve_fit_mesh(mesh, device)
    dp = int(mesh.shape[mesh_lib.DATA_AXIS])
    if batch_size % dp:
        batch_size += dp - batch_size % dp
        logger.info("global batch rounded up to %d (multiple of %d-way "
                    "data axis)", batch_size, dp)
    return mesh, dp, batch_size


# the cards fits are running on now (device -> fits), so that a fit that
# starts beside another on one card knows it up front (step_mode's
# ``shared``); guarded by the side streams' lock, which is what two fits
# on a card would share
_ACTIVE_FITS: Dict[str, int] = {}


def _fit(predict_fn: Callable, params, epoch_batches: Callable[[int], Iterable],
         no_rows: str, epoch_steps: Optional[int], *, optimizer, loss,
         epochs: int, mesh,
         checkpoint_dir: Optional[str], checkpoint_every_epochs: int,
         metrics: Optional[Metrics], train_fn: Optional[Callable], stats,
         steps_per_execution: int, generators: Sequence = ()
         ) -> Tuple[Any, List[float]]:
    """The loop both fits share: ``epoch_batches(epoch)`` gives this
    rank's (x, y) host batches of the epoch, ``epoch_steps`` of them when
    known up front (None: a stream's own length); ``no_rows`` is the
    ``ValueError`` an epoch without a batch raises.  ``mesh`` is resolved
    (:func:`_fit_mesh`); the fit's tensors start on this process's first
    slot.  See :func:`fit_data_parallel` for the rest."""
    dev = resolve_device(mesh_lib.local_rows(mesh).devices.flat[0])
    make_opt = _resolve_optimizer(optimizer)
    with_stats = train_fn is not None
    tensors = _tree_map(lambda v: _leaf(v, dev, True), params)
    opt = make_opt(_tree_leaves(tensors))
    stats_ref = {"batch_stats": _tree_map(lambda v: _leaf(v, dev, False),
                                          stats if stats is not None else {})}
    if with_stats:
        step = make_train_step_with_stats(train_fn, loss, opt, tensors,
                                          stats_ref, mesh=mesh)
    else:
        step = make_train_step(predict_fn, loss, opt, tensors, mesh=mesh)

    start_epoch = 0
    ckptr = None
    if checkpoint_dir:
        from sparkdl_tpu_torch.checkpoint import TrainCheckpointer

        ckptr = TrainCheckpointer(checkpoint_dir, checkpoint_every_epochs)
        resumed = ckptr.restore_latest()
        if resumed is not None:
            start_epoch, state = resumed
            step.load_state_dict(state)
            if with_stats:
                with torch.no_grad():
                    for t, v in zip(_tree_leaves(stats_ref["batch_stats"]),
                                    _tree_leaves(state["batch_stats"])):
                        t.copy_(v)

    def ckpt_state():  # save_pytree copies the tensors to the host
        state = step.state_dict()
        if with_stats:
            state["batch_stats"] = stats_ref["batch_stats"]
        return state

    metrics = metrics if metrics is not None else Metrics()
    spe = max(1, int(steps_per_execution))
    fit_steps = (None if epoch_steps is None
                 else (epoch_steps, epochs - start_epoch))
    cards = [str(d) for d in step.cards()]
    with _SIDE_LOCK:
        shared = any(_ACTIVE_FITS.get(c) for c in cards)
        for c in cards:
            _ACTIVE_FITS[c] = _ACTIVE_FITS.get(c, 0) + 1
    try:
        mode, why = step_mode(dev, opt, with_stats, generators, fit_steps,
                              spe, cards=len(cards),
                              groups=step.data_groups, shared=shared,
                              row=step.row.ranks,
                              column=step.columns.ranks)
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
            metrics.gauge("train.data_groups", float(step.data_groups))
            if with_stats:
                return ({"params": step.host_params(),
                         "batch_stats": _host(stats_ref["batch_stats"])},
                        epoch_losses)
            return step.host_params(), epoch_losses
        finally:
            runner.release()
    finally:
        step.close()
        with _SIDE_LOCK:
            for c in cards:
                _ACTIVE_FITS[c] -= 1


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
    ``mesh`` (default :func:`resolve_fit_mesh`: the default mesh of every
    visible card, as JAX's; the one ``device`` names; every rank's slots
    in a process group).  On a mesh of several slots each global batch
    is split over the data groups in contiguous rows (in a group, each
    rank's rows over its own groups) and the groups' gradients are
    averaged before one update (:class:`TrainStep`); every weight is held
    whole, as JAX's fit holds it replicated.

    ``predict_fn(params, x) -> pred`` on tensors; ``loss(pred, y) -> [B]``
    (a name from :data:`LOSSES` or a callable); ``optimizer``: a factory
    ``params -> torch.optim.Optimizer``, a zero-argument factory returning
    one, or None (Adam at lr 1e-3, as JAX's default).  ``batch_size`` is
    the global batch, rounded up to the data axis (every rank's groups); in
    one process it is clamped to the rows.  In a process group, (x, y) are
    THIS rank's shard (:func:`.distributed.shard_files`) and the module
    docstring's global-batch rules apply.  ``steps_per_execution`` steps run per
    replay and loss fetch, with the same loss series as 1.

    With ``train_fn`` + ``stats`` (a tree of BatchNorm statistics),
    ``train_fn({"params": p, "batch_stats": s}, x) -> (pred, new_stats)``
    runs each step and the fitted value is ``{"params": ..., "batch_stats":
    ...}`` (estimator ``trainBatchStats=True``).  On a mesh of several data
    groups the groups call ``train_fn`` at once, each in a thread of its
    own (their BatchNorms meet): a ``train_fn`` that swaps tensors into a
    module (``torch.func.functional_call``) needs one module per group,
    which ``models.layers.current_data_group()`` names.  With ``checkpoint_dir``,
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
        optimizer=optimizer, loss=loss, epochs=epochs,
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
        optimizer=optimizer, loss=loss, epochs=epochs,
        mesh=mesh, checkpoint_dir=checkpoint_dir,
        checkpoint_every_epochs=checkpoint_every_epochs, metrics=metrics,
        train_fn=train_fn, stats=stats,
        steps_per_execution=steps_per_execution, generators=generators)
