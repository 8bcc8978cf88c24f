"""Weights split on the mesh's ``model`` axis, and the ops that run on them:
the port's counterpart of what XLA's SPMD partitioner does inside the JAX
engine's ``jit`` (``sparkdl_tpu/parallel/engine.py build_dispatch_jit``
with ``param_shardings``).

A weight that the policy splits lives in a data group's module as a
:class:`ShardedTensor`: one shard per model slot of the group, each on its
slot's device, split along one dimension.  Every op that meets a
``ShardedTensor`` goes through its ``__torch_function__``:

  * **Ops with a partitioned form run per shard**, on the shard's device,
    and give a ``ShardedTensor`` again:

    - ``F.linear`` whose weight is split on dimension 0 (torch's output
      features) and ``F.conv2d`` (``groups=1``) whose weight is split on
      dimension 0 (output channels), over a whole input (an input that an
      earlier split op left split is gathered first): output split on
      its last / channel dimension;
    - ``matmul`` / ``@`` whose right operand is split on its last
      dimension (flax's kernel layout), over a whole left operand
      (gathered first, likewise);
    - elementwise ops (arithmetic, activations, ``to(dtype)``, ``clone``,
      ``detach``, in-place updates and ``copy_``): every whole operand is
      sliced along the dimension the split lines up with after
      broadcasting (an operand of size 1 there is passed whole);
    - ``sum`` / ``mean`` over dimensions that leave the split one alone,
      and ``t`` / ``transpose`` / ``permute`` (the split moves with its
      dimension).

    No partitioned form reduces across shards, so every output element is
    summed in the order the whole op sums it (up to the algorithm a
    library picks for the narrower shape).
  * **Every other op gathers first**: each ``ShardedTensor`` operand is
    concatenated onto its first shard's device (the group's first slot)
    and the op runs whole, as XLA gathers a custom call's operands.  That
    covers the kernel wrappers (B1, B3, B2 and H1 call
    :func:`gathered` on their operands), depthwise convs, pooling, padding
    and every reshape or view.  A gathered weight is transient, except in a
    fold cache (``models.layers.cached_fold``), whose entries the engine
    counts in ``sharding_info()["fold_bytes_per_device"]``.

Why a tensor subclass and not a rewrite of ``nn.Linear`` / ``nn.Conv2d``:
the zoo and the callers' ``fn(module, batch)`` call ``F.conv2d``, ``@`` and
``F.linear`` on the module's tensors directly (Xception's ``conv2d``
helper, the engines' dense stand-ins), not through those modules'
``forward``, so only an interception at the op sees every use.

**Shards held by several processes.**  Where a mesh's data row spans
ranks (``parallel/mesh.py local_rows``), a split weight's
``ShardedTensor`` in each rank holds only that rank's shards, with its
place in the split (:class:`RowSplit`: every shard's bounds, its owner rank,
and the row group of ``parallel/distributed.py mesh_groups``).  The
partitioned forms above compute this rank's slice of the output (a
``ShardedTensor`` of the same split), and two autograd functions carry
the row group's collectives, as Megatron's column-parallel layers do:

  * every whole operand of a partitioned form that requires a gradient
    (the activation a split ``F.linear`` / ``F.conv2d`` / ``@`` reads, a
    whole bias or scale sliced to match) passes :class:`_RowInput`:
    identity forward, the gradient summed over the row group backward
    (each rank's part covers its own shards only); an operand that needs
    no gradient (a frozen backbone's features) passes as it is;
  * a gather is :class:`_RowGather`: the ranks' slices all-gathered over
    the row group in the shards' order forward; backward hands each of
    this rank's shards its slice of the gradient, NOT a sum over the
    ranks (every rank of a row computes the same downstream gradient, so
    a sum, as ``torch.distributed.nn.functional.all_gather``'s backward
    takes, would multiply it by the row's rank count).

Every rank of a row runs the same ops on the same rows, so the
collectives are issued in one order on every rank.  :func:`gather` and
:func:`gather_tree` are then cross-rank all-gathers (the kernel wrappers,
the fold caches and checkpoints see whole weights); a gather that fails
raises.  ``data_ptr()`` and ``_version`` stay this rank's own.

``data_ptr()`` and ``_version`` of a ``ShardedTensor`` are its first
shard's address and the sum of its shards' version counters: the keys the
fold caches and the engine's graph key read, so an in-place write to any
shard (``load_state_dict`` copies into each) is seen as a whole weight's
is.

**Autograd.**  A split weight trains with its shards as the leaves: each
shard is a tensor of its own that requires grad (one per model slot, on
its slot's device), and an optimizer steps the shards, so each holds its
own gradient and its own optimizer state.  The wrapper never enters
autograd (it holds no storage and ``__torch_dispatch__`` refuses every
aten op): every partitioned form above is a differentiable torch op on
the shard tensors, so the backward of each form is autograd's own and
gives each shard the gradient of its slice (``F.linear`` / ``F.conv2d``
to their weight shard and bias slice, ``@`` to its column block, an
elementwise op to its slice, a sum or a transpose to its shard), and a
whole operand of a partitioned form (the activation a split ``F.linear``
reads, a bias sliced to match) gets the sum of every shard's part.  A
gather is ``torch.cat`` of the shards (moved to the first shard's
device), whose backward hands each shard its slice of the gradient: what
a softmax or a loss over a split class dimension meets first.  The
wrapper reads its shards for ``requires_grad`` (any shard's),
``grad`` (a ``ShardedTensor`` of the shards' gradients, or None) and
``requires_grad_`` (every shard's).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map


def _is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


class RowSplit:
    """Where a rank's shards sit in a split that spans ranks: ``bounds``
    the offsets of every shard of the row along the split (one more than
    the shards), ``owners`` each shard's rank, ``local`` the indices of
    this rank's shards (ascending), ``group`` the row group
    (``distributed.RankGroup``) whose collectives gather the whole."""

    def __init__(self, bounds: Sequence[int], owners: Sequence[int],
                 local: Sequence[int], group):
        self.bounds = [int(b) for b in bounds]
        self.owners = [int(r) for r in owners]
        self.local = [int(i) for i in local]
        self.group = group
        first = {}
        for i, r in enumerate(self.owners):
            first.setdefault(r, i)
        # the members' slices in the order of their shards
        self.order = sorted(range(len(group.ranks)),
                            key=lambda k: first[group.ranks[k]])

    def spans(self) -> List[Tuple[int, int]]:
        """(offset, length) of each of this rank's shards."""
        b = self.bounds
        return [(b[i], b[i + 1] - b[i]) for i in self.local]


class _RowGather(torch.autograd.Function):
    """The whole tensor from each rank's shards: all-gather over the row
    group forward; this rank's slices of the gradient backward."""

    @staticmethod
    def forward(ctx, dim, split, *shards):
        dev = shards[0].device
        mine = torch.cat([s.to(dev) for s in shards], dim).contiguous()
        pieces = split.group.all_gather(mine)
        ctx.dim, ctx.spans = dim, split.spans()
        ctx.devices = [s.device for s in shards]
        return torch.cat([pieces[k] for k in split.order], dim)

    @staticmethod
    def backward(ctx, grad):
        return (None, None) + tuple(
            grad.narrow(ctx.dim, off, n).to(d)
            for (off, n), d in zip(ctx.spans, ctx.devices))


class _RowInput(torch.autograd.Function):
    """A whole operand of a partitioned form over shards of several
    ranks: identity forward; the gradient summed over the row group
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


def _row_input(a, st: "ShardedTensor"):
    """``a`` as a partitioned form over ``st`` reads it: through
    :class:`_RowInput` where ``st``'s shards span ranks and ``a`` is a
    whole tensor autograd records."""
    if (st.row_split is None or _is_sharded(a)
            or not isinstance(a, torch.Tensor)
            or not (a.requires_grad and torch.is_grad_enabled())):
        return a
    return _RowInput.apply(a, st.row_split.group)


def gather(x):
    """``x`` whole: a :class:`ShardedTensor` concatenated on its first
    shard's device, anything else as it is."""
    return x.gather() if _is_sharded(x) else x


def gathered(*xs):
    """Every operand whole (the kernel wrappers' first step)."""
    return tuple(gather(x) for x in xs)


def gather_tree(tree):
    """A pytree with every :class:`ShardedTensor` leaf gathered."""
    return tree_map(gather, tree)


class ShardedTensor(torch.Tensor):
    """A tensor split along ``dim`` into ``shards`` (one per model slot of
    a data group, in slot order).  It holds no storage of its own; its
    shape, dtype and device (the first shard's) describe the whole.
    ``row_split`` (a :class:`RowSplit`) marks a split whose other shards
    belong to other ranks: ``shards`` are then this rank's."""

    @staticmethod
    def __new__(cls, shards: Sequence[torch.Tensor], dim: int,
                row_split: Optional[RowSplit] = None):
        shards = list(shards)
        shape = list(shards[0].shape)
        dim = dim % len(shape)
        shape[dim] = (row_split.bounds[-1] if row_split is not None
                      else sum(int(s.shape[dim]) for s in shards))
        out = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=shards[0].dtype, device=shards[0].device,
            requires_grad=False)
        out.shards = shards
        out.split_dim = dim
        out.row_split = row_split
        return out

    def __init__(self, shards, dim, row_split=None):
        super().__init__()

    def like(self, shards: Sequence[torch.Tensor], dim: int
             ) -> "ShardedTensor":
        """A ShardedTensor of ``shards`` split as this one is (the same
        bounds and owners), along ``dim``."""
        return ShardedTensor(shards, dim, self.row_split)

    # -- what the caches and graph keys read -----------------------------
    def data_ptr(self) -> int:
        return self.shards[0].data_ptr()

    @property
    def _version(self) -> int:
        return sum(s._version for s in self.shards)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the first shard's device (a new tensor;
        an all-gather over the row group where the shards span ranks)."""
        if self.row_split is not None:
            return _RowGather.apply(self.split_dim, self.row_split,
                                    *self.shards)
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], self.split_dim)

    def bounds(self) -> List[int]:
        """The offsets of every shard of the split along its dimension
        (this rank's and, where the split spans ranks, the others')."""
        if self.row_split is not None:
            return list(self.row_split.bounds)
        out, off = [], 0
        for s in self.shards:
            out.append(off)
            off += int(s.shape[self.split_dim])
        return out + [off]

    def spans(self) -> List[Tuple[int, int]]:
        """(offset, length) of each of ``shards`` along the split."""
        if self.row_split is not None:
            return self.row_split.spans()
        b = self.bounds()
        return [(b[i], b[i + 1] - b[i]) for i in range(len(self.shards))]

    def __repr__(self) -> str:
        rs = self.row_split
        owners = ("" if rs is None
                  else f", owners={rs.owners}, local={rs.local}")
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, dim={self.split_dim}, devices="
                f"{[str(s.device) for s in self.shards]}{owners})")

    def __deepcopy__(self, memo):
        return self.like([copy.deepcopy(s, memo) for s in self.shards],
                         self.split_dim)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__get__":
            attr = getattr(getattr(func, "__self__", None), "__name__", "")
            if attr == "data":
                return args[0]
            if attr == "requires_grad":
                return any(s.requires_grad for s in args[0].shards)
            if attr == "grad":
                grads = [s.grad for s in args[0].shards]
                if any(g is None for g in grads):
                    return None
                return args[0].like(grads, args[0].split_dim)
            if attr not in _VALUE_ATTRS:
                with torch._C.DisableTorchFunctionSubclass():
                    return func(*args, **kwargs)
        if func in _METADATA:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        handler = _HANDLERS.get(func)
        if handler is not None:
            out = handler(func, args, kwargs)
            if out is not NotImplemented:
                return out
        return func(*gather_tree(args), **gather_tree(kwargs))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached the dispatcher with a "
                           f"ShardedTensor operand; parallel/shard.py "
                           f"handles every op above it")


# properties that read the values (the rest read the wrapper's metadata)
_VALUE_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "grad"}


_T = torch.Tensor
_METADATA = {_T.dim, _T.size, _T.numel, _T.element_size, _T.stride,
             _T.is_floating_point, _T.is_complex, _T.__len__,
             _T.get_device, _T.is_contiguous, _T.nelement, _T.ndimension}


def _slices(st: ShardedTensor, out_ndim: int):
    """(out split dimension, per-shard (offset, length)) of ``st`` in an
    output of ``out_ndim`` dimensions."""
    return st.split_dim + out_ndim - st.dim(), st.spans()


def _piece(a, i: int, out_split: int, out_ndim: int, spans, device):
    """Shard ``i``'s piece of operand ``a`` (see :func:`_elementwise`)."""
    if _is_sharded(a):
        return a.shards[i]
    if not isinstance(a, torch.Tensor):
        return a
    k = out_split - (out_ndim - a.dim())
    if k >= 0 and a.shape[k] != 1:
        off, n = spans[i]
        a = a.narrow(k, off, n)
    return a.to(device) if a.device != device else a


def _elementwise(func, args, kwargs):
    """An elementwise op over ShardedTensors split alike (and whole
    operands, sliced to match): per shard.  NotImplemented (gather) when
    the shards do not line up."""
    flat = [a for a in list(args) + list(kwargs.values())
            if isinstance(a, torch.Tensor)]
    sts = [a for a in flat if _is_sharded(a)]
    try:
        out_shape = torch.broadcast_shapes(*[tuple(a.shape) for a in flat])
    except RuntimeError:
        return NotImplemented
    nd = len(out_shape)
    split, spans = _slices(sts[0], nd)
    for s in sts[1:]:
        if _slices(s, nd) != (split, spans) or s.bounds() != sts[0].bounds():
            return NotImplemented
    if out_shape[split] != sts[0].shape[sts[0].split_dim]:
        return NotImplemented
    args = [_row_input(a, sts[0]) for a in args]
    kwargs = {k: _row_input(v, sts[0]) for k, v in kwargs.items()}
    outs = []
    for i, shard in enumerate(sts[0].shards):
        dev = shard.device
        a_i = [_piece(a, i, split, nd, spans, dev) for a in args]
        k_i = {k: _piece(v, i, split, nd, spans, dev)
               for k, v in kwargs.items()}
        outs.append(func(*a_i, **k_i))
    if not all(isinstance(o, torch.Tensor) for o in outs):
        return NotImplemented
    return sts[0].like(outs, split)


def _inplace(func, args, kwargs):
    """An in-place elementwise op on a ShardedTensor ``self``: per shard
    (``copy_`` of a whole source copies its slices); returns ``self``."""
    self = args[0]
    if not _is_sharded(self):
        return NotImplemented
    nd = self.dim()
    split, spans = _slices(self, nd)
    for i, shard in enumerate(self.shards):
        rest = [_piece(a, i, split, nd, spans, shard.device)
                for a in args[1:]]
        k_i = {k: _piece(v, i, split, nd, spans, shard.device)
               for k, v in kwargs.items()}
        func(shard, *rest, **k_i)
    return self


def _to(func, args, kwargs):
    """``.to(dtype)`` (and ``memory_format=``) per shard; a device move
    gathers."""
    for a in list(args[1:]) + list(kwargs.values()):
        if isinstance(a, (str, torch.device, torch.Tensor)):
            return NotImplemented
    if "device" in kwargs:
        return NotImplemented
    return _elementwise(func, args, kwargs)


def _bias_pieces(bias, w: ShardedTensor) -> list:
    """Each of ``w``'s shards' slice of a bias over its split dimension:
    the bias's own shards where it is split alike, else slices of the
    whole one (whose gradient the row group sums)."""
    if bias is None:
        return [None] * len(w.shards)
    if (_is_sharded(bias) and bias.bounds() == w.bounds()
            and bias.spans() == w.spans()):
        pieces = list(bias.shards)
    else:
        whole = _row_input(gather(bias), w)
        pieces = [whole.narrow(0, off, n) for off, n in w.spans()]
    return [p.to(s.device) for p, s in zip(pieces, w.shards)]


def _whole_input(x, w):
    """A split op's input as its partitioned form reads it: whole (a
    ShardedTensor input, the output of an earlier split op, gathered
    first, so that ``w`` stays split)."""
    return _row_input(gather(x), w)


def _linear(func, args, kwargs):
    x, w = args[0], args[1]
    bias = args[2] if len(args) > 2 else kwargs.get("bias")
    if not _is_sharded(w) or w.split_dim != 0:
        return NotImplemented
    x = _whole_input(x, w)
    outs = [F.linear(x.to(s.device), s, bi)
            for s, bi in zip(w.shards, _bias_pieces(bias, w))]
    return w.like(outs, x.dim() - 1 if x.dim() else 0)


def _conv2d(func, args, kwargs):
    names = ("input", "weight", "bias", "stride", "padding", "dilation",
             "groups")
    bound = dict(zip(names, args))
    bound.update(kwargs)
    x, w = bound["input"], bound["weight"]
    if (not _is_sharded(w) or w.split_dim != 0
            or bound.get("groups", 1) != 1):
        return NotImplemented
    x = _whole_input(x, w)
    outs = []
    for s, bi in zip(w.shards, _bias_pieces(bound.get("bias"), w)):
        outs.append(F.conv2d(**dict(bound, input=x.to(s.device), weight=s,
                                    bias=bi)))
    return w.like(outs, 1)


def _matmul(func, args, kwargs):
    a, w = args[0], args[1]
    if (not _is_sharded(w) or w.dim() < 2
            or w.split_dim != w.dim() - 1 or kwargs):
        return NotImplemented
    a = _whole_input(a, w)
    outs = [torch.matmul(a.to(s.device), s) for s in w.shards]
    return w.like(outs, outs[0].dim() - 1)


def _transpose(func, args, kwargs):
    """``t`` / ``transpose`` / ``permute``: per shard, the split moves with
    its dimension."""
    x = args[0]
    if not _is_sharded(x) or kwargs:
        return NotImplemented
    n = x.dim()
    if func in (torch.t, _T.t):
        order = list(range(n))[::-1]
    elif func in (torch.transpose, _T.transpose):
        d0, d1 = args[1] % n, args[2] % n
        order = list(range(n))
        order[d0], order[d1] = d1, d0
    else:
        dims = args[1:]
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = dims[0]
        order = [d % n for d in dims]
    return x.like([func(s, *args[1:]) for s in x.shards],
                  order.index(x.split_dim))


def _reduce(func, args, kwargs):
    """``sum`` / ``mean`` over dimensions other than the split one."""
    x = args[0]
    dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if not _is_sharded(x) or dims is None or len(args) > 2:
        return NotImplemented
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [d % x.dim() for d in dims]
    if x.split_dim in dims:
        return NotImplemented
    keep = kwargs.get("keepdim", False)
    split = x.split_dim - (0 if keep else sum(d < x.split_dim for d in dims))
    rest = {k: v for k, v in kwargs.items() if k != "dim"}
    return x.like([func(s, dims, **rest) for s in x.shards], split)


_ELEMENTWISE = [
    torch.add, torch.sub, torch.mul, torch.div, torch.tanh, torch.relu,
    torch.sigmoid, torch.exp, torch.neg, torch.abs, torch.sqrt, torch.rsqrt,
    torch.clamp, torch.clip, torch.maximum, torch.minimum, torch.where,
    F.relu, F.relu6, F.silu, F.gelu,
    _T.__add__, _T.__radd__, _T.__sub__, _T.__rsub__, _T.__mul__,
    _T.__rmul__, _T.__truediv__, _T.__rtruediv__, _T.__neg__, _T.__pow__,
    _T.add, _T.sub, _T.mul, _T.div, _T.tanh, _T.relu, _T.sigmoid, _T.exp,
    _T.neg, _T.abs, _T.sqrt, _T.rsqrt, _T.clamp, _T.clip,
    _T.float, _T.half, _T.bfloat16, _T.double, _T.clone, _T.detach,
    _T.contiguous,
]
_INPLACE = [_T.copy_, _T.add_, _T.sub_, _T.mul_, _T.div_, _T.zero_,
            _T.fill_, _T.requires_grad_]

_HANDLERS: Dict[Any, Any] = {f: _elementwise for f in _ELEMENTWISE}
_HANDLERS.update({f: _inplace for f in _INPLACE})
_HANDLERS.update({
    _T.to: _to,
    F.linear: _linear,
    F.conv2d: _conv2d,
    torch.matmul: _matmul, _T.matmul: _matmul, _T.__matmul__: _matmul,
    torch.sum: _reduce, _T.sum: _reduce, torch.mean: _reduce,
    _T.mean: _reduce,
    torch.t: _transpose, _T.t: _transpose, torch.transpose: _transpose,
    _T.transpose: _transpose, torch.permute: _transpose,
    _T.permute: _transpose,
})
