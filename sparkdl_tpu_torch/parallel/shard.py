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
      dimension 0 (output channels), over a whole input: output split on
      its last / channel dimension;
    - ``matmul`` / ``@`` whose right operand is split on its last
      dimension (flax's kernel layout), over a whole left operand;
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
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map


def _is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


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
    shape, dtype and device (the first shard's) describe the whole."""

    @staticmethod
    def __new__(cls, shards: Sequence[torch.Tensor], dim: int):
        shards = list(shards)
        shape = list(shards[0].shape)
        dim = dim % len(shape)
        shape[dim] = sum(int(s.shape[dim]) for s in shards)
        out = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=shards[0].dtype, device=shards[0].device,
            requires_grad=False)
        out.shards = shards
        out.split_dim = dim
        return out

    def __init__(self, shards, dim):
        super().__init__()

    # -- what the caches and graph keys read -----------------------------
    def data_ptr(self) -> int:
        return self.shards[0].data_ptr()

    @property
    def _version(self) -> int:
        return sum(s._version for s in self.shards)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the first shard's device (a new tensor)."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], self.split_dim)

    def bounds(self) -> List[int]:
        """The offsets of the shards along the split dimension."""
        out, off = [], 0
        for s in self.shards:
            out.append(off)
            off += int(s.shape[self.split_dim])
        return out + [off]

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, dim={self.split_dim}, devices="
                f"{[str(s.device) for s in self.shards]})")

    def __deepcopy__(self, memo):
        return ShardedTensor([copy.deepcopy(s, memo) for s in self.shards],
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
                return ShardedTensor(grads, args[0].split_dim)
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
    b = st.bounds()
    return (st.split_dim + out_ndim - st.dim(),
            [(b[i], b[i + 1] - b[i]) for i in range(len(st.shards))])


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
        if _slices(s, nd) != (split, spans):
            return NotImplemented
    if out_shape[split] != sts[0].shape[sts[0].split_dim]:
        return NotImplemented
    outs = []
    for i, shard in enumerate(sts[0].shards):
        dev = shard.device
        a_i = [_piece(a, i, split, nd, spans, dev) for a in args]
        k_i = {k: _piece(v, i, split, nd, spans, dev)
               for k, v in kwargs.items()}
        outs.append(func(*a_i, **k_i))
    if not all(isinstance(o, torch.Tensor) for o in outs):
        return NotImplemented
    return ShardedTensor(outs, split)


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


def _linear(func, args, kwargs):
    x, w = args[0], args[1]
    bias = args[2] if len(args) > 2 else kwargs.get("bias")
    if _is_sharded(x) or not _is_sharded(w) or w.split_dim != 0:
        return NotImplemented
    b = w.bounds()
    outs = []
    for i, s in enumerate(w.shards):
        bi = None
        if bias is not None:
            bi = (bias.shards[i] if _is_sharded(bias) and bias.bounds() == b
                  else gather(bias).narrow(0, b[i], b[i + 1] - b[i]))
            bi = bi.to(s.device)
        outs.append(F.linear(x.to(s.device), s, bi))
    return ShardedTensor(outs, x.dim() - 1 if x.dim() else 0)


def _conv2d(func, args, kwargs):
    names = ("input", "weight", "bias", "stride", "padding", "dilation",
             "groups")
    bound = dict(zip(names, args))
    bound.update(kwargs)
    x, w = bound["input"], bound["weight"]
    if (_is_sharded(x) or not _is_sharded(w) or w.split_dim != 0
            or bound.get("groups", 1) != 1):
        return NotImplemented
    bias = bound.get("bias")
    b = w.bounds()
    outs = []
    for i, s in enumerate(w.shards):
        kw = dict(bound, input=x.to(s.device), weight=s)
        if bias is not None:
            kw["bias"] = gather(bias).narrow(0, b[i], b[i + 1] - b[i]).to(
                s.device)
        outs.append(F.conv2d(**kw))
    return ShardedTensor(outs, 1)


def _matmul(func, args, kwargs):
    a, w = args[0], args[1]
    if (_is_sharded(a) or not _is_sharded(w) or w.dim() < 2
            or w.split_dim != w.dim() - 1 or kwargs):
        return NotImplemented
    outs = [torch.matmul(a.to(s.device), s) for s in w.shards]
    return ShardedTensor(outs, outs[0].dim() - 1)


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
    return ShardedTensor([func(s, *args[1:]) for s in x.shards],
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
    return ShardedTensor([func(s, dims, **rest) for s in x.shards], split)


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
