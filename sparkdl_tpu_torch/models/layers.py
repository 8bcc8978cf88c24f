"""Building blocks of the port's zoo (port of ``sparkdl_tpu/models/layers.py``).

Modules take NCHW tensors (PyTorch's logical layout); the model keeps them
in ``channels_last`` memory, so the NHWC view the fused kernel takes is the
same bytes.  Padding follows TF "SAME" (asymmetric where the window and
stride need it), as the Keras weights were trained under.  Where an input
and a weight differ in dtype, the op runs in the type JAX would promote
both to (flax promotes; ``F.conv2d`` raises on mixed types).
``BatchNorm(scale=False)``, :class:`ConvBN`, :class:`SpaceToDepthConv`,
:func:`max_pool_valid` and :func:`avg_pool_same` are InceptionV3's;
:func:`correct_pad` and the 5x5 form of :class:`DepthwiseConv2D` are
EfficientNetB0's (its SiLU is ``F.silu``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.ops.sepconv import fused_sepconv

# Keras BatchNormalization defaults.
BN_EPS_DEFAULT = 1e-3
BN_MOMENTUM_DEFAULT = 0.01  # torch's convention: 1 - keras' 0.99


def promote(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Cast every tensor to their promoted dtype (JAX's rule for a binary
    op on bf16 and f32: f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0,
           groups: int = 1, bias: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``F.conv2d`` in the promoted dtype of ``x`` and ``weight``; the
    bias, if any, is cast to that dtype (as flax adds it)."""
    x, weight = promote(x, weight)
    if bias is not None:
        bias = bias.to(x.dtype)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding,
                    groups=groups)


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF "SAME" padding (low, high) of one spatial axis: the output has
    ceil(size / stride) positions and the odd pad goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """``nn.max_pool(..., padding="SAME")`` on NCHW: -inf padding, which is
    asymmetric where SAME needs it (74 -> 37 pads (0, 1));
    ``nn.MaxPool2d(padding=1)`` would be wrong there."""
    ph = same_padding(x.shape[2], window, stride)
    pw = same_padding(x.shape[3], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def correct_pad(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Keras ``imagenet_utils.correct_pad`` zero padding on NCHW, before a
    stride-2 VALID conv: ``(k//2 - (1 - H%2), k//2)`` rows and the same
    rule for columns, so an even extent pads one less on the low side."""
    h, w = x.shape[2], x.shape[3]
    c = kernel // 2
    return F.pad(x, (c - (1 - w % 2), c, c - (1 - h % 2), c))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6) in x's dtype (MobileNetV2's activation)."""
    return torch.clamp(x, 0.0, 6.0)


def depthwise_taps(weight: torch.Tensor) -> torch.Tensor:
    """A [C,1,3,3] grouped-conv depthwise weight as the kernels' [3,3,C]
    taps (keras' ``depthwise_kernel`` layout without its multiplier)."""
    c = weight.shape[0]
    return weight.reshape(c, 9).t().reshape(3, 3, c)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """GlobalAveragePooling2D over NCHW -> [N, C]: summed in f32, returned
    in x's dtype (``jnp.mean`` on bf16 does the same)."""
    return x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype)


class GroupSums:
    """The rendezvous of one step's data groups in one process (the mesh's
    rows, each run in a thread of its own): :meth:`all_sum` hands every
    group the sum of all groups' tensors, as the all-reduce does across
    the ranks of a process group.  Each group adds the parts in group
    order on its own device, so every group holds the same values, and
    autograd carries each group's share of the gradient back to every
    group's part.  :meth:`abort` breaks the rendezvous for every waiting
    group (a group that raised will never arrive).

    ``cross`` (a differentiable sum across the ranks of a process group,
    ``torch.distributed.nn.functional.all_reduce``, over the column group
    where a data row spans ranks) makes the sum the group's as well: group 0 adds the parts in group order, then issues
    the one collective of this rendezvous, so that one thread of the rank
    issues them, in the order of its calls, as every other rank does;
    the other groups read its result on their devices.  The gradient
    flows back through the collective (an all-reduce of the gradient) to
    every group's part of every rank."""

    def __init__(self, groups: int, cross: Optional[Callable] = None):
        self.groups = int(groups)
        self._parts: list = [None] * self.groups
        self._barrier = threading.Barrier(self.groups)
        self._cross = cross
        self._total: Optional[torch.Tensor] = None

    def all_sum(self, index: int, part: torch.Tensor) -> torch.Tensor:
        self._parts[index] = part
        self._barrier.wait()
        if self._cross is None or index == 0:
            total = self._parts[0].to(part.device)
            for other in self._parts[1:]:
                total = total + other.to(part.device)
        if self._cross is not None:
            if index == 0:
                try:
                    self._total = total = self._cross(total)
                except BaseException:
                    self.abort()
                    raise
            self._barrier.wait()
            total = self._total.to(part.device)
        # no group writes its next part before every group has read
        self._barrier.wait()
        return total

    def abort(self) -> None:
        self._barrier.abort()


_GROUP = threading.local()


@contextlib.contextmanager
def data_group(index: int, sums: Optional[GroupSums] = None
               ) -> Iterator[None]:
    """Mark the calling thread as running data group ``index`` of a step
    (``parallel.train``), whose train-mode BatchNorms meet at ``sums``
    (None: the group's own rows make its statistics)."""
    prev = getattr(_GROUP, "current", None)
    _GROUP.current = (int(index), sums)
    try:
        yield
    finally:
        _GROUP.current = prev


def current_data_group() -> Optional[Tuple[int, Optional[GroupSums]]]:
    """``(index, sums)`` of the data group the calling thread runs, or
    None outside a step on a mesh."""
    return getattr(_GROUP, "current", None)


def flax_batch_norm_train(bn: nn.modules.batchnorm._BatchNorm,
                          x: torch.Tensor) -> torch.Tensor:
    """A train-mode BatchNorm over axis 1 with flax's arithmetic and update
    (``flax.linen.BatchNorm(use_running_average=False)``): batch mean μ and
    the BIASED variance σ² = E[x²] − μ² (floored at 0), y = (x − μ)·
    (rsqrt(σ² + ε)·γ) + β, and running = m·running + (1 − m)·batch with m =
    1 − ``bn.momentum`` (the module keeps torch's convention).
    ``nn.BatchNorm2d`` in train mode updates ``running_var`` with the
    unbiased variance instead.  The statistics are updated in place,
    without autograd; the output's gradient flows through μ and σ².

    μ and σ² are the GLOBAL batch's, as under JAX's ``jit`` over a
    sharded batch, wherever the batch is split: in a ``torch.distributed``
    group of more than one process the per-channel sum, sum of squares and
    count are all-reduced (one collective, ``torch.distributed.nn``, so
    the gradient flows back through it to every rank's rows); in a step
    over the data groups of one process (:func:`data_group` with a
    :class:`GroupSums`) they are summed across the groups the same way;
    over the data groups of each rank of a group, across the rank's groups
    first, then across the ranks (a :class:`GroupSums` with ``cross``),
    as JAX's one ``pmean`` over the whole data axis.  Where a data row
    spans ranks (a model axis across processes, ``parallel.train``), every
    rank of the row computes the row's sums (a split conv's output is
    gathered over the row first), so ``cross`` sums over the column group
    only, one rank a row, not over every rank."""
    x, _ = promote(x, bn.running_mean)
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    dist = torch.distributed
    group = current_data_group()
    if ((dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)
            or (group is not None and group[1] is not None)):
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=x.dtype,
                           device=x.device)
        local = torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), count])
        if group is not None and group[1] is not None:
            sums = group[1].all_sum(group[0], local)
        else:
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(local)
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    else:
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (x - mean.reshape(shape)) * mul.reshape(shape)
    if bn.bias is not None:
        y = y + bn.bias.reshape(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(m * mean.detach())
        bn.running_var.mul_(1.0 - m).add_(m * var.detach())
    return y


class BatchNorm(nn.BatchNorm2d):
    """Keras-default inference BatchNorm (eps 1e-3) with the folded form of
    ``BNAffine`` beside it; both read the same four tensors.  In train
    mode it follows flax (:func:`flax_batch_norm_train`), as the JAX
    zoo's train-mode apply does.

    ``scale=False`` is keras' ``BatchNormalization(scale=False)``: no gamma
    at all (``weight`` is None, so the ``state_dict`` holds only ``bias``
    and the statistics) and a scale of 1 in both forms."""

    def __init__(self, num_features: int, eps: float = BN_EPS_DEFAULT,
                 momentum: float = BN_MOMENTUM_DEFAULT, scale: bool = True):
        super().__init__(num_features, eps=eps, momentum=momentum)
        if not scale:
            self.register_parameter("weight", None)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale', shift') in f32: scale' = gamma / sqrt(var + eps),
        shift' = beta - mean * scale' — full precision even when the
        engine cast the module to bf16."""
        f32 = torch.float32
        sd = torch.sqrt(self.running_var.to(f32) + self.eps)
        s = self.weight.to(f32) / sd if self.weight is not None else 1.0 / sd
        t = self.bias.to(f32) - self.running_mean.to(f32) * s
        return s, t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return flax_batch_norm_train(self, x)
        x, _ = promote(x, self.bias)
        return super().forward(x)


class SeparableConv2D(nn.Module):
    """Bias-free 3x3 depthwise (stride 1, SAME, multiplier 1) + 1x1
    pointwise conv, as Xception uses it (``keras.layers.SeparableConv2D``).

    ``depthwise_weight`` [C,1,3,3] and ``pointwise_weight`` [F,C,1,1] are
    PyTorch conv layouts.  :meth:`fused` runs the layer with its BatchNorm
    and ReLUs through the fused kernel (``ops/sepconv.py``) — the route of
    ``layers.py:88-103`` in the JAX package; ``forward`` is the plain
    grouped-conv route.  Both read the same parameters."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.depthwise_weight = nn.Parameter(torch.empty(in_channels, 1, 3, 3))
        self.pointwise_weight = nn.Parameter(
            torch.empty(features, in_channels, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.depthwise_weight, padding=1, groups=x.shape[1])
        return conv2d(y, self.pointwise_weight)

    def fused_operands(self, scale: torch.Tensor, shift: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
        """The kernel's operands for this layer and the BatchNorm affine
        ``scale``/``shift``, in the dtypes and layouts it takes: bf16 taps
        [3,3,C] and pointwise [C,F], f32 scale and shift [F], contiguous,
        so ``fused_sepconv`` casts and copies none of them."""
        c = self.depthwise_weight.shape[0]
        f = self.pointwise_weight.shape[0]
        bf, f32 = torch.bfloat16, torch.float32
        return (depthwise_taps(self.depthwise_weight).to(bf).contiguous(),
                self.pointwise_weight.reshape(f, c).t().to(bf).contiguous(),
                scale.to(f32).contiguous(), shift.to(f32).contiguous())

    def fused(self, x: torch.Tensor, operands: Tuple[torch.Tensor, ...],
              pre_relu: bool = False, post_relu: bool = False,
              row_tile: Optional[int] = None) -> torch.Tensor:
        """``post_relu?(BN(self(pre_relu?(x))))`` in one kernel; bf16 out.
        ``operands`` are :meth:`fused_operands`' (the model caches them per
        weights version); ``row_tile`` takes the tiled kernel
        (``fused_sepconv``)."""
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
        y = fused_sepconv(nhwc, *operands, pre_relu=pre_relu,
                          post_relu=post_relu, row_tile=row_tile)
        return y.permute(0, 3, 1, 2)


class DepthwiseConv2D(nn.Module):
    """Depthwise conv, multiplier 1 (``keras.layers.DepthwiseConv2D``):
    a square window of ``kernel_size`` 3 or 5, stride 1 SAME or stride 2
    VALID (the models zero-pad before it: MobileNetV2 ((0,1),(0,1)),
    EfficientNetB0 :func:`correct_pad`), without a bias (neither model's
    depthwise layers have one).

    ``depthwise_weight`` [C,1,k,k] is the grouped-conv layout of keras'
    ``depthwise_kernel`` [k,k,C,1] (:func:`depthwise_taps` gives a 3x3's
    kernels' [3,3,C])."""

    def __init__(self, channels: int, stride: int = 1, kernel_size: int = 3):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 (SAME) or 2 (VALID), got "
                             f"{stride}")
        if kernel_size not in (3, 5):
            raise ValueError(f"kernel_size must be 3 or 5, got {kernel_size}")
        self.stride = stride
        self.depthwise_weight = nn.Parameter(
            torch.empty(channels, 1, kernel_size, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.depthwise_weight.shape[-1]
        return conv2d(x, self.depthwise_weight, stride=self.stride,
                      padding=k // 2 if self.stride == 1 else 0,
                      groups=x.shape[1])


class SpaceToDepthConv(nn.Conv2d):
    """Bias-free stride-``s`` VALID conv computed as space-to-depth + a
    stride-1 conv (``layers.py SpaceToDepthConv`` of the JAX package):
    the same ``weight`` as the ``nn.Conv2d`` it subclasses, the same
    function.  Each s x s block of pixels becomes channels in the order
    ``(dy*s + dx)*cin + c`` (not ``F.pixel_unshuffle``'s ``c*s*s + dy*s +
    dx``), and the kernel, zero-padded to a multiple of the stride, is
    re-blocked to that order.  Odd extents are zero-padded, which is exact
    since the padded taps meet zero kernel rows; the output is sliced to
    the plain conv's ``(h - kh)//s + 1`` rows and columns."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int]):
        super().__init__(in_channels, features, kernel_size, stride,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight = promote(x, self.weight)
        kh, kw = self.kernel_size
        bh, bw = self.stride
        n, cin, h, w = x.shape
        f = weight.shape[0]
        hp, wp = -(-h // bh) * bh, -(-w // bw) * bw
        khp, kwp = -(-kh // bh) * bh, -(-kw // bw) * bw
        xs = F.pad(x, (0, wp - w, 0, hp - h)).reshape(
            n, cin, hp // bh, bh, wp // bw, bw).permute(
            0, 3, 5, 1, 2, 4).reshape(n, bh * bw * cin, hp // bh, wp // bw)
        # k2[o, (dy*bw+dx)*cin+c, by, bx] = k[o, c, by*bh+dy, bx*bw+dx]
        k2 = F.pad(weight, (0, kwp - kw, 0, khp - kh)).reshape(
            f, cin, khp // bh, bh, kwp // bw, bw).permute(
            0, 3, 5, 1, 2, 4).reshape(f, bh * bw * cin, khp // bh, kwp // bw)
        out = F.conv2d(xs, k2)
        return out[:, :, :(h - kh) // bh + 1, :(w - kw) // bw + 1]


class ConvBN(nn.Module):
    """``conv2d_bn`` of keras' InceptionV3 (``layers.py ConvBN`` of the JAX
    package): bias-free conv, BatchNorm without a scale (eps 1e-3), ReLU.
    ``padding`` is "SAME" or "VALID"; every SAME conv of InceptionV3 has
    stride 1 and an odd window, so its pad is symmetric.  ``s2d`` computes
    a VALID conv as :class:`SpaceToDepthConv` (the same ``weight``).
    Submodules ``conv`` and ``bn`` carry the JAX names."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: str = "SAME",
                 s2d: bool = False):
        super().__init__()
        kh, kw = kernel_size
        if padding == "SAME" and (stride != (1, 1) or not kh % 2 or
                                  not kw % 2):
            raise ValueError("SAME needs stride 1 and an odd window here")
        if s2d and padding != "VALID":
            raise ValueError("s2d requires VALID padding")
        self.padding = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
        self.conv = (SpaceToDepthConv(in_channels, features, kernel_size,
                                      stride) if s2d
                     else nn.Conv2d(in_channels, features, kernel_size,
                                    stride, bias=False))
        self.bn = BatchNorm(features, scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.conv, SpaceToDepthConv):
            y = self.conv(x)
        else:
            y = conv2d(x, self.conv.weight, stride=self.conv.stride,
                       padding=self.padding)
        return torch.relu(self.bn(y))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(kernel OIHW, bn scale', bn shift') for a parent-level fused
        conv (the JAX ``ConvBN(fold=True)`` form), from the same tensors."""
        return (self.conv.weight,) + self.bn.folded()


def max_pool_valid(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(..., padding="VALID")`` on NCHW."""
    return F.max_pool2d(x, window, stride)


def avg_pool_same(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Stride-1 SAME average pool that leaves the padding out of the
    divisor (TF's AvgPool, flax's ``count_include_pad=False``), in x's
    dtype.  With stride 1 and an odd window the SAME pad is symmetric."""
    return F.avg_pool2d(x, window, 1, padding=window // 2,
                        count_include_pad=False)


def grad_needed(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether autograd records a forward of ``module`` on ``x``: grad
    mode is on and ``x`` or a parameter of ``module`` requires grad.  The
    fused routes are not taken then: their folds are made without autograd
    (``cached_fold``) and the fused kernels have no backward, so a
    gradient would stop there without a word."""
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(p.requires_grad
                                  for p in module.parameters())


def cached_fold(cache: dict, name: str, sources, fold):
    """``fold()``'s result, computed again only when a tensor of
    ``sources`` changed: another storage, an in-place write, another dtype
    or device.  ``cache[name]`` keeps the ``(data_ptr, _version)`` of every
    source beside the result, and the sources themselves, so a storage it
    was keyed on is not freed and reused under the same address.  A write
    through ``.data`` moves no version counter: clear the cache after one.
    An inference tensor keeps no version counter, so nothing is cached for
    one.  A fold never runs during a CUDA-graph capture (it raises): the
    engine's eager warm-up fills the cache first."""
    try:
        key = [(s.data_ptr(), s._version) for s in sources]
    except RuntimeError:
        key = None
    else:
        key.append((sources[0].dtype, sources[0].device))
    hit = cache.get(name)
    if key is not None and hit is not None and hit[0] == key:
        return hit[2]
    if sources[0].is_cuda and torch.cuda.is_current_stream_capturing():
        # a fold made now would live in the graph's private pool and hold
        # its values only during replays; the engine warms up eagerly first
        raise RuntimeError(f"fold {name!r} computed during CUDA-graph "
                           f"capture: the weights changed after the warm-up")
    with torch.no_grad():
        ops = fold()
    if key is not None:
        cache[name] = (key, [s.detach() for s in sources], ops)
    return ops


def fold_bn_into_conv(kernel: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor,
                      bias: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm affine into a conv, as the JAX
    package's ``fold_bn_into_conv``: ``(conv(x, k) + b) * s + t ==
    conv(x, k*s) + (b*s + t)``.  ``kernel`` has its output channels LAST
    (keras' layouts: [3,3,C] depthwise, [C,F] pointwise).  The fold runs in
    f32 and K is cast back to the kernel's dtype, so a bf16 engine stays
    bf16; B is f32 for the caller to cast at the add."""
    f32 = torch.float32
    k = (kernel.to(f32) * scale.to(f32)).to(kernel.dtype)
    if bias is None:
        return k, shift.to(f32)
    return k, bias.to(f32) * scale.to(f32) + shift.to(f32)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype of ``x`` and the weights."""
    x, w = promote(x, layer.weight)
    b = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, w, b)
