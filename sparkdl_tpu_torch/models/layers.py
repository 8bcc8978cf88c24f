"""Building blocks of the port's zoo (port of ``sparkdl_tpu/models/layers.py``).

Modules take NCHW tensors (PyTorch's logical layout); the model keeps them
in ``channels_last`` memory, so the NHWC view the fused kernel takes is the
same bytes.  Padding follows TF "SAME" (asymmetric where the window and
stride need it), as the Keras weights were trained under.  Where an input
and a weight differ in dtype, the op runs in the type JAX would promote
both to (flax promotes; ``F.conv2d`` raises on mixed types).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
           groups: int = 1) -> torch.Tensor:
    """Bias-free ``F.conv2d`` in the promoted dtype of ``x`` and ``weight``."""
    x, weight = promote(x, weight)
    return F.conv2d(x, weight, stride=stride, padding=padding, groups=groups)


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


class BatchNorm(nn.BatchNorm2d):
    """Keras-default inference BatchNorm (eps 1e-3) with the folded form of
    ``BNAffine`` beside it; both read the same four tensors."""

    def __init__(self, num_features: int, eps: float = BN_EPS_DEFAULT,
                 momentum: float = BN_MOMENTUM_DEFAULT):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale', shift') in f32: scale' = gamma / sqrt(var + eps),
        shift' = beta - mean * scale' — full precision even when the
        engine cast the module to bf16."""
        f32 = torch.float32
        s = self.weight.to(f32) / torch.sqrt(self.running_var.to(f32)
                                             + self.eps)
        t = self.bias.to(f32) - self.running_mean.to(f32) * s
        return s, t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = promote(x, self.weight)
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

    def fused(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              pre_relu: bool = False, post_relu: bool = False,
              row_tile: Optional[int] = None) -> torch.Tensor:
        """``post_relu?(BN(self(pre_relu?(x))))`` in one kernel; bf16 out.
        ``row_tile`` takes the tiled kernel (``fused_sepconv``)."""
        c = x.shape[1]
        f = self.pointwise_weight.shape[0]
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
        dwk = depthwise_taps(self.depthwise_weight)
        pw = self.pointwise_weight.reshape(f, c).t()
        y = fused_sepconv(nhwc, dwk, pw, scale, shift, pre_relu=pre_relu,
                          post_relu=post_relu, row_tile=row_tile)
        return y.permute(0, 3, 1, 2)


class DepthwiseConv2D(nn.Module):
    """Bias-free 3x3 depthwise conv, multiplier 1
    (``keras.layers.DepthwiseConv2D``): stride 1 SAME, or stride 2 VALID
    (MobileNetV2 zero-pads ((0,1),(0,1)) before it, in the model).

    ``depthwise_weight`` [C,1,3,3] is the grouped-conv layout of keras'
    ``depthwise_kernel`` [3,3,C,1] (:func:`depthwise_taps` gives the
    kernels' [3,3,C])."""

    def __init__(self, channels: int, stride: int = 1):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 (SAME) or 2 (VALID), got "
                             f"{stride}")
        self.stride = stride
        self.depthwise_weight = nn.Parameter(torch.empty(channels, 1, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.depthwise_weight, stride=self.stride,
                      padding=1 if self.stride == 1 else 0,
                      groups=x.shape[1])


def fold_bn_into_conv(kernel: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm affine into a bias-free conv, as the JAX
    package's ``fold_bn_into_conv``: ``conv(x, k) * s + t == conv(x, k*s)
    + t``.  ``kernel`` has its output channels LAST (keras' layouts: [3,3,C]
    depthwise, [C,F] pointwise).  The fold runs in f32 and K is cast back
    to the kernel's dtype, so a bf16 engine stays bf16; B is f32 for the
    caller to cast at the add."""
    f32 = torch.float32
    k = (kernel.to(f32) * scale.to(f32)).to(kernel.dtype)
    return k, shift.to(f32)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype of ``x`` and the weights."""
    x, w = promote(x, layer.weight)
    b = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, w, b)
