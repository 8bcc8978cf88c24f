"""Plain float32 building blocks of the benchmark's reference models.

Written from the Keras layer definitions the published models use, with
plain ``torch`` operations only: NCHW tensors, TF "SAME" / "VALID"
padding, inference BatchNorm with Keras' epsilon, average pools that leave
the padding out of the divisor.  Nothing here imports the program under
test.  The parameters are a flat ``{name: tensor}`` dict (the benchmark
makes it from the seed and hands the same dict to the program).

``quant`` (the control): a function every conv and dense layer applies to
its input and its weight before the product, to compute the reference in
a lower precision than the configuration states.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

BN_EPS = 1e-3  # keras.layers.BatchNormalization's default

# One parameter of a reference model: (name, shape, how it is drawn).
# Kinds: "fan_in" N(0, 1/fan_in) with fan_in the product of the shape
# past its first axis, "he" N(0, 2/fan_in) (a plain conv-BN-ReLU chain
# keeps its signal through the depth only so); "gamma" and "var"
# U(0.8, 1.2); "beta" and "mean" N(0, 0.05^2); "zero" zeros.
ParamSpec = Tuple[str, Tuple[int, ...], str]


def conv_specs(name: str, cin: int, cout: int, kh: int, kw: int,
               groups: int = 1, init: str = "fan_in") -> List[ParamSpec]:
    return [(name, (cout, cin // groups, kh, kw), init)]


def bn_specs(prefix: str, channels: int, scale: bool = True
             ) -> List[ParamSpec]:
    out = [(f"{prefix}.weight", (channels,), "gamma")] if scale else []
    return out + [(f"{prefix}.bias", (channels,), "beta"),
                  (f"{prefix}.running_mean", (channels,), "mean"),
                  (f"{prefix}.running_var", (channels,), "var")]


def dense_specs(prefix: str, cin: int, cout: int) -> List[ParamSpec]:
    return [(f"{prefix}.weight", (cout, cin), "fan_in"),
            (f"{prefix}.bias", (cout,), "zero")]


def tf_preprocess(x: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [N,H,W,3] -> float32 NCHW in [-1, 1] (Keras'
    ``preprocess_input`` in "tf" mode)."""
    return (x.to(torch.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)


def same_pad(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF "SAME": ceil(size / stride) outputs, the odd pad on the high
    side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    ph = same_pad(x.shape[2], kh, stride)
    pw = same_pad(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         padding: str = "same", groups: int = 1,
         quant: Quant = None) -> torch.Tensor:
    if padding == "same":
        x = _pad_same(x, w.shape[2], w.shape[3], stride)
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, stride=stride, groups=groups)


def batch_norm(x: torch.Tensor, p: Params, prefix: str) -> torch.Tensor:
    """Inference BatchNorm: (x - mean) / sqrt(var + eps) * gamma + beta;
    gamma is 1 where the layer has no scale."""
    shape = (1, -1, 1, 1)
    y = (x - p[f"{prefix}.running_mean"].reshape(shape)) * torch.rsqrt(
        p[f"{prefix}.running_var"].reshape(shape) + BN_EPS)
    gamma = p.get(f"{prefix}.weight")
    if gamma is not None:
        y = y * gamma.reshape(shape)
    return y + p[f"{prefix}.bias"].reshape(shape)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str) -> torch.Tensor:
    if padding == "same":
        x = _pad_same(x, window, window, stride, value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def avg_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 SAME average pool over the real pixels only (TF's
    AvgPool leaves the padding out of the divisor)."""
    return F.avg_pool2d(x, window, 1, padding=window // 2,
                        count_include_pad=False)


def dense(x: torch.Tensor, p: Params, prefix: str,
          quant: Quant = None) -> torch.Tensor:
    w = p[f"{prefix}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.t() + p[f"{prefix}.bias"]


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to e4m3's largest, 448), back in float32:
    the usual per-tensor fp8 recipe for a product's operands."""
    amax = t.abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
