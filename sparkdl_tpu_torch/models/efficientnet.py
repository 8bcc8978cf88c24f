"""EfficientNetB0 as a PyTorch module (port of
``sparkdl_tpu/models/efficientnet.py``).

Layer names mirror ``keras.applications.EfficientNetB0`` and the JAX module
("stem_conv", "block1a_dwconv", "block2a_se_reduce", ..., "top_conv",
"predictions").  Keras folds the input pipeline into the model: ``x/255``,
a ``Normalization`` layer whose mean and variance ship as weights (here the
buffers of :class:`InputNorm`, the importer's "norm" kind; Keras auto-names
it, so it also imports by creation order) and, only in its ImageNet build, a
weightless ``Rescaling(1/sqrt(std))`` after it, which
:func:`efficientnet_import_fixup` reads into ``post_scale`` from the file's
model config.  The registry's preprocess mode is "none".  Stride-2 blocks
zero-pad with Keras' ``correct_pad`` and convolve VALID; activations are
SiLU; BatchNorm eps is the Keras default 1e-3.  Each block has
squeeze-and-excitation over its expanded channels.  The forward takes NHWC
``[B,H,W,3]`` like the JAX module and runs NCHW in ``channels_last``
memory inside.

``drop_connect_rate`` is the JAX module's stochastic depth on the residual
blocks in train mode: block i of 16 drops each sample's residual branch
with probability ``rate * i / 16`` and divides the survivors by the keep
probability.  The draws come from the module's ``generator`` (a
``torch.Generator``, which the caller seeds): they cannot match JAX's
``dropout`` rng bit for bit, so only rate 0 (the default) is held to JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.models.layers import (BatchNorm, DepthwiseConv2D,
                                             conv2d, correct_pad,
                                             global_avg_pool, linear)

# Per-stage (kernel, repeats, out_channels, expand_ratio, first_stride) —
# EfficientNet-B0 (width and depth multipliers 1.0).
_STAGES = ((3, 1, 16, 1, 1), (3, 2, 24, 6, 2), (5, 2, 40, 6, 2),
           (3, 3, 80, 6, 2), (5, 3, 112, 6, 1), (5, 4, 192, 6, 2),
           (3, 1, 320, 6, 1))
_SE_RATIO = 0.25


def _blocks():
    """(prefix, kernel, cin, cout, expand ratio, stride) of the 16 blocks."""
    out, cin = [], 32
    for stage, (k, repeats, c_out, t, s) in enumerate(_STAGES, 1):
        for rep in range(repeats):
            out.append((f"block{stage}{chr(ord('a') + rep)}", k, cin, c_out,
                        t, s if rep == 0 else 1))
            cin = c_out
    return out


class InputNorm(nn.Module):
    """Keras ``Normalization`` twin on NHWC: ``(x - mean) / sqrt(var) *
    post_scale`` per channel, the three as buffers the importer fills
    (``post_scale`` is 1 unless the Keras build carried the ImageNet
    ``Rescaling``)."""

    def __init__(self, channels: int = 3):
        super().__init__()
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.register_buffer("post_scale", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var) * self.post_scale


def efficientnet_import_fixup(layer_configs: Optional[Sequence],
                              sd: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """Set ``normalization.post_scale`` from the second ``Rescaling`` layer
    of the Keras model config (``(class_name, config)`` pairs in layer
    order), which only ImageNet builds have: its per-channel scale
    ``1/sqrt(IMAGENET_STDDEV_RGB)`` carries no weights, so the importer
    cannot see it (the JAX package's ``efficientnet_import_fixup`` reads it
    off the live Keras layer).  Without a config, or with one Rescaling,
    ``post_scale`` stays 1."""
    scales = [cfg["scale"] for cls, cfg in (layer_configs or ())
              if cls == "Rescaling"]
    if len(scales) < 2:
        return sd
    scale = np.asarray(scales[1], dtype=np.float32).reshape(-1)
    if scale.size == 1:
        scale = np.repeat(scale, 3)
    sd["normalization.post_scale"] = torch.from_numpy(scale)
    return sd


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (Keras' ``Dropout(noise_shape=(None, 1,
    1, 1))``): each sample of ``x`` is kept with probability ``1 - rate``
    and divided by it, or zeroed.  The mask is drawn on ``generator``'s
    device, then moved to ``x``'s."""
    if generator is None:
        raise ValueError(
            "drop_connect_rate > 0 in train mode needs the module's "
            "generator (a seeded torch.Generator), as the JAX module needs "
            "a 'dropout' rng")
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                   generator=generator, device=generator.device)
    mask = (u < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class EfficientNetB0(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 drop_connect_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_connect_rate = float(drop_connect_rate)
        self.generator = generator
        self.normalization = InputNorm()

        def bn(name, f):
            self.add_module(name, BatchNorm(f))

        def conv(name, cin, cout, k=1, stride=1, bias=False):
            self.add_module(name, nn.Conv2d(cin, cout, k, stride, bias=bias))

        conv("stem_conv", 3, 32, 3, 2)
        bn("stem_bn", 32)
        for prefix, k, cin, c_out, t, stride in _blocks():
            filters = cin * t
            if t != 1:
                conv(f"{prefix}_expand_conv", cin, filters)
                bn(f"{prefix}_expand_bn", filters)
            self.add_module(f"{prefix}_dwconv",
                            DepthwiseConv2D(filters, stride, kernel_size=k))
            bn(f"{prefix}_bn", filters)
            se_filters = max(1, int(cin * _SE_RATIO))
            conv(f"{prefix}_se_reduce", filters, se_filters, bias=True)
            conv(f"{prefix}_se_expand", se_filters, filters, bias=True)
            conv(f"{prefix}_project_conv", filters, c_out)
            bn(f"{prefix}_project_bn", c_out)
        conv("top_conv", 320, 1280)
        bn("top_bn", 1280)
        self.predictions = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor, features: bool = False,
                logits: bool = False) -> torch.Tensor:
        m = self._modules

        def pointwise(x, name):
            return conv2d(x, m[name].weight, bias=m[name].bias)

        # x/255 in the input's own float dtype (a bf16 engine stays bf16)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        x = self.normalization(x / 255.0)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = conv2d(correct_pad(x, 3), m["stem_conv"].weight, stride=2)
        x = F.silu(m["stem_bn"](x))
        blocks = _blocks()
        for i, (prefix, k, cin, c_out, t, stride) in enumerate(blocks):
            inp = x
            if t != 1:
                x = F.silu(m[f"{prefix}_expand_bn"](
                    pointwise(x, f"{prefix}_expand_conv")))
            if stride == 2:
                x = correct_pad(x, k)
            x = F.silu(m[f"{prefix}_bn"](m[f"{prefix}_dwconv"](x)))
            se = x.mean(dim=(2, 3), keepdim=True)
            se = F.silu(pointwise(se, f"{prefix}_se_reduce"))
            se = pointwise(se, f"{prefix}_se_expand")
            x = x * torch.sigmoid(se)
            x = m[f"{prefix}_project_bn"](
                pointwise(x, f"{prefix}_project_conv"))
            if stride == 1 and cin == c_out:
                drop = self.drop_connect_rate * i / len(blocks)
                if self.training and drop > 0:
                    x = drop_connect(x, drop, self.generator)
                x = x + inp
        x = F.silu(m["top_bn"](pointwise(x, "top_conv")))
        x = global_avg_pool(x)  # 1280-d featurizer cut
        if features:
            return x
        x = linear(x, self.predictions)
        if logits:
            return x
        return torch.softmax(x, dim=-1)
