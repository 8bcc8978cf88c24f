"""ResNet50/101/152 as PyTorch modules (port of ``sparkdl_tpu/models/resnet.py``).

Architecture and layer names mirror ``keras.applications`` ResNet50 and the
JAX module: v1 bottleneck blocks with the stride on the first 1x1 conv,
biased convs, BatchNorm eps 1.001e-5, an explicit 3-pad before the 7x7/2
stem conv and a 3x3/2 max pool over a 1-pad of -inf.  Each block registers
as ``conv{stage}_block{b}`` with its units under the Keras names
(``conv2_block1_0_conv``, ``conv2_block1_1_bn``, ...), the JAX tree's
nesting, so ``models/convert.py`` maps it by path and the Keras importer
matches each unit by name.  ResNet101/152 are the same module with deeper
stage tables.  Featurizer cut = global average pool (2048-d).  The forward
takes NHWC ``[B,H,W,3]`` like the JAX module and runs NCHW in
``channels_last`` memory inside.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.models.layers import (BatchNorm, cached_fold, conv2d,
                                             grad_needed,
                                             fold_bn_into_conv,
                                             global_avg_pool, linear)

BN_EPS = 1.001e-5

# (filters, blocks, first stride) per stage, keras stack order
RESNET_STAGES = {
    50: ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)),
    101: ((64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2)),
    152: ((64, 3, 1), (128, 8, 2), (256, 36, 2), (512, 3, 2)),
}


class Bottleneck(nn.Module):
    """Keras ``residual_block_v1``: 1x1 (stride) -> 3x3 -> 1x1 with a
    projected shortcut in a stage's first block, the identity elsewhere.

    ``forward(x, fused_shortcut=True)`` runs a projecting block's shortcut
    and reduce 1x1 convs, which read the same input at the same stride, as
    ONE conv: both BatchNorms folded into their kernels and biases, the
    kernels concatenated along output channels, then split (the JAX
    module's fused-shortcut route, ``resnet.py:51-78``).  The concatenated
    (K, B) are folded once per weights version (``layers.cached_fold``),
    so ``load_state_dict``, an in-place edit and ``.to()`` refold; after a
    write through ``.data`` clear ``_folds``."""

    def __init__(self, prefix: str, cin: int, filters: int, stride: int,
                 conv_shortcut: bool):
        super().__init__()
        self.prefix = prefix
        self.stride = stride
        self.conv_shortcut = conv_shortcut
        self._folds = {}
        self.f4 = f4 = 4 * filters

        def unit(i, c_in, c_out, k, s):
            self.add_module(f"{prefix}_{i}_conv",
                            nn.Conv2d(c_in, c_out, k, s, padding=k // 2))
            self.add_module(f"{prefix}_{i}_bn", BatchNorm(c_out, eps=BN_EPS))

        if conv_shortcut:
            unit(0, cin, f4, 1, stride)
        unit(1, cin, filters, 1, stride)
        unit(2, filters, filters, 3, 1)
        unit(3, filters, f4, 1, 1)

    def _conv_bn(self, x: torch.Tensor, i: int) -> torch.Tensor:
        conv = self._modules[f"{self.prefix}_{i}_conv"]
        y = conv2d(x, conv.weight, stride=conv.stride,
                   padding=conv.padding, bias=conv.bias)
        return self._modules[f"{self.prefix}_{i}_bn"](y)

    def _fold_shortcut(self):
        """(K [4F+F, C, 1, 1] in the kernels' dtype, B [4F+F] f32): the
        shortcut's and the reduce conv's BatchNorms folded into their
        kernels and biases, concatenated in that order."""
        ks, bs = [], []
        for i in (0, 1):
            conv = self._modules[f"{self.prefix}_{i}_conv"]
            w = conv.weight
            s, t = self._modules[f"{self.prefix}_{i}_bn"].folded()
            k, b = fold_bn_into_conv(w.reshape(w.shape[0], w.shape[1]).t(),
                                     s, t, bias=conv.bias)
            ks.append(k)
            bs.append(b)
        K = torch.cat(ks, dim=1)
        return (K.t().reshape(K.shape[1], K.shape[0], 1, 1).contiguous(),
                torch.cat(bs))

    def _shortcut_operands(self):
        m = self._modules
        sources = []
        for i in (0, 1):
            conv, bn = m[f"{self.prefix}_{i}_conv"], m[f"{self.prefix}_{i}_bn"]
            sources += [conv.weight, conv.bias, bn.weight, bn.bias,
                        bn.running_mean, bn.running_var]
        return cached_fold(self._folds, "shortcut", sources,
                           self._fold_shortcut)

    def forward(self, x: torch.Tensor, fused_shortcut: bool = False
                ) -> torch.Tensor:
        if self.conv_shortcut and fused_shortcut and not self.training:
            K, B = self._shortcut_operands()
            # the conv in the kernels' dtype, B cast at the add, then x's
            # dtype (the JAX rounding points)
            z = F.conv2d(x.to(K.dtype), K, stride=self.stride)
            z = (z + B.to(z.dtype).reshape(1, -1, 1, 1)).to(x.dtype)
            shortcut = z[:, :self.f4]
            y = torch.relu(z[:, self.f4:])
        else:
            shortcut = self._conv_bn(x, 0) if self.conv_shortcut else x
            y = torch.relu(self._conv_bn(x, 1))
        y = torch.relu(self._conv_bn(y, 2))
        y = self._conv_bn(y, 3)
        return torch.relu(shortcut + y)


class ResNet50(nn.Module):
    """Also ResNet101/152 through ``stages`` (the Keras layer names do not
    depend on the depth).  ``fused_shortcut`` runs each projecting block's
    shortcut and reduce convs as one at inference (:class:`Bottleneck`);
    off by default, as in JAX, and the registry builder reads
    ``SPARKDL_RN_FUSED_SHORTCUT``.  ``fused_inference`` is another name for
    it, the route toggle every zoo model has."""

    def __init__(self, num_classes: int = 1000,
                 stages: Tuple[Tuple[int, int, int], ...] = RESNET_STAGES[50],
                 fused_shortcut: bool = False):
        super().__init__()
        self.fused_shortcut = fused_shortcut
        self.conv1_conv = nn.Conv2d(3, 64, 7, 2, padding=3)
        self.conv1_bn = BatchNorm(64, eps=BN_EPS)
        cin = 64
        for stage, (filters, blocks, stride) in enumerate(stages, 2):
            for b in range(1, blocks + 1):
                name = f"conv{stage}_block{b}"
                self.add_module(name, Bottleneck(
                    name, cin, filters, stride if b == 1 else 1,
                    conv_shortcut=b == 1))
                cin = 4 * filters
        self.predictions = nn.Linear(cin, num_classes)

    @property
    def fused_inference(self) -> bool:
        return self.fused_shortcut

    @fused_inference.setter
    def fused_inference(self, value: bool) -> None:
        self.fused_shortcut = value

    def forward(self, x: torch.Tensor, features: bool = False,
                logits: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = conv2d(x, self.conv1_conv.weight, stride=2, padding=3,
                   bias=self.conv1_conv.bias)
        x = torch.relu(self.conv1_bn(x))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        fused = bool(self.fused_shortcut) and not grad_needed(self, x)
        for block in self.children():
            if isinstance(block, Bottleneck):
                x = block(x, fused)
        x = global_avg_pool(x)  # 2048-d featurizer cut
        if features:
            return x
        x = linear(x, self.predictions)
        if logits:
            return x
        return torch.softmax(x, dim=-1)


def ResNet101(**kwargs) -> ResNet50:
    return ResNet50(stages=RESNET_STAGES[101], **kwargs)


def ResNet152(**kwargs) -> ResNet50:
    return ResNet50(stages=RESNET_STAGES[152], **kwargs)
