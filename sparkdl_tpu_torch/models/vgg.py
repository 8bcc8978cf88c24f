"""VGG16 / VGG19 as PyTorch modules (port of ``sparkdl_tpu/models/vgg.py``).

Layer names match ``keras.applications.vgg16``/``vgg19`` and the JAX module
("block1_conv1", ..., "fc1", "fc2", "predictions"), so ``models/convert.py``
maps the JAX tree by path and the Keras importer matches by name.  The
featurizer cut is ``fc2`` (4096-d), as the reference's
``DeepImageFeaturizer`` cuts VGG.  The forward takes NHWC ``[B,H,W,3]``
like the JAX module and runs NCHW in ``channels_last`` memory inside.

``fc1``'s rows follow Keras' flatten, which is channel-last row-major
(H, W, C): the forward flattens the NHWC view of the last pool, a free
view in ``channels_last`` memory; the weight is used as imported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.models.layers import conv2d, linear, max_pool_valid

# convs per block: VGG16 = [2,2,3,3,3], VGG19 = [2,2,4,4,4]
_VGG16_BLOCKS: Tuple[int, ...] = (2, 2, 3, 3, 3)
_VGG19_BLOCKS: Tuple[int, ...] = (2, 2, 4, 4, 4)
_BLOCK_FILTERS: Tuple[int, ...] = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """Shared VGG backbone and classifier head.  ``input_size`` (H, W) sets
    ``fc1``'s input width: the five 2x2 VALID pools leave
    ``(H // 32) x (W // 32)`` positions of 512 channels."""

    def __init__(self, blocks: Tuple[int, ...], num_classes: int = 1000,
                 input_size: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.blocks = blocks
        cin = 3
        for b, (n_convs, filters) in enumerate(zip(blocks, _BLOCK_FILTERS), 1):
            for c in range(1, n_convs + 1):
                self.add_module(f"block{b}_conv{c}",
                                nn.Conv2d(cin, filters, 3, padding=1))
                cin = filters
        h, w = input_size
        for _ in blocks:
            h, w = h // 2, w // 2
        self.fc1 = nn.Linear(h * w * cin, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.predictions = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor, features: bool = False,
                logits: bool = False) -> torch.Tensor:
        m = self._modules
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        for b, n_convs in enumerate(self.blocks, 1):
            for c in range(1, n_convs + 1):
                conv = m[f"block{b}_conv{c}"]
                x = torch.relu(conv2d(x, conv.weight, padding=1,
                                      bias=conv.bias))
            x = max_pool_valid(x, 2, 2)
        # Keras' flatten: channel-last row-major (H, W, C)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(linear(x, self.fc1))
        x = F.relu(linear(x, self.fc2))
        if features:
            return x  # 4096-d penultimate activations (featurizer cut)
        x = linear(x, self.predictions)
        if logits:
            return x
        return torch.softmax(x, dim=-1)


def VGG16(**kwargs) -> VGG:
    return VGG(_VGG16_BLOCKS, **kwargs)


def VGG19(**kwargs) -> VGG:
    return VGG(_VGG19_BLOCKS, **kwargs)
