"""Plain float32 Xception (Chollet, "Xception: Deep Learning with
Depthwise Separable Convolutions", arXiv:1610.02357; the layer graph of
Keras' ``applications/xception.py``), for the benchmark's output check.

Entry flow: two VALID 3x3 convs, then three residual blocks of two
separable convs and a SAME 3x3/2 max pool beside a 1x1/2 conv shortcut
(block 2 without the leading ReLU).  Middle flow: eight identity blocks
of three ReLU-sepconv-BN units.  Exit flow: a residual block to 1024
channels, two sepconv-BN-ReLU units to 2048, global average pool (the
featurizer cut), and the 1000-way dense softmax.  Parameter names are
Keras' layer names.
"""

from __future__ import annotations

from typing import List

import torch

from bench_port.reference.common import (Params, ParamSpec, Quant,
                                         batch_norm, bn_specs, conv,
                                         conv_specs, dense, dense_specs,
                                         max_pool, tf_preprocess)

ENTRY = ((2, 128), (3, 256), (4, 728))


def param_specs() -> List[ParamSpec]:
    specs: List[ParamSpec] = []

    def unit(name, bn, cin, cout, k):
        specs.extend(conv_specs(f"{name}.weight", cin, cout, k, k))
        specs.extend(bn_specs(bn, cout))

    def sep(name, cin, cout):
        specs.extend(conv_specs(f"{name}.depthwise_weight", cin, cin, 3, 3,
                                groups=cin))
        specs.extend(conv_specs(f"{name}.pointwise_weight", cin, cout, 1, 1))
        specs.extend(bn_specs(f"{name}_bn", cout))

    unit("block1_conv1", "block1_conv1_bn", 3, 32, 3)
    unit("block1_conv2", "block1_conv2_bn", 32, 64, 3)
    cin = 64
    for i, f in ENTRY:
        unit(f"shortcut{i}_conv", f"shortcut{i}_bn", cin, f, 1)
        sep(f"block{i}_sepconv1", cin, f)
        sep(f"block{i}_sepconv2", f, f)
        cin = f
    for i in range(5, 13):
        for j in (1, 2, 3):
            sep(f"block{i}_sepconv{j}", 728, 728)
    unit("shortcut13_conv", "shortcut13_bn", 728, 1024, 1)
    sep("block13_sepconv1", 728, 728)
    sep("block13_sepconv2", 728, 1024)
    sep("block14_sepconv1", 1024, 1536)
    sep("block14_sepconv2", 1536, 2048)
    specs.extend(dense_specs("predictions", 2048, 1000))
    return specs


def forward(p: Params, images: torch.Tensor, features: bool,
            quant: Quant = None) -> torch.Tensor:
    """uint8 RGB [N,299,299,3] -> [N,2048] features or [N,1000]
    probabilities."""
    relu = torch.relu

    def unit(x, name, bn, stride, padding):
        return batch_norm(conv(x, p[f"{name}.weight"], stride, padding,
                               quant=quant), p, bn)

    def sep(x, name):
        c = x.shape[1]
        x = conv(x, p[f"{name}.depthwise_weight"], 1, "same", groups=c,
                 quant=quant)
        x = conv(x, p[f"{name}.pointwise_weight"], 1, "same", quant=quant)
        return batch_norm(x, p, f"{name}_bn")

    x = tf_preprocess(images)
    x = relu(unit(x, "block1_conv1", "block1_conv1_bn", 2, "valid"))
    x = relu(unit(x, "block1_conv2", "block1_conv2_bn", 1, "valid"))
    for i, _ in ENTRY:
        residual = unit(x, f"shortcut{i}_conv", f"shortcut{i}_bn", 2,
                        "same")
        x = sep(x if i == 2 else relu(x), f"block{i}_sepconv1")
        x = sep(relu(x), f"block{i}_sepconv2")
        x = max_pool(x, 3, 2, "same") + residual
    for i in range(5, 13):
        residual = x
        for j in (1, 2, 3):
            x = sep(relu(x), f"block{i}_sepconv{j}")
        x = x + residual
    residual = unit(x, "shortcut13_conv", "shortcut13_bn", 2, "same")
    x = sep(relu(x), "block13_sepconv1")
    x = sep(relu(x), "block13_sepconv2")
    x = max_pool(x, 3, 2, "same") + residual
    x = relu(sep(x, "block14_sepconv1"))
    x = relu(sep(x, "block14_sepconv2"))
    x = x.mean(dim=(2, 3))
    if features:
        return x
    return torch.softmax(dense(x, p, "predictions", quant=quant), dim=-1)
