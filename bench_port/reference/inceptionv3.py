"""Plain float32 InceptionV3 (Szegedy et al., "Rethinking the Inception
Architecture for Computer Vision", arXiv:1512.00567; the layer graph of
Keras' ``applications/inception_v3.py``), for the benchmark's output
check.

Every unit is Keras' ``conv2d_bn``: a bias-free conv, a BatchNorm without
a scale, ReLU; SAME unless the unit says VALID.  The stem, mixed0-2
(35x35), mixed3 (grid reduction), mixed4-7 (17x17, factorised 7x7),
mixed8 (grid reduction), mixed9-10 (8x8, expanded 3x3 splits), then the
global average pool (the featurizer cut, 2048 features) and the 1000-way
dense softmax.  Units are named ``<block>_<branch>`` and hold
``<unit>.conv.weight`` and ``<unit>.bn.*``.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from bench_port.reference.common import (Params, ParamSpec, Quant,
                                         avg_pool_same, batch_norm, bn_specs,
                                         conv, conv_specs, dense,
                                         dense_specs, max_pool, tf_preprocess)


def _graph(unit: Callable, pool: Callable, cat: Callable, x):
    """The network once, over three callbacks: ``unit(x, name, filters,
    kh, kw, stride, padding)``, ``pool(x, kind)`` ("max": 3x3/2 VALID;
    "avg": 3x3/1 SAME) and ``cat(list)``.  Walked with shapes to list the
    parameters and with tensors to run the forward."""
    x = unit(x, "stem_conv1", 32, 3, 3, 2, "valid")
    x = unit(x, "stem_conv2", 32, 3, 3, 1, "valid")
    x = unit(x, "stem_conv3", 64, 3, 3, 1, "same")
    x = pool(x, "max")
    x = unit(x, "stem_conv4", 80, 1, 1, 1, "valid")
    x = unit(x, "stem_conv5", 192, 3, 3, 1, "valid")
    x = pool(x, "max")

    for i, pool_filters in ((0, 32), (1, 64), (2, 64)):
        n = f"mixed{i}"
        b1 = unit(x, f"{n}_b1x1", 64, 1, 1, 1, "same")
        b5 = unit(x, f"{n}_b5x5_1", 48, 1, 1, 1, "same")
        b5 = unit(b5, f"{n}_b5x5_2", 64, 5, 5, 1, "same")
        b3 = unit(x, f"{n}_b3x3dbl_1", 64, 1, 1, 1, "same")
        b3 = unit(b3, f"{n}_b3x3dbl_2", 96, 3, 3, 1, "same")
        b3 = unit(b3, f"{n}_b3x3dbl_3", 96, 3, 3, 1, "same")
        bp = unit(pool(x, "avg"), f"{n}_bpool", pool_filters, 1, 1, 1, "same")
        x = cat([b1, b5, b3, bp])

    b3 = unit(x, "mixed3_b3x3", 384, 3, 3, 2, "valid")
    bd = unit(x, "mixed3_b3x3dbl_1", 64, 1, 1, 1, "same")
    bd = unit(bd, "mixed3_b3x3dbl_2", 96, 3, 3, 1, "same")
    bd = unit(bd, "mixed3_b3x3dbl_3", 96, 3, 3, 2, "valid")
    x = cat([b3, bd, pool(x, "max")])

    for i, f in ((4, 128), (5, 160), (6, 160), (7, 192)):
        n = f"mixed{i}"
        b1 = unit(x, f"{n}_b1x1", 192, 1, 1, 1, "same")
        b7 = unit(x, f"{n}_b7x7_1", f, 1, 1, 1, "same")
        b7 = unit(b7, f"{n}_b7x7_2", f, 1, 7, 1, "same")
        b7 = unit(b7, f"{n}_b7x7_3", 192, 7, 1, 1, "same")
        bd = unit(x, f"{n}_b7x7dbl_1", f, 1, 1, 1, "same")
        bd = unit(bd, f"{n}_b7x7dbl_2", f, 7, 1, 1, "same")
        bd = unit(bd, f"{n}_b7x7dbl_3", f, 1, 7, 1, "same")
        bd = unit(bd, f"{n}_b7x7dbl_4", f, 7, 1, 1, "same")
        bd = unit(bd, f"{n}_b7x7dbl_5", 192, 1, 7, 1, "same")
        bp = unit(pool(x, "avg"), f"{n}_bpool", 192, 1, 1, 1, "same")
        x = cat([b1, b7, bd, bp])

    b3 = unit(x, "mixed8_b3x3_1", 192, 1, 1, 1, "same")
    b3 = unit(b3, "mixed8_b3x3_2", 320, 3, 3, 2, "valid")
    b7 = unit(x, "mixed8_b7x7x3_1", 192, 1, 1, 1, "same")
    b7 = unit(b7, "mixed8_b7x7x3_2", 192, 1, 7, 1, "same")
    b7 = unit(b7, "mixed8_b7x7x3_3", 192, 7, 1, 1, "same")
    b7 = unit(b7, "mixed8_b7x7x3_4", 192, 3, 3, 2, "valid")
    x = cat([b3, b7, pool(x, "max")])

    for i in (9, 10):
        n = f"mixed{i}"
        b1 = unit(x, f"{n}_b1x1", 320, 1, 1, 1, "same")
        b3 = unit(x, f"{n}_b3x3", 384, 1, 1, 1, "same")
        b3 = cat([unit(b3, f"{n}_b3x3_1", 384, 1, 3, 1, "same"),
                  unit(b3, f"{n}_b3x3_2", 384, 3, 1, 1, "same")])
        bd = unit(x, f"{n}_b3x3dbl_1", 448, 1, 1, 1, "same")
        bd = unit(bd, f"{n}_b3x3dbl_2", 384, 3, 3, 1, "same")
        bd = cat([unit(bd, f"{n}_b3x3dbl_3", 384, 1, 3, 1, "same"),
                  unit(bd, f"{n}_b3x3dbl_4", 384, 3, 1, 1, "same")])
        bp = unit(pool(x, "avg"), f"{n}_bpool", 192, 1, 1, 1, "same")
        x = cat([b1, b3, bd, bp])
    return x


def param_specs() -> List[ParamSpec]:
    """Walks the graph with channel counts in place of tensors."""
    specs: List[ParamSpec] = []

    def unit(cin, name, filters, kh, kw, stride, padding):
        specs.extend(conv_specs(f"{name}.conv.weight", cin, filters, kh, kw,
                                init="he"))
        specs.extend(bn_specs(f"{name}.bn", filters, scale=False))
        return filters

    cout = _graph(unit, lambda c, kind: c, sum, 3)
    specs.extend(dense_specs("predictions", cout, 1000))
    return specs


def forward(p: Params, images: torch.Tensor, features: bool,
            quant: Quant = None) -> torch.Tensor:
    """uint8 RGB [N,299,299,3] -> [N,2048] features or [N,1000]
    probabilities."""

    def unit(x, name, filters, kh, kw, stride, padding):
        y = conv(x, p[f"{name}.conv.weight"], stride, padding, quant=quant)
        return torch.relu(batch_norm(y, p, f"{name}.bn"))

    def pool(x, kind):
        return (max_pool(x, 3, 2, "valid") if kind == "max"
                else avg_pool_same(x, 3))

    x = _graph(unit, pool, lambda xs: torch.cat(xs, dim=1),
               tf_preprocess(images))
    x = x.mean(dim=(2, 3))
    if features:
        return x
    return torch.softmax(dense(x, p, "predictions", quant=quant), dim=-1)
