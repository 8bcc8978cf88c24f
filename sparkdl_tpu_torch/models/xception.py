"""Xception as a PyTorch module (port of ``sparkdl_tpu/models/xception.py``).

Layer names mirror keras.applications.xception and the JAX module
("block1_conv1", "block4_sepconv1_bn", "shortcut13_conv", ...,
"predictions"), so ``models/convert.py`` maps the JAX variable tree by
path and the Keras importer matches by name; the four residual-shortcut
convs and BatchNorms are auto-named upstream and import by creation order
(:func:`xception_auto_order`).  Featurizer cut = global average pool (2048-d).  The forward takes
NHWC ``[B,H,W,3]`` like the JAX module and runs NCHW in ``channels_last``
memory inside.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from sparkdl_tpu_torch.models.layers import (BatchNorm, SeparableConv2D,
                                             cached_fold, conv2d, grad_needed,
                                             global_avg_pool, linear,
                                             max_pool_same, promote)

# (block index, filters) of the three entry-flow residual blocks.
_ENTRY_BLOCKS = ((2, 128), (3, 256), (4, 728))


def xception_auto_order():
    """(kind, port module path) creation-order import targets of the four
    auto-named residual-shortcut Conv2D / BatchNormalization pairs (the
    JAX package's ``xception_auto_order``)."""
    order = []
    for i in [b for b, _ in _ENTRY_BLOCKS] + [13]:
        order.append(("conv", f"shortcut{i}_conv"))
        order.append(("bn", f"shortcut{i}_bn"))
    return order


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pick_row_tile(h: int, w: int, channels: int) -> Optional[int]:
    """The JAX module's route rule, kept as is so the port fuses the same
    layers: a block whose padded-flat working set ((H+2) * round_up(W+2, 8)
    * C) exceeds 1.2M position-channels takes the tiled kernel (B3, only
    with ``tiled_entry``; the plain route otherwise); None = the
    whole-image kernel (B1).  At 299x299 that puts entry blocks 2-3 (147²,
    74²) on the tiled rule and block4, the middle flow, block13 and
    block14 on B1: 30 separable convs per forward, 34 with
    ``tiled_entry``."""
    if (h + 2) * _round_up(w + 2, 8) * channels <= 1_200_000:
        return None
    return 16


def _bn_sources(bn: BatchNorm) -> list:
    """The tensors a BatchNorm's folded affine comes from."""
    return [bn.weight, bn.bias, bn.running_mean, bn.running_var]


class Xception(nn.Module):
    """``fused_inference`` routes the separable convs (with their BN and
    ReLUs) through the fused kernel (``ops/sepconv.py``) in eval mode:
    None = auto (on when the input lies on a CUDA device), True = always
    (a CPU tensor takes the kernel's plain version — the parity tests'
    route), False = never.  ``tiled_entry`` also routes the entry blocks
    whose image is too large for the whole-image rule (147², 74² at 299)
    through the tiled kernel, as JAX's ``tiled_entry`` does; off by
    default, and the registry builder reads ``SPARKDL_XC_TILED``.  Both
    routes read the same parameters.

    The fused route folds once per weights version: ``_folds`` keeps each
    fused sepconv's kernel operands (bf16 taps and pointwise, f32 BatchNorm
    scale and shift, as ``fused_sepconv`` takes them) and each folded
    BatchNorm affine in the activations' dtype, keyed on the
    ``(data_ptr, _version)`` of the tensors they come from
    (``layers.cached_fold``), so ``load_state_dict``, in-place edits and
    ``.to()`` refold.  A write through ``.data`` moves no version counter:
    clear ``_folds`` after one (an engine's captured forward sees the
    cleared cache and is captured again; it holds the folds it reads until
    then)."""

    def __init__(self, num_classes: int = 1000,
                 fused_inference: Optional[bool] = None,
                 tiled_entry: bool = False):
        super().__init__()
        self.fused_inference = fused_inference
        self.tiled_entry = tiled_entry
        self._folds = {}

        def conv(name, cin, cout, k, stride):
            self.add_module(name, nn.Conv2d(cin, cout, k, stride, bias=False))
            self.add_module(f"{name}_bn", BatchNorm(cout))

        def sep(name, cin, cout):
            self.add_module(name, SeparableConv2D(cin, cout))
            self.add_module(f"{name}_bn", BatchNorm(cout))

        conv("block1_conv1", 3, 32, 3, 2)
        conv("block1_conv2", 32, 64, 3, 1)
        cin = 64
        for i, f in _ENTRY_BLOCKS:
            self.add_module(f"shortcut{i}_conv",
                            nn.Conv2d(cin, f, 1, 2, bias=False))
            self.add_module(f"shortcut{i}_bn", BatchNorm(f))
            sep(f"block{i}_sepconv1", cin, f)
            sep(f"block{i}_sepconv2", f, f)
            cin = f
        for i in range(5, 13):
            for j in (1, 2, 3):
                sep(f"block{i}_sepconv{j}", 728, 728)
        self.add_module("shortcut13_conv",
                        nn.Conv2d(728, 1024, 1, 2, bias=False))
        self.add_module("shortcut13_bn", BatchNorm(1024))
        sep("block13_sepconv1", 728, 728)
        sep("block13_sepconv2", 728, 1024)
        sep("block14_sepconv1", 1024, 1536)
        sep("block14_sepconv2", 1536, 2048)
        self.predictions = nn.Linear(2048, num_classes)

    def _use_fused(self, x: torch.Tensor) -> bool:
        if self.training or grad_needed(self, x):
            return False
        if self.fused_inference is not None:
            return self.fused_inference
        return x.is_cuda

    def _bn_affine(self, name: str, dtype: torch.dtype):
        """BatchNorm ``name``'s folded affine as [1,C,1,1] tensors in
        ``dtype`` (the JAX module's ``BNAffine``), folded once per weights
        version."""
        bn = self._modules[name]
        return cached_fold(
            self._folds, f"{name}:{dtype}", _bn_sources(bn),
            lambda: tuple(v.to(dtype).reshape(1, -1, 1, 1)
                          for v in bn.folded()))

    def _sep_operands(self, name: str):
        """Sepconv ``name``'s kernel operands with its BatchNorm folded in
        (``SeparableConv2D.fused_operands``), folded once per weights
        version."""
        conv, bn = self._modules[name], self._modules[f"{name}_bn"]
        return cached_fold(
            self._folds, name,
            [conv.depthwise_weight, conv.pointwise_weight] + _bn_sources(bn),
            lambda: conv.fused_operands(*bn.folded()))

    def forward(self, x: torch.Tensor, features: bool = False,
                logits: bool = False) -> torch.Tensor:
        fused = self._use_fused(x)
        m = self._modules
        relu = torch.relu

        def bn_act(x, name, act=False):
            """Inference BN; on the fused route the folded affine in x's
            dtype (the JAX module's ``BNAffine``)."""
            if fused:
                s, t = self._bn_affine(name, x.dtype)
                y = x * s + t
            else:
                y = m[name](x)
            return relu(y) if act else y

        def conv_bn(x, name, bn_name, act=False):
            y = conv2d(x, m[name].weight, stride=m[name].stride)
            return bn_act(y, bn_name, act)

        def sep(x, name, pre_relu=False, post_relu=False, kernel=False,
                row_tile=None):
            """sepconv + BN (+ its ReLUs); ``kernel`` takes the fused
            kernel (bf16 out; ``row_tile`` the tiled one), else the plain
            convs and ``bn_act``."""
            if kernel:
                return m[name].fused(x, self._sep_operands(name), pre_relu,
                                     post_relu, row_tile=row_tile)
            if pre_relu:
                x = relu(x)
            return bn_act(m[name](x), f"{name}_bn", act=post_relu)

        def add(a, b):
            # the kernel's bf16 output + an f32 stream is f32, as in JAX
            a, b = promote(a, b)
            return a + b

        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        # Entry flow: two plain convs (VALID, stride-2 first)
        x = conv_bn(x, "block1_conv1", "block1_conv1_bn", act=True)
        x = conv_bn(x, "block1_conv2", "block1_conv2_bn", act=True)

        # Entry-flow residual blocks (block2 has no leading relu — upstream
        # quirk preserved).
        for i, f in _ENTRY_BLOCKS:
            residual = conv_bn(x, f"shortcut{i}_conv", f"shortcut{i}_bn")
            h, w = x.shape[2], x.shape[3]
            tile = _pick_row_tile(h, w, max(x.shape[1], f))
            flat = fused and (tile is None or self.tiled_entry)
            x = sep(x, f"block{i}_sepconv1", pre_relu=i > 2, kernel=flat,
                    row_tile=tile)
            x = sep(x, f"block{i}_sepconv2", pre_relu=True, kernel=flat,
                    row_tile=tile)
            x = add(max_pool_same(x), residual)

        # Middle flow: 8 identity blocks of three sepconvs.
        h, w = x.shape[2], x.shape[3]
        mid = fused and _pick_row_tile(h, w, 728) is None
        for i in range(5, 13):
            residual = x
            for j in (1, 2, 3):
                x = sep(x, f"block{i}_sepconv{j}", pre_relu=True, kernel=mid)
            x = add(x, residual)

        # Exit flow
        residual = conv_bn(x, "shortcut13_conv", "shortcut13_bn")
        flat = mid and _pick_row_tile(h, w, 1024) is None
        x = sep(x, "block13_sepconv1", pre_relu=True, kernel=flat)
        x = sep(x, "block13_sepconv2", pre_relu=True, kernel=flat)
        x = add(max_pool_same(x), residual)

        flat = fused and _pick_row_tile(x.shape[2], x.shape[3], 2048) is None
        x = sep(x, "block14_sepconv1", post_relu=True, kernel=flat)
        x = sep(x, "block14_sepconv2", post_relu=True, kernel=flat)
        x = global_avg_pool(x)  # 2048-d featurizer cut
        if features:
            return x
        x = linear(x, self.predictions)
        if logits:
            return x
        return torch.softmax(x, dim=-1)
