"""InceptionV3 as a PyTorch module (port of
``sparkdl_tpu/models/inception.py``) — the featurizer of the reference's
flagship transfer-learning recipe.

The architecture (94 conv+BN units, mixed0..mixed10) is declared ONCE as a
spec table, this module's own copy of the JAX one; the module's layers and
the Keras weight-import order are generated from it.  Each unit registers
as ``<unit>.conv`` / ``<unit>.bn`` under the JAX names, so
``models/convert.py`` maps the JAX variable tree by path.

Keras semantics: conv(no bias) + BN(scale=False, eps=1e-3) + ReLU;
average-pool branches leave the padding out of the divisor; featurizer cut
= global average pool (2048-d).  Every SAME op of the net is stride 1 with
an odd window (a symmetric pad) and every stride-2 op is VALID.  The
forward takes NHWC ``[B,H,W,3]`` like the JAX module and runs NCHW in
``channels_last`` memory inside.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from sparkdl_tpu_torch.models.layers import (ConvBN, avg_pool_same,
                                             cached_fold, conv2d, grad_needed,
                                             fold_bn_into_conv,
                                             global_avg_pool, linear,
                                             max_pool_valid)


class C(NamedTuple):
    """One conv2d_bn unit."""
    name: str
    filters: int
    kh: int
    kw: int
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"


class P(NamedTuple):
    """One pooling op."""
    kind: str  # "max" | "avg"
    window: int
    stride: int
    padding: str


Split = Tuple[str, list, list]               # ("split", ops_a, ops_b)
Op = Union[C, P, Split]
Block = Tuple[str, List[List[Op]]]           # ("mixed0", [branch_ops, ...])


def _c(name, f, kh, kw, s=1, p="SAME"):
    return C(name, f, kh, kw, (s, s), p)


def _mixed35(i: int, pool_filters: int) -> Block:
    n = f"mixed{i}"
    return (n, [
        [_c(f"{n}_b1x1", 64, 1, 1)],
        [_c(f"{n}_b5x5_1", 48, 1, 1), _c(f"{n}_b5x5_2", 64, 5, 5)],
        [_c(f"{n}_b3x3dbl_1", 64, 1, 1), _c(f"{n}_b3x3dbl_2", 96, 3, 3),
         _c(f"{n}_b3x3dbl_3", 96, 3, 3)],
        [P("avg", 3, 1, "SAME"), _c(f"{n}_bpool", pool_filters, 1, 1)],
    ])


def _mixed17(i: int, f: int) -> Block:
    n = f"mixed{i}"
    return (n, [
        [_c(f"{n}_b1x1", 192, 1, 1)],
        [_c(f"{n}_b7x7_1", f, 1, 1), _c(f"{n}_b7x7_2", f, 1, 7),
         _c(f"{n}_b7x7_3", 192, 7, 1)],
        [_c(f"{n}_b7x7dbl_1", f, 1, 1), _c(f"{n}_b7x7dbl_2", f, 7, 1),
         _c(f"{n}_b7x7dbl_3", f, 1, 7), _c(f"{n}_b7x7dbl_4", f, 7, 1),
         _c(f"{n}_b7x7dbl_5", 192, 1, 7)],
        [P("avg", 3, 1, "SAME"), _c(f"{n}_bpool", 192, 1, 1)],
    ])


def _mixed8x8(i: int) -> Block:
    n = f"mixed{i}"
    return (n, [
        [_c(f"{n}_b1x1", 320, 1, 1)],
        [_c(f"{n}_b3x3", 384, 1, 1),
         ("split",
          [_c(f"{n}_b3x3_1", 384, 1, 3)],
          [_c(f"{n}_b3x3_2", 384, 3, 1)])],
        [_c(f"{n}_b3x3dbl_1", 448, 1, 1), _c(f"{n}_b3x3dbl_2", 384, 3, 3),
         ("split",
          [_c(f"{n}_b3x3dbl_3", 384, 1, 3)],
          [_c(f"{n}_b3x3dbl_4", 384, 3, 1)])],
        [P("avg", 3, 1, "SAME"), _c(f"{n}_bpool", 192, 1, 1)],
    ])


# Full network in upstream source build order (keras inception_v3.py).
STEM: List[Op] = [
    _c("stem_conv1", 32, 3, 3, s=2, p="VALID"),
    _c("stem_conv2", 32, 3, 3, p="VALID"),
    _c("stem_conv3", 64, 3, 3),
    P("max", 3, 2, "VALID"),
    _c("stem_conv4", 80, 1, 1, p="VALID"),
    _c("stem_conv5", 192, 3, 3, p="VALID"),
    P("max", 3, 2, "VALID"),
]

BLOCKS: List[Block] = [
    _mixed35(0, 32),
    _mixed35(1, 64),
    _mixed35(2, 64),
    ("mixed3", [
        [_c("mixed3_b3x3", 384, 3, 3, s=2, p="VALID")],
        [_c("mixed3_b3x3dbl_1", 64, 1, 1), _c("mixed3_b3x3dbl_2", 96, 3, 3),
         _c("mixed3_b3x3dbl_3", 96, 3, 3, s=2, p="VALID")],
        [P("max", 3, 2, "VALID")],
    ]),
    _mixed17(4, 128),
    _mixed17(5, 160),
    _mixed17(6, 160),
    _mixed17(7, 192),
    ("mixed8", [
        [_c("mixed8_b3x3_1", 192, 1, 1),
         _c("mixed8_b3x3_2", 320, 3, 3, s=2, p="VALID")],
        [_c("mixed8_b7x7x3_1", 192, 1, 1), _c("mixed8_b7x7x3_2", 192, 1, 7),
         _c("mixed8_b7x7x3_3", 192, 7, 1),
         _c("mixed8_b7x7x3_4", 192, 3, 3, s=2, p="VALID")],
        [P("max", 3, 2, "VALID")],
    ]),
    _mixed8x8(9),
    _mixed8x8(10),
]


def _iter_convs(ops: Sequence[Op]):
    for op in ops:
        if isinstance(op, C):
            yield op
        elif isinstance(op, tuple) and op and op[0] == "split":
            yield from _iter_convs(op[1])
            yield from _iter_convs(op[2])


def inception_import_order():
    """(kind, port module path) in upstream creation order for the
    auto-named Conv2D / BatchNormalization layers (the JAX package's
    ``inception_import_order`` in port names).  Each conv2d_bn creates its
    Conv2D then its BatchNormalization, so per-kind creation order both
    equal spec order.  (The final "predictions" Dense is explicitly named
    upstream and matches by name instead.)"""
    order = []
    convs = list(_iter_convs(STEM))
    for _, branches in BLOCKS:
        for branch in branches:
            convs.extend(_iter_convs(branch))
    for c in convs:
        order.append(("conv", f"{c.name}.conv"))
        order.append(("bn", f"{c.name}.bn"))
    return order


def _head_branches(branches) -> List[int]:
    """Indices of a block's branches whose first op is a stride-1 1x1
    ConvBN: the ones a fused head starts."""
    return [bi for bi, br in enumerate(branches)
            if (isinstance(br[0], C) and br[0].kh == 1 and br[0].kw == 1
                and br[0].strides == (1, 1))]


class InceptionV3(nn.Module):
    """``s2d_stem``: compute ``stem_conv1`` (3x3/s2/VALID on the 3-channel
    input) as space-to-depth + a stride-1 conv (``layers.SpaceToDepthConv``):
    same variables, same function.  Off by default; the registry builder
    reads ``SPARKDL_S2D_STEM``.

    ``fused_heads``: at inference, in each mixed block the 2-3 branches
    whose first op is a stride-1 1x1 ConvBN (all reading the block input)
    start with ONE conv — kernels concatenated along output channels, each
    BatchNorm folded into its kernel and shift, one ReLU, then split in
    branch order.  None = on at inference (off in train mode), False =
    off; the registry builder reads ``SPARKDL_FUSED_HEADS``.  Both routes
    read the same parameters.  ``fused_inference`` is another name for it,
    the route toggle every zoo model has.

    The concatenated (K, T) of each block are folded once per weights
    version (``layers.cached_fold``, keyed as MobileNetV2 keys its folds),
    so ``load_state_dict``, an in-place edit and ``.to()`` refold."""

    def __init__(self, num_classes: int = 1000, s2d_stem: bool = False,
                 fused_heads: Optional[bool] = None):
        super().__init__()
        self.s2d_stem = s2d_stem
        self.fused_heads = fused_heads
        self._folds = {}

        def build(ops, cin):
            for op in ops:
                if isinstance(op, C):
                    self.add_module(op.name, ConvBN(
                        cin, op.filters, (op.kh, op.kw), op.strides,
                        op.padding, s2d=s2d_stem and op.name == "stem_conv1"))
                    cin = op.filters
                elif not isinstance(op, P):  # split: both arms read cin
                    cin = build(op[1], cin) + build(op[2], cin)
            return cin

        cin = build(STEM, 3)
        for _, branches in BLOCKS:
            # a pool keeps its input's channels
            cin = sum(build(br, cin) for br in branches)
        self.predictions = nn.Linear(cin, num_classes)

    @property
    def fused_inference(self) -> Optional[bool]:
        return self.fused_heads

    @fused_inference.setter
    def fused_inference(self, value: Optional[bool]) -> None:
        self.fused_heads = value

    def _use_fused_heads(self, x: torch.Tensor) -> bool:
        if self.training or grad_needed(self, x):
            return False
        return True if self.fused_heads is None else self.fused_heads

    def _fold_heads(self, heads: List[C]):
        """(K [C, sum F] in the kernels' dtype, T [sum F] f32) of a block's
        head units (``inception.py:233-246`` of the JAX package): each
        BatchNorm folded into its 1x1 kernel in f32, K cast back to the
        kernel's dtype, concatenated in branch order."""
        ks, ts = [], []
        for c0 in heads:
            w, s, t = self._modules[c0.name].folded()
            k, b = fold_bn_into_conv(w.reshape(w.shape[0], w.shape[1]).t(),
                                     s, t)
            ks.append(k)
            ts.append(b)
        K = torch.cat(ks, dim=1)
        return (K.t().reshape(K.shape[1], K.shape[0], 1, 1).contiguous(),
                torch.cat(ts))

    def _heads(self, name: str, heads: List[C]):
        """:meth:`_fold_heads`, folded again only when a tensor it reads
        changed."""
        sources = []
        for c0 in heads:
            unit = self._modules[c0.name]
            sources += [unit.conv.weight, unit.bn.bias,
                        unit.bn.running_mean, unit.bn.running_var]
        return cached_fold(self._folds, name, sources,
                           lambda: self._fold_heads(heads))

    def forward(self, x: torch.Tensor, features: bool = False,
                logits: bool = False) -> torch.Tensor:
        fuse = self._use_fused_heads(x)
        m = self._modules

        def run(x, ops):
            for op in ops:
                if isinstance(op, C):
                    x = m[op.name](x)
                elif isinstance(op, P):
                    x = (max_pool_valid(x, op.window, op.stride)
                         if op.kind == "max" else avg_pool_same(x, op.window))
                else:  # split: apply both arms to x, concat results
                    x = torch.cat([run(x, op[1]), run(x, op[2])], dim=1)
            return x

        def run_block(name, x, branches):
            head_idx = _head_branches(branches)
            starts = {}
            if fuse and len(head_idx) >= 2:
                heads = [branches[bi][0] for bi in head_idx]
                K, T = self._heads(name, heads)
                # the conv in the kernels' dtype, T cast to y's dtype at
                # the add, ReLU, then x's dtype (the JAX rounding points)
                y = conv2d(x.to(K.dtype), K)
                y = torch.relu(y + T.to(y.dtype).reshape(1, -1, 1, 1)
                               ).to(x.dtype)
                off = 0
                for bi, c0 in zip(head_idx, heads):
                    starts[bi] = y[:, off:off + c0.filters]
                    off += c0.filters
            outs = [run(starts[bi], br[1:]) if bi in starts else run(x, br)
                    for bi, br in enumerate(branches)]
            return torch.cat(outs, dim=1)

        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = run(x, STEM)
        for name, branches in BLOCKS:
            x = run_block(name, x, branches)
        x = global_avg_pool(x)  # 2048-d featurizer cut
        if features:
            return x
        x = linear(x, self.predictions)
        if logits:
            return x
        return torch.softmax(x, dim=-1)
