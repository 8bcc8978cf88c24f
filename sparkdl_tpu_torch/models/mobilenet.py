"""MobileNetV2 (alpha 1.0, 224x224) as a PyTorch module (port of
``sparkdl_tpu/models/mobilenet.py``).

Layer names mirror ``keras.applications.MobileNetV2`` and the JAX module
("Conv1", "bn_Conv1", "expanded_conv_depthwise", "block_1_expand", ...,
"Conv_1", "Conv_1_bn", "predictions"), so ``models/convert.py`` maps the
JAX variable tree by path.  Keras' stride-2 stages zero-pad ((0,1),(0,1))
and then convolve VALID; reproduced as is.  BN epsilon 1e-3.  Featurizer
cut = global average pool (1280-d).  The forward takes NHWC ``[B,H,W,3]``
like the JAX module and runs NCHW in ``channels_last`` memory inside.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_tpu_torch.models.layers import (BatchNorm, DepthwiseConv2D,
                                             cached_fold, conv2d, grad_needed,
                                             depthwise_taps,
                                             fold_bn_into_conv,
                                             global_avg_pool, linear, relu6)
from sparkdl_tpu_torch.ops.sepconv import fused_mbconv

# (expansion t, out channels c, repeats n, first stride s) — table 2 of the
# MobileNetV2 paper, alpha=1.0.
_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
_BN_EPS = 1e-3
_BN_MOMENTUM = 0.001  # torch's convention: 1 - keras' 0.999


def _pad_correct(x: torch.Tensor) -> torch.Tensor:
    """Keras ``ZeroPadding2D(((0,1),(0,1)))`` on NCHW, before stride-2
    VALID convs."""
    return F.pad(x, (0, 1, 0, 1))


def _blocks():
    """(prefix, t, cin, c, stride) of the 17 inverted-residual blocks."""
    out, cin, block_id = [], 32, 0
    for t, c, n, s in _BLOCKS:
        for i in range(n):
            prefix = "expanded_conv" if block_id == 0 else f"block_{block_id}"
            out.append((prefix, t, cin, c, s if i == 0 else 1))
            cin = c
            block_id += 1
    return out


_BN_TENSORS = (("_parameters", "weight"), ("_parameters", "bias"),
               ("_buffers", "running_mean"), ("_buffers", "running_var"))


@functools.lru_cache(maxsize=None)
def _fold_sources(prefix: str, t: int):
    """(module name, the module's dict, key) of every tensor a stride-1
    block's folds read: each conv weight and each BatchNorm's four tensors,
    in a fixed order (read from the dicts, past ``nn.Module.__getattr__``,
    since the fused route looks them up on every forward)."""
    parts = ((("expand", "weight"), ("expand_BN", None)) if t != 1 else ()
             ) + (("depthwise", "depthwise_weight"), ("depthwise_BN", None),
                  ("project", "weight"), ("project_BN", None))
    spec = []
    for part, key in parts:
        name = f"{prefix}_{part}"
        spec += ([(name, d, k) for d, k in _BN_TENSORS] if key is None
                 else [(name, "_parameters", key)])
    return tuple(spec)


class MobileNetV2(nn.Module):
    """``fused_inference`` runs each stride-1 inverted-residual block's
    depthwise + BN + relu6 + project + BN tail as ONE kernel
    (``ops/sepconv.py fused_mbconv``, B2), with the expand 1x1 as a folded
    matmul in the working dtype before it — the JAX module's fused route,
    in eval mode only.  On a CPU tensor the kernel's plain version runs
    (the parity tests' route).  Off by default, as in JAX; the registry
    builder reads ``SPARKDL_MNV2_FUSED``.  Both routes read the same
    parameters.

    The fused route folds each block's BatchNorms into its weights once
    per weights version, not once per forward (JAX's compiled forward
    fuses the folds into one program; eagerly they are ~20 small launches
    a block): ``_folds`` keeps each block's folded operands beside the
    ``(data_ptr, _version)`` of every tensor they were folded from and the
    block's dtype and device, so ``load_state_dict``, an in-place edit and
    ``.to()`` all refold."""

    def __init__(self, num_classes: int = 1000, fused_inference: bool = False):
        super().__init__()
        self.fused_inference = fused_inference
        self._folds = {}

        def bn(name, f):
            self.add_module(name, BatchNorm(f, eps=_BN_EPS,
                                            momentum=_BN_MOMENTUM))

        self.add_module("Conv1", nn.Conv2d(3, 32, 3, 2, bias=False))
        bn("bn_Conv1", 32)
        for prefix, t, cin, c, stride in _blocks():
            cdw = cin * t
            if t != 1:
                self.add_module(f"{prefix}_expand",
                                nn.Conv2d(cin, cdw, 1, bias=False))
                bn(f"{prefix}_expand_BN", cdw)
            self.add_module(f"{prefix}_depthwise",
                            DepthwiseConv2D(cdw, stride))
            bn(f"{prefix}_depthwise_BN", cdw)
            self.add_module(f"{prefix}_project",
                            nn.Conv2d(cdw, c, 1, bias=False))
            bn(f"{prefix}_project_BN", c)
        self.add_module("Conv_1", nn.Conv2d(320, 1280, 1, bias=False))
        bn("Conv_1_bn", 1280)
        self.predictions = nn.Linear(1280, num_classes)

    def _fold(self, prefix: str, t: int, cin: int, c: int):
        """A stride-1 block's folded operands (``mobilenet.py:95-113`` of
        the JAX package): the expand kernel and its shift in the module's
        dtype (None for t == 1), then the tail's bf16 taps and projection
        and f32 shifts as ``fused_mbconv`` takes them, contiguous, so it
        casts and copies nothing."""
        m = self._modules
        bf, f32 = torch.bfloat16, torch.float32
        ke_ = be = None
        if t != 1:
            ke = m[f"{prefix}_expand"].weight
            se, te = m[f"{prefix}_expand_BN"].folded()
            ke_, be = fold_bn_into_conv(ke.reshape(cin * t, cin).t(), se, te)
            be = be.to(ke_.dtype)
        cdw = cin * t
        sd, td = m[f"{prefix}_depthwise_BN"].folded()
        kd, bd = fold_bn_into_conv(
            depthwise_taps(m[f"{prefix}_depthwise"].depthwise_weight), sd, td)
        sp, tp = m[f"{prefix}_project_BN"].folded()
        kp, bp = fold_bn_into_conv(
            m[f"{prefix}_project"].weight.reshape(c, cdw).t(), sp, tp)
        return (ke_, be, kd.to(bf).contiguous(), kp.to(bf).contiguous(),
                bd.to(f32).contiguous(), bp.to(f32).contiguous())

    def _folded(self, prefix: str, t: int, cin: int, c: int):
        """:meth:`_fold`'s operands, folded again only when a tensor they
        come from changed (``layers.cached_fold``)."""
        m = self._modules
        sources = [getattr(m[name], d)[k]
                   for name, d, k in _fold_sources(prefix, t)]
        return cached_fold(self._folds, prefix, sources,
                           lambda: self._fold(prefix, t, cin, c))

    def _fused_block(self, x: torch.Tensor, prefix: str, t: int, cin: int,
                     c: int) -> torch.Tensor:
        """One stride-1 block on the fused route (``mobilenet.py:81-118`` of
        the JAX package), in NHWC: folded expand matmul + relu6 in x's
        dtype, the tail through ``fused_mbconv`` (bf16 out, cast back to
        x's dtype), the residual added in that dtype when cin == c."""
        work_dt = x.dtype
        xh = x.permute(0, 2, 3, 1)  # NCHW (channels_last) -> NHWC view
        ke_, be, kd, kp, bd, bp = self._folded(prefix, t, cin, c)
        if t != 1:
            y = torch.matmul(xh.to(ke_.dtype), ke_)
            y = torch.clamp(y + be, 0.0, 6.0)
        else:
            y = xh
        out = fused_mbconv(y, kd, kp, bd, bp)
        # the residual add promotes the bf16 tail to x's dtype, as the cast
        # before it would: one launch for both
        out = xh + out if cin == c else out.to(work_dt)
        return out.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, features: bool = False,
                logits: bool = False) -> torch.Tensor:
        fused = (self.fused_inference and not self.training
                 and not grad_needed(self, x))
        m = self._modules

        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last)
        x = conv2d(_pad_correct(x), m["Conv1"].weight, stride=2)
        x = relu6(m["bn_Conv1"](x))
        for prefix, t, cin, c, stride in _blocks():
            if fused and stride == 1:
                x = self._fused_block(x, prefix, t, cin, c)
                continue
            inp = x
            if t != 1:
                x = conv2d(x, m[f"{prefix}_expand"].weight)
                x = relu6(m[f"{prefix}_expand_BN"](x))
            if stride == 2:
                x = _pad_correct(x)
            x = m[f"{prefix}_depthwise"](x)
            x = relu6(m[f"{prefix}_depthwise_BN"](x))
            x = conv2d(x, m[f"{prefix}_project"].weight)
            x = m[f"{prefix}_project_BN"](x)  # linear bottleneck
            if stride == 1 and cin == c:
                x = x + inp
        x = conv2d(x, m["Conv_1"].weight)
        x = relu6(m["Conv_1_bn"](x))
        x = global_avg_pool(x)  # 1280-d featurizer cut
        if features:
            return x
        x = linear(x, self.predictions)
        if logits:
            return x
        return torch.softmax(x, dim=-1)
