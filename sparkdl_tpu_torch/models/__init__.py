"""Pretrained-CNN zoo registry (port of ``sparkdl_tpu/models/__init__.py``).

The port's zoo holds InceptionV3, Xception and MobileNetV2 so far.  Each
``ModelSpec`` carries what the transformer layer needs: input size,
featurizer-cut width, ImageNet preprocess mode and the module builder.
Weights are a seeded random init at full width; importing Keras ``.h5``
weights is not ported yet.

The builders read process env, as in JAX: ``SPARKDL_XC_TILED=1`` routes
Xception's large entry blocks through the tiled kernel,
``SPARKDL_MNV2_FUSED=1`` MobileNetV2's stride-1 blocks through the mbconv
kernel (both off by default); ``SPARKDL_S2D_STEM=1`` computes
InceptionV3's first conv as space-to-depth (off by default) and
``SPARKDL_FUSED_HEADS=0`` turns its fused branch heads off (on by
default).  Caches keyed on a model name fold in :func:`model_variant_key`
so a knob set mid-process builds the other variant instead of serving the
cached one.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from sparkdl_tpu_torch.models.inception import InceptionV3
from sparkdl_tpu_torch.models.layers import (BatchNorm, DepthwiseConv2D,
                                             SeparableConv2D)
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
from sparkdl_tpu_torch.models.preprocess import get_preprocess_fn
from sparkdl_tpu_torch.models.xception import Xception


@dataclass(frozen=True)
class ModelSpec:
    """One zoo entry: everything needed to featurize/predict with the model."""

    name: str
    module_builder: Callable[..., nn.Module]
    input_size: Tuple[int, int]                # (height, width)
    feature_size: int                          # featurizer-cut dimensionality
    preprocess_mode: str                       # see models.preprocess
    # () -> str tag when module_builder reads process env; caches keyed on
    # the model name fold it in (model_variant_key)
    variant_key_fn: Optional[Callable[[], str]] = None

    @property
    def preprocess(self):
        return get_preprocess_fn(self.preprocess_mode)

    def build(self, **kwargs) -> nn.Module:
        return self.module_builder(**kwargs)


def _env_flag(name: str, default: bool) -> bool:
    """Truthy env knob, read as the JAX package reads it: unset or empty ->
    ``default``; "0"/"false" (any case) -> False; anything else -> True."""
    raw = os.environ.get(name, "").lower()
    if raw == "":
        return default
    return raw not in ("0", "false")


def _xc_tiled_enabled() -> bool:
    return _env_flag("SPARKDL_XC_TILED", False)


def _mnv2_fused_enabled() -> bool:
    return _env_flag("SPARKDL_MNV2_FUSED", False)


def _s2d_stem_enabled() -> bool:
    return _env_flag("SPARKDL_S2D_STEM", False)


def _fused_heads_enabled() -> bool:
    return _env_flag("SPARKDL_FUSED_HEADS", True)


def _inception_builder(**kwargs) -> nn.Module:
    return InceptionV3(s2d_stem=_s2d_stem_enabled(),
                       fused_heads=None if _fused_heads_enabled() else False,
                       **kwargs)


def _inception_variant() -> str:
    tags = []
    if _s2d_stem_enabled():
        tags.append("s2d")
    if not _fused_heads_enabled():
        tags.append("nofh")
    return "+".join(tags)


def _xception_builder(**kwargs) -> nn.Module:
    return Xception(tiled_entry=_xc_tiled_enabled(), **kwargs)


def _mobilenet_builder(**kwargs) -> nn.Module:
    return MobileNetV2(fused_inference=_mnv2_fused_enabled(), **kwargs)


_SPECS = {
    "inceptionv3": ModelSpec(
        name="InceptionV3", module_builder=_inception_builder,
        input_size=(299, 299), feature_size=2048, preprocess_mode="tf",
        variant_key_fn=_inception_variant),
    "xception": ModelSpec(
        name="Xception", module_builder=_xception_builder,
        input_size=(299, 299), feature_size=2048, preprocess_mode="tf",
        variant_key_fn=lambda: "tiled" if _xc_tiled_enabled() else ""),
    "mobilenetv2": ModelSpec(
        name="MobileNetV2", module_builder=_mobilenet_builder,
        input_size=(224, 224), feature_size=1280, preprocess_mode="tf",
        variant_key_fn=lambda: "fused" if _mnv2_fused_enabled() else ""),
}

SUPPORTED_MODELS = sorted(s.name for s in _SPECS.values())


def get_model_spec(name: str) -> ModelSpec:
    spec = _SPECS.get(name.lower())
    if spec is None:
        raise ValueError(
            f"Unknown model {name!r}; supported: {SUPPORTED_MODELS}")
    return spec


def model_variant_key(name: str) -> str:
    """The env-dependent build-variant tag of ``name`` ("" for the default
    build); caches keyed on the model name must include it."""
    spec = get_model_spec(name)
    return spec.variant_key_fn() if spec.variant_key_fn is not None else ""


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in place, in module order.  Convs and the dense
    head draw N(0, 1/fan_in) (a depthwise fan-in is its 9 taps); the
    BatchNorm statistics are drawn near identity so that the folded
    affine (scale and shift) is exercised, not a no-op.  A BatchNorm
    without a scale draws none."""

    def normal(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform(t, lo, hi):
        with torch.no_grad():
            t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=generator))

    for mod in module.modules():
        if isinstance(mod, SeparableConv2D):
            normal(mod.depthwise_weight, 1 / 3)
            normal(mod.pointwise_weight,
                   1 / math.sqrt(mod.pointwise_weight.shape[1]))
        elif isinstance(mod, DepthwiseConv2D):
            normal(mod.depthwise_weight, 1 / 3)
        elif isinstance(mod, nn.Conv2d):
            normal(mod.weight, 1 / math.sqrt(mod.weight[0].numel()))
        elif isinstance(mod, BatchNorm):
            if mod.weight is not None:
                uniform(mod.weight, 0.8, 1.2)
            normal(mod.bias, 0.05)
            normal(mod.running_mean, 0.05)
            uniform(mod.running_var, 0.8, 1.2)
        elif isinstance(mod, nn.Linear):
            normal(mod.weight, 1 / math.sqrt(mod.in_features))
            with torch.no_grad():
                mod.bias.zero_()


def load_model(name: str, weights: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               **build_kwargs) -> nn.Module:
    """Build zoo model ``name`` on the CPU in eval mode with seeded random
    weights (``generator``, default seed 0).  ``weights`` must be None:
    importing Keras ``.h5`` weights is not ported yet."""
    if weights is not None:
        raise NotImplementedError(
            f"weights={weights!r}: Keras weight import is not ported to "
            f"sparkdl_tpu_torch yet; pass weights=None for a seeded init")
    spec = get_model_spec(name)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module = spec.build(**build_kwargs)
    init_weights(module, generator)
    return module.eval()


__all__ = ["ModelSpec", "SUPPORTED_MODELS", "get_model_spec", "init_weights",
           "load_model", "model_variant_key"]
