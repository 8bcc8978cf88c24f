"""Pretrained-CNN zoo registry (port of ``sparkdl_tpu/models/__init__.py``).

The port's zoo holds the JAX package's nine models: InceptionV3, Xception,
ResNet50/101/152, VGG16/19, MobileNetV2 and EfficientNetB0.  Each
``ModelSpec`` carries what the transformer layer needs: input size,
featurizer-cut width, ImageNet preprocess mode, the module builder and the
``keras.applications`` name its weights files go by.  ``load_model`` gives
a seeded random init at full width, or imports Keras weights from a
``.weights.h5``, ``.h5`` or ``.keras`` file without Keras
(``models/keras_import.py``; h5py is needed only to read a file):
``weights="imagenet"`` takes ``$SPARKDL_WEIGHTS_DIR/<model>.weights.h5``
(or ``.h5``, ``.keras``) when there is one.

The builders read process env, as in JAX: ``SPARKDL_XC_TILED=1`` routes
Xception's large entry blocks through the tiled kernel,
``SPARKDL_MNV2_FUSED=1`` MobileNetV2's stride-1 blocks through the mbconv
kernel, ``SPARKDL_RN_FUSED_SHORTCUT=1`` fuses each ResNet downsample
block's shortcut and reduce convs (all three off by default);
``SPARKDL_S2D_STEM=1`` computes InceptionV3's first conv as space-to-depth
(off by default) and ``SPARKDL_FUSED_HEADS=0`` turns its fused branch heads
off (on by default).  Caches keyed on a model name fold in
:func:`model_variant_key` so a knob set mid-process builds the other
variant instead of serving the cached one.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from sparkdl_tpu_torch.models.efficientnet import (EfficientNetB0,
                                                   InputNorm,
                                                   efficientnet_import_fixup)
from sparkdl_tpu_torch.models.inception import (InceptionV3,
                                                inception_import_order)
from sparkdl_tpu_torch.models.layers import (BatchNorm, DepthwiseConv2D,
                                             SeparableConv2D)
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
from sparkdl_tpu_torch.models.preprocess import get_preprocess_fn
from sparkdl_tpu_torch.models.resnet import ResNet50, ResNet101, ResNet152
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception, xception_auto_order
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class ModelSpec:
    """One zoo entry: everything needed to featurize/predict with the model."""

    name: str
    module_builder: Callable[..., nn.Module]
    input_size: Tuple[int, int]                # (height, width)
    feature_size: int                          # featurizer-cut dimensionality
    preprocess_mode: str                       # see models.preprocess
    keras_app: str                             # keras.applications name
    # () -> str tag when module_builder reads process env; caches keyed on
    # the model name fold it in (model_variant_key)
    variant_key_fn: Optional[Callable[[], str]] = None
    # () -> [(kind, module path)]: creation-order targets of the Keras
    # layers that match no module by name (keras_import.import_weights)
    auto_order_fn: Optional[Callable[[], list]] = None
    # (layer configs or None, state_dict) -> state_dict after the import
    import_fixup: Optional[Callable] = None

    @property
    def preprocess(self):
        return get_preprocess_fn(self.preprocess_mode)

    def build(self, **kwargs) -> nn.Module:
        return self.module_builder(**kwargs)

    def resolve_weights(self, weights: Optional[str] = "imagenet"
                        ) -> Optional[str]:
        """Resolve ``weights`` against the offline bundle, as the JAX
        package does: None stays None; an explicit path is returned as is
        and must exist; "imagenet" becomes the first of
        ``$SPARKDL_WEIGHTS_DIR/<stem>{.weights.h5,.h5,.keras}`` that exists
        (stems: the model's name and its Keras name, each also in lower
        case), or stays "imagenet" when there is none."""
        if weights is None:
            return None
        if weights != "imagenet":
            if not os.path.isfile(weights):
                raise FileNotFoundError(
                    f"weights file {weights!r} does not exist")
            return weights
        wdir = os.environ.get("SPARKDL_WEIGHTS_DIR")
        if wdir:
            stems = {self.name, self.name.lower(), self.keras_app,
                     self.keras_app.lower()}
            for stem in sorted(stems):
                for ext in (".weights.h5", ".h5", ".keras"):
                    cand = os.path.join(wdir, stem + ext)
                    if os.path.isfile(cand):
                        logger.info("Using offline weights %s", cand)
                        return cand
        return "imagenet"


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


def _rn_fused_shortcut_enabled() -> bool:
    return _env_flag("SPARKDL_RN_FUSED_SHORTCUT", False)


def _resnet_variant() -> str:
    # one helper for the whole family: a second ResNet knob changes the tag
    # of ResNet50/101/152 together
    return "fsc" if _rn_fused_shortcut_enabled() else ""


def _resnet_builder(depth_builder):
    return lambda **kwargs: depth_builder(
        fused_shortcut=_rn_fused_shortcut_enabled(), **kwargs)


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
        keras_app="InceptionV3", variant_key_fn=_inception_variant,
        auto_order_fn=inception_import_order),
    "xception": ModelSpec(
        name="Xception", module_builder=_xception_builder,
        input_size=(299, 299), feature_size=2048, preprocess_mode="tf",
        keras_app="Xception",
        variant_key_fn=lambda: "tiled" if _xc_tiled_enabled() else "",
        auto_order_fn=xception_auto_order),
    "mobilenetv2": ModelSpec(
        name="MobileNetV2", module_builder=_mobilenet_builder,
        input_size=(224, 224), feature_size=1280, preprocess_mode="tf",
        keras_app="MobileNetV2",
        variant_key_fn=lambda: "fused" if _mnv2_fused_enabled() else ""),
    "vgg16": ModelSpec(
        name="VGG16", module_builder=VGG16, input_size=(224, 224),
        feature_size=4096, preprocess_mode="caffe", keras_app="VGG16"),
    "vgg19": ModelSpec(
        name="VGG19", module_builder=VGG19, input_size=(224, 224),
        feature_size=4096, preprocess_mode="caffe", keras_app="VGG19"),
    # Keras auto-names EfficientNet's input Normalization ("normalization",
    # "normalization_1", ... by the session's build count), so it imports by
    # creation order when the by-name match misses
    "efficientnetb0": ModelSpec(
        name="EfficientNetB0", module_builder=EfficientNetB0,
        input_size=(224, 224), feature_size=1280, preprocess_mode="none",
        keras_app="EfficientNetB0",
        auto_order_fn=lambda: [("norm", "normalization")],
        import_fixup=efficientnet_import_fixup),
}
for _depth, _builder in ((50, ResNet50), (101, ResNet101),
                         (152, ResNet152)):
    _SPECS[f"resnet{_depth}"] = ModelSpec(
        name=f"ResNet{_depth}", module_builder=_resnet_builder(_builder),
        input_size=(224, 224), feature_size=2048, preprocess_mode="caffe",
        keras_app=f"ResNet{_depth}", variant_key_fn=_resnet_variant)

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
    layers draw N(0, 1/fan_in) (a depthwise fan-in is its k*k taps), conv
    biases N(0, 0.05^2), dense biases 0; the BatchNorm statistics, and
    EfficientNet's input normalization, are drawn near identity so that
    the folded affine (scale and shift) is exercised, not a no-op.  A
    BatchNorm without a scale draws none."""

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
            normal(mod.depthwise_weight,
                   1 / math.sqrt(mod.depthwise_weight[0].numel()))
        elif isinstance(mod, nn.Conv2d):
            normal(mod.weight, 1 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                normal(mod.bias, 0.05)
        elif isinstance(mod, InputNorm):
            normal(mod.mean, 0.05)
            uniform(mod.var, 0.8, 1.2)
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


def import_keras_weights(name: str, layers, layer_configs=None,
                         model: Optional[nn.Module] = None
                         ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of zoo model ``name`` from weighted Keras
    ``layers`` (``keras_import.KerasLayer`` or ``(name, class_name,
    [arrays])`` in Keras layout): by name where Keras names the layer, by
    creation order for its auto-named ones; then the model's import fixup
    (EfficientNet's ``post_scale`` from ``layer_configs``, the file's
    ``(class_name, config)`` per layer, where it has a model config).
    ``model`` (default: the registry's build on the meta device) gives
    the structure and shapes to fill."""
    from sparkdl_tpu_torch.models import keras_import

    spec = get_model_spec(name)
    if model is None:
        with torch.device("meta"):
            model = spec.build()
    sd = keras_import.import_weights(
        model, layers,
        auto_order=spec.auto_order_fn() if spec.auto_order_fn else None)
    if spec.import_fixup is not None:
        sd = spec.import_fixup(layer_configs, sd)
    return sd


def load_model(name: str, weights: Optional[str] = "imagenet",
               generator: Optional[torch.Generator] = None,
               **build_kwargs) -> nn.Module:
    """Build zoo model ``name`` on the CPU in eval mode.

    ``weights``: "imagenet" (the default, as in the JAX package) imports
    ``$SPARKDL_WEIGHTS_DIR``'s file for the model
    (:meth:`ModelSpec.resolve_weights`) or, when there is none, warns and
    gives the seeded init, as the JAX package falls back to Keras' random
    init; None gives the seeded random init (``generator``, default seed
    0); a path imports that ``.weights.h5``, ``.h5`` or ``.keras`` file.
    An explicit path that fails to import raises."""
    spec = get_model_spec(name)
    resolved = spec.resolve_weights(weights)
    if resolved == "imagenet":
        logger.warning(
            "No offline imagenet weights for %s; using a seeded random "
            "init. For air-gapped use, point SPARKDL_WEIGHTS_DIR at a "
            "directory holding <model>.weights.h5 / .h5 / .keras files",
            spec.name)
        resolved = None
    module = spec.build(**build_kwargs)
    if resolved is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(module, generator)
    else:
        from sparkdl_tpu_torch.models import keras_import

        read = keras_import.read_weights_file(resolved, spec.name)
        module.load_state_dict(import_keras_weights(
            spec.name, read.layers, read.layer_configs, model=module))
    return module.eval()


__all__ = ["ModelSpec", "SUPPORTED_MODELS", "get_model_spec",
           "import_keras_weights", "init_weights", "load_model",
           "model_variant_key"]
