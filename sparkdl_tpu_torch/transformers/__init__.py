"""Pipeline stages (port of ``sparkdl_tpu.transformers``)."""

from sparkdl_tpu_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)

__all__ = ["DeepImageFeaturizer", "DeepImagePredictor"]
