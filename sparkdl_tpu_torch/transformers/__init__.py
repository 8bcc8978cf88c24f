"""Pipeline stages (port of ``sparkdl_tpu.transformers``)."""

from sparkdl_tpu_torch.transformers.base import (Estimator, Model, Pipeline,
                                                 PipelineModel, Transformer)
from sparkdl_tpu_torch.transformers.named_image import (DeepImageFeaturizer,
                                                        DeepImagePredictor,
                                                        TFImageTransformer)
from sparkdl_tpu_torch.transformers.tensor import (KerasTransformer,
                                                   ModelTransformer,
                                                   TFTransformer)
from sparkdl_tpu_torch.transformers.image_file import (
    ImageFileTransformer, KerasImageFileTransformer)

__all__ = [
    "DeepImageFeaturizer", "DeepImagePredictor", "Estimator",
    "ImageFileTransformer", "KerasImageFileTransformer", "KerasTransformer",
    "Model", "ModelTransformer", "Pipeline", "PipelineModel",
    "TFImageTransformer", "TFTransformer", "Transformer",
]
