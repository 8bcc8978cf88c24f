"""Model-graph layer (port of ``sparkdl_tpu.graph``): :class:`ModelFunction`,
the composable unit of computation; the Keras-config converter
(:mod:`sparkdl_tpu_torch.graph.keras_convert`); and :class:`TFInputGraph`,
the import of TensorFlow GraphDefs, checkpoints and SavedModels
(:mod:`~sparkdl_tpu_torch.graph.input` over ``tf_import``, ``proto`` and
``bundle``), which reads them without TensorFlow or a protobuf package."""

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.input import ModelInput, TFInputGraph

__all__ = ["ModelFunction", "ModelInput", "TFInputGraph"]
