"""Model-graph layer (port of ``sparkdl_tpu.graph``): :class:`ModelFunction`,
the composable unit of computation, and the Keras-config converter
(:mod:`sparkdl_tpu_torch.graph.keras_convert`).  ``TFInputGraph``
(``graph/{input,tf_import}.py``) is not ported: it parses TensorFlow
GraphDefs, which needs TensorFlow."""

from sparkdl_tpu_torch.graph.function import ModelFunction

__all__ = ["ModelFunction"]
