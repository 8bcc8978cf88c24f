"""Shared param mixins used across pipeline stages.

Replaces the reference's shared ``Param`` definitions in
``python/sparkdl/param/shared_params.py`` (``HasInputCol``, ``HasOutputCol``,
``HasLabelCol``, ``CanLoadImage``, ...) — the common vocabulary every
transformer/estimator speaks.
"""

from __future__ import annotations

from sparkdl_tpu_torch.param.params import Param, Params, TypeConverters


class HasInputCol(Params):
    inputCol = Param(
        "undefined", "inputCol", "name of the input column",
        typeConverter=TypeConverters.toString)

    def setInputCol(self, value):
        return self._set(inputCol=value)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(
        "undefined", "outputCol", "name of the output column",
        typeConverter=TypeConverters.toString)

    def setOutputCol(self, value):
        return self._set(outputCol=value)

    def getOutputCol(self):
        return self.getOrDefault(self.outputCol)


class HasLabelCol(Params):
    labelCol = Param(
        "undefined", "labelCol", "name of the label column",
        typeConverter=TypeConverters.toString)

    def setLabelCol(self, value):
        return self._set(labelCol=value)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)


class HasBatchSize(Params):
    batchSize = Param(
        "undefined", "batchSize",
        "device batch size; batches are padded up to this shape so the "
        "compiled XLA program is reused across calls",
        typeConverter=TypeConverters.toInt)

    def setBatchSize(self, value):
        return self._set(batchSize=value)

    def getBatchSize(self):
        return self.getOrDefault(self.batchSize)


class HasModelName(Params):
    modelName = Param(
        "undefined", "modelName",
        "name of a model in the pretrained zoo (see sparkdl_tpu_torch.models.SUPPORTED_MODELS)",
        typeConverter=TypeConverters.toString)

    def setModelName(self, value):
        return self._set(modelName=value)

    def getModelName(self):
        return self.getOrDefault(self.modelName)


class HasTopK(Params):
    topK = Param(
        "undefined", "topK",
        "how many class predictions to return per image",
        typeConverter=TypeConverters.toInt)

    def setTopK(self, value):
        return self._set(topK=value)

    def getTopK(self):
        return self.getOrDefault(self.topK)


def _output_mode_converter(value):
    if value not in HasOutputMode.OUTPUT_MODES:
        raise TypeError(
            f"outputMode must be one of {HasOutputMode.OUTPUT_MODES}, got {value!r}")
    return value


class HasOutputMode(Params):
    OUTPUT_MODES = ("vector", "image")

    outputMode = Param(
        "undefined", "outputMode",
        'output column payload: "vector" (flat float vector) or "image" '
        "(image struct)  — mirrors TFImageTransformer.OUTPUT_MODES",
        typeConverter=_output_mode_converter)

    def setOutputMode(self, value):
        return self._set(outputMode=value)

    def getOutputMode(self):
        return self.getOrDefault(self.outputMode)


class CanLoadImage(Params):
    """Mixin for stages that read image files through a user preprocessor.

    Mirrors the reference's ``CanLoadImage`` (``sparkdl/param/image_params.py``):
    ``imageLoader`` is a user function ``uri -> np.ndarray[H,W,C] float`` doing
    decode + model-specific preprocessing; the stage maps it over a URI column.
    """

    imageLoader = Param(
        "undefined", "imageLoader",
        "function uri -> numpy array [H,W,C]; decodes and preprocesses one "
        "image for the model",
        typeConverter=TypeConverters.toCallable)

    def setImageLoader(self, value):
        return self._set(imageLoader=value)

    def getImageLoader(self):
        return self.getOrDefault(self.imageLoader)

    def loadImagesInternal(self, uris):
        """Load a sequence of URIs into a stacked numpy batch."""
        import numpy as np
        loader = self.getImageLoader()
        arrs = [np.asarray(loader(u)) for u in uris]
        return np.stack(arrs, axis=0)
