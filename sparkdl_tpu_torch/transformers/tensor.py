"""Tensor-column transformers (port of ``sparkdl_tpu/transformers/tensor.py``).

  * :class:`ModelTransformer` — a :class:`ModelFunction` over one array
    column.
  * :class:`KerasTransformer` — a user Keras model file (``.h5`` /
    ``.keras``), converted without Keras (``graph/keras_convert.py``) at
    first use, then as ModelTransformer.  Input rows are 1-D float arrays
    (the reference's contract).
  * :class:`TFTransformer` — the mapping form: a ModelFunction with named
    inputs and outputs plus ``{column -> input}`` / ``{output -> column}``
    maps; ``TFInputGraph(...).model_function()`` (a TensorFlow GraphDef,
    checkpoint or SavedModel, read without TensorFlow) is one.

Each runs its ModelFunction through ``get_cached_engine`` on the card
unless the CPU was asked for (``sparkdl_tpu_torch.set_default_device``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pyarrow as pa

from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.params import Param, keyword_only
from sparkdl_tpu_torch.param.shared import (HasBatchSize, HasInputCol,
                                            HasOutputCol)
from sparkdl_tpu_torch.parallel.engine import get_cached_engine
from sparkdl_tpu_torch.persistence import PersistableModelFunctionMixin
from sparkdl_tpu_torch.transformers.base import Transformer
from sparkdl_tpu_torch.transformers.named_image import _float_list_array


def _rows_to_list_array(mat: np.ndarray) -> pa.Array:
    flat = np.asarray(mat).reshape(len(mat), -1)
    return _float_list_array(flat, np.arange(len(flat)), len(flat))


class ModelTransformer(PersistableModelFunctionMixin, Transformer,
                       HasInputCol, HasOutputCol, HasBatchSize):
    """Apply a ModelFunction to an array column (one row = one example)."""

    modelFunction = Param(
        "undefined", "modelFunction",
        "ModelFunction applied to the stacked input column",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelFunction=None,
                 batchSize: Optional[int] = None):
        super().__init__()
        self._setDefault(batchSize=64)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelFunction=None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)

    def _transform(self, dataset):
        x = dataset.column_to_numpy(self.getInputCol()).astype(np.float32)
        mf = self.getModelFunction()
        eng = get_cached_engine(self, mf, device_batch_size=self.getBatchSize())
        out = eng(x)
        return dataset.withColumn(self.getOutputCol(), _rows_to_list_array(out))


class KerasTransformer(ModelTransformer):
    """Apply a user Keras model to a column of 1-D float arrays: the
    reference's ``KerasTransformer``.  ``modelFile`` (``.h5`` / ``.keras``)
    is converted once, at first use."""

    modelFile = Param(
        "undefined", "modelFile",
        "path to a saved Keras model (.h5/.keras) applied row-wise")

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelFile: Optional[str] = None,
                 batchSize: Optional[int] = None):
        # bypasses ModelTransformer.__init__ (keyword_only stashing
        # composes badly across two levels); Params init + own defaults
        Transformer.__init__(self)
        self._setDefault(batchSize=64)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelFile: Optional[str] = None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getModelFile(self):
        return self.getOrDefault(self.modelFile)

    def getModelFunction(self):
        if not self.isSet(self.modelFunction):
            from sparkdl_tpu_torch.graph.function import ModelFunction

            self._set(modelFunction=ModelFunction.from_keras(
                self.getModelFile()))
        return self.getOrDefault(self.modelFunction)


class TFTransformer(PersistableModelFunctionMixin, Transformer, HasBatchSize):
    """Mapping form: a model with named inputs and outputs over several
    columns.  ``inputMapping`` = {column name -> model input name},
    ``outputMapping`` = {model output name -> new column name}; the
    ModelFunction takes a dict of arrays keyed by input name and returns a
    dict keyed by output name (or one array for a single output).  Unlike
    the JAX package's, this stage saves and loads."""

    modelFunction = Param(
        "undefined", "modelFunction",
        "ModelFunction taking/returning dicts keyed by input/output names",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    inputMapping = Param(
        "undefined", "inputMapping", "{column -> model input name}",
        typeConverter=SparkDLTypeConverters.toColumnToTensorMap)

    outputMapping = Param(
        "undefined", "outputMapping", "{model output name -> column}",
        typeConverter=SparkDLTypeConverters.toColumnToTensorMap)

    @keyword_only
    def __init__(self, modelFunction=None,
                 inputMapping: Optional[Dict[str, str]] = None,
                 outputMapping: Optional[Dict[str, str]] = None,
                 batchSize: Optional[int] = None):
        super().__init__()
        self._setDefault(batchSize=64)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, modelFunction=None,
                  inputMapping: Optional[Dict[str, str]] = None,
                  outputMapping: Optional[Dict[str, str]] = None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)

    def getInputMapping(self) -> Dict[str, str]:
        return self.getOrDefault(self.inputMapping)

    def getOutputMapping(self) -> Dict[str, str]:
        return self.getOrDefault(self.outputMapping)

    def _transform(self, dataset):
        mf = self.getModelFunction()
        in_map = self.getInputMapping()
        out_map = self.getOutputMapping()
        missing = set(in_map.values()) - set(mf.input_names)
        if missing:
            raise ValueError(
                f"inputMapping refers to unknown model inputs {sorted(missing)}; "
                f"model has {list(mf.input_names)}")
        missing = set(out_map) - set(mf.output_names)
        if missing:
            raise ValueError(
                f"outputMapping refers to unknown model outputs "
                f"{sorted(missing)}; model has {list(mf.output_names)}")
        x = {
            input_name: dataset.column_to_numpy(col).astype(np.float32)
            for col, input_name in in_map.items()
        }
        eng = get_cached_engine(self, mf, device_batch_size=self.getBatchSize())
        out = eng(x)
        if not isinstance(out, dict):
            out = {mf.output_names[0]: out}
        for output_name, col in out_map.items():
            dataset = dataset.withColumn(
                col, _rows_to_list_array(out[output_name]))
        return dataset
