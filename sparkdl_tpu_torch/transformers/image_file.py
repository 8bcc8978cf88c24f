"""URI-column transformers with a user image loader (port of
``sparkdl_tpu/transformers/image_file.py``).

The stage reads a column of file URIs, runs the user's ``imageLoader``
(decode + model-specific preprocessing, ``uri -> [H,W,C] float array``) on
the host's shared IO pool, and feeds the stacked batches to the model
through the engine: on the card unless the CPU was asked for.  Under the
pipelined engine (``SPARKDL_PIPELINE``, on by default) the runner's
prepare thread pulls the loader iterator itself; with
``SPARKDL_PIPELINE=0`` a prefetch thread does.
"""

from __future__ import annotations

import time
from itertools import chain
from typing import List, Optional

import numpy as np

from sparkdl_tpu_torch.image.io import _io_executor
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.params import Param, keyword_only
from sparkdl_tpu_torch.param.shared import (CanLoadImage, HasBatchSize,
                                            HasInputCol, HasOutputCol)
from sparkdl_tpu_torch.parallel.engine import get_cached_engine
from sparkdl_tpu_torch.parallel.pipeline import pipeline_enabled_from_env
from sparkdl_tpu_torch.persistence import PersistableModelFunctionMixin
from sparkdl_tpu_torch.transformers.base import Transformer
from sparkdl_tpu_torch.transformers.named_image import _float_list_array
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.prefetch import prefetch_iter

logger = get_logger(__name__)


class ImageFileTransformer(PersistableModelFunctionMixin, Transformer,
                           HasInputCol, HasOutputCol,
                           HasBatchSize, CanLoadImage):
    """Apply a ModelFunction to images loaded from a URI column via the
    user's ``imageLoader``.  Rows whose loader raises or returns None become
    null outputs (the imageIO drop-to-null contract)."""

    modelFunction = Param(
        "undefined", "modelFunction",
        "ModelFunction applied to the stacked loaded-image batch",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelFunction=None,
                 imageLoader=None,
                 batchSize: Optional[int] = None):
        super().__init__()
        self._setDefault(batchSize=64)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelFunction=None,
                  imageLoader=None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)

    def _safe_loader(self):
        loader = self.getImageLoader()

        def safe_load(uri):
            if uri is None:
                return None
            try:
                arr = loader(uri)
                return None if arr is None else np.asarray(arr)
            # the user's loader may raise anything for a bad file: the row
            # becomes null, as in the JAX package
            except Exception as e:
                logger.warning("imageLoader failed for %r: %s", uri, e)
                return None

        return safe_load

    def _loaded_chunks(self, dataset, chunk_rows: int, valid_idx: List[int]):
        """Generator of stacked float32 chunks over URIs whose load
        succeeded, one record batch of files at a time on the shared
        host-IO pool (the whole dataset's pixels never coexist in memory);
        appends the global index of each loaded row to ``valid_idx``."""
        safe_load = self._safe_loader()
        col_idx = dataset.table.column_names.index(self.getInputCol())
        offset = 0
        for rb in dataset.iter_batches(chunk_rows):
            uris = rb.column(col_idx).to_pylist()
            arrays = list(_io_executor().map(safe_load, uris))
            vi_local = [i for i, a in enumerate(arrays) if a is not None]
            if vi_local:
                valid_idx.extend(offset + i for i in vi_local)
                yield np.stack(
                    [arrays[i] for i in vi_local]).astype(np.float32)
            offset += len(uris)

    def _transform(self, dataset):
        valid_idx: List[int] = []
        chunks = self._loaded_chunks(dataset, max(1, self.getBatchSize()),
                                     valid_idx)
        it = (iter(chunks) if pipeline_enabled_from_env()
              else prefetch_iter(chunks, depth=2))
        first = next(it, None)
        outs = []
        if first is not None:
            # the engine (weights to the device) only once a chunk proves
            # there is work to do
            eng = get_cached_engine(self, self.getModelFunction(),
                                    device_batch_size=self.getBatchSize())
            t0 = time.perf_counter()
            outs = list(eng.map_batches(chain([first], it)))
            elapsed = time.perf_counter() - t0
            k = len(valid_idx)
            ips = k / elapsed if elapsed > 0 else float("inf")
            logger.info("%s: %d images in %.3fs — %.1f img/s on %s",
                        type(self).__name__, k, elapsed, ips, eng.device)
        n = len(dataset)
        if outs:
            out = np.concatenate([np.asarray(o) for o in outs], axis=0)
            flat = out.reshape(out.shape[0], -1)
        else:
            logger.warning("imageLoader produced no usable images out of %d "
                           "URIs; output column is all null", n)
            flat = np.zeros((0, 0), np.float32)
        return dataset.withColumn(self.getOutputCol(),
                                  _float_list_array(flat, valid_idx, n))


class KerasImageFileTransformer(ImageFileTransformer):
    """The Keras-model flavor: ``modelFile`` (``.h5`` / ``.keras``) is
    converted without Keras at first use — the reference's
    ``KerasImageFileTransformer``."""

    modelFile = Param(
        "undefined", "modelFile",
        "path to a saved Keras model applied to the loaded images")

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelFile: Optional[str] = None,
                 imageLoader=None,
                 batchSize: Optional[int] = None):
        Transformer.__init__(self)
        self._setDefault(batchSize=64)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelFile: Optional[str] = None,
                  imageLoader=None,
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
