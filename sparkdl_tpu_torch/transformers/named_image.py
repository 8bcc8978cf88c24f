"""Named pretrained-model transformers (port of
``sparkdl_tpu/transformers/named_image.py``).

``DeepImageFeaturizer`` / ``DeepImagePredictor`` run a zoo CNN over an
image-struct column: arrow structs -> ``arrowStructsToBatch`` (host decode,
uint8 RGB) -> on-device preprocess -> the model through
:class:`~sparkdl_tpu_torch.parallel.engine.InferenceEngine` -> a float
column.  :class:`TFImageTransformer` runs a user :class:`ModelFunction`
over the same decoded batches.  Entry points run on CUDA unless the CPU
was asked for (``sparkdl_tpu_torch.set_default_device``).
"""

from __future__ import annotations

import os
import time
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch
import torch.nn as nn

from sparkdl_tpu_torch import resolve_device
from sparkdl_tpu_torch.image.io import arrowStructsToBatch
from sparkdl_tpu_torch.image.schema import imageArrayToStruct, imageSchema
from sparkdl_tpu_torch.models import (SUPPORTED_MODELS, get_model_spec,
                                      load_model, model_variant_key)
from sparkdl_tpu_torch.models.imagenet import decode_predictions
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.params import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import (HasBatchSize, HasInputCol,
                                            HasModelName, HasOutputCol,
                                            HasOutputMode, HasTopK)
from sparkdl_tpu_torch.parallel.engine import (InferenceEngine,
                                               batches_per_dispatch_from_env,
                                               get_cached_engine)
from sparkdl_tpu_torch.parallel.pipeline import pipeline_enabled_from_env
from sparkdl_tpu_torch.persistence import PersistableModelFunctionMixin
from sparkdl_tpu_torch.transformers.base import Transformer
from sparkdl_tpu_torch.utils.cache import ByteBoundedLRU
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.prefetch import prefetch_iter

logger = get_logger(__name__)

# Process-wide caches: zoo weights load once per (model, build variant),
# engines are built once per (model, variant, cut, batch, dtype, device).
# The engine cache holds at most ENGINE_POOL_SHARE of the card's memory in
# the engines' CUDA-graph pools, least recently used first; an evicted
# engine releases its graphs once the card is done with them.  The rest of
# the card stays for weights, a fit's activations and other engines.
ENGINE_POOL_SHARE = 0.25


def new_engine_cache() -> ByteBoundedLRU:
    """An engine cache: entries sized by their graph pools, bounded by
    ``ENGINE_POOL_SHARE`` of the current card's memory (0 without a card,
    where no engine captures a graph), evicted least recently used first,
    each evicted engine's graphs released."""
    cap = 0
    if torch.cuda.is_available():
        cap = int(ENGINE_POOL_SHARE * torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    return ByteBoundedLRU(cap, sizeof=lambda eng: eng.graph_pool_bytes,
                          on_evict=lambda key, eng: eng.release_graphs())


_MODEL_CACHE: Dict[tuple, nn.Module] = {}
_ENGINE_CACHE = new_engine_cache()


def clear_model_caches():
    _MODEL_CACHE.clear()
    _ENGINE_CACHE.clear()


def _cached_model(name: str) -> nn.Module:
    # the env-dependent build variant (SPARKDL_MNV2_FUSED, SPARKDL_XC_TILED,
    # SPARKDL_S2D_STEM, SPARKDL_FUSED_HEADS, SPARKDL_RN_FUSED_SHORTCUT) is
    # part of the key: a knob set mid-process builds the other variant.
    # "imagenet" imports $SPARKDL_WEIGHTS_DIR's file for the model, or
    # warns and takes the seeded init when there is none (as JAX does).
    name = get_model_spec(name).name
    key = (name, model_variant_key(name))
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = load_model(name, weights="imagenet")
    return _MODEL_CACHE[key]


def zoo_compute_dtype_name() -> str:
    """Canonicalized ``SPARKDL_ZOO_COMPUTE_DTYPE`` ("float32" or
    "bfloat16"), read as the JAX package reads it; raises on unsupported
    values."""
    cdt_name = os.environ.get("SPARKDL_ZOO_COMPUTE_DTYPE", "").lower()
    if cdt_name not in ("", "float32", "f32", "bfloat16", "bf16"):
        raise ValueError(
            f"SPARKDL_ZOO_COMPUTE_DTYPE={cdt_name!r} not supported; use "
            f"'bfloat16' or 'float32'")
    return {"bf16": "bfloat16", "f32": "float32", "": "float32"}.get(
        cdt_name, cdt_name)


def zoo_model_fn(name: str, featurize: bool,
                 compute_dtype: Optional[torch.dtype] = None):
    """THE ``fn(module, x)`` the zoo engine runs: preprocess on the device,
    optional cast to the compute dtype, inference at the featurizer or
    predictor cut.  ``x`` is a uint8 RGB [B,H,W,3] tensor."""
    pre = get_model_spec(name).preprocess

    def fn(module, x):
        xf = pre(x)
        if compute_dtype is not None:
            xf = xf.to(compute_dtype)
        return module(xf, features=featurize)

    return fn


def zoo_serving_bundle(name: str, featurize: bool,
                       feature_cut: bool = False):
    """``(fn, module, engine_overrides)`` for serving zoo model ``name``
    (the JAX package's ``zoo_serving_bundle``, whose ``variables`` are the
    port's module): the module from the process cache, the fn through
    :func:`zoo_model_fn`, and ``SPARKDL_ZOO_COMPUTE_DTYPE`` as engine
    overrides (bf16 compute, outputs widened to f32 on the host).
    :func:`_zoo_engine` builds the transformers' engines from it and
    ``serving.server._resolve_model`` resolves a zoo name through it, so
    that served rows are transformed rows.

    ``feature_cut=True`` (the head fan-out) returns the split bundle
    ``(backbone_fn, module, engine_overrides, head_fn)``: the featurizer
    cut as the backbone and the canonical per-row head
    (``parallel.engine.dense_head_row``) that a
    :class:`~sparkdl_tpu_torch.parallel.engine.HeadBank` serves; it
    requires ``featurize=True``."""
    overrides: Dict[str, object] = {}
    cdt = None
    if zoo_compute_dtype_name() == "bfloat16":
        cdt = torch.bfloat16
        overrides.update({"compute_dtype": cdt,
                          "output_host_dtype": np.float32})
    if feature_cut and not featurize:
        raise ValueError(
            "feature_cut=True requires featurize=True: the split's "
            "backbone program IS the featurizer cut (the head fan-out "
            "tier has no predictor-cut backbone)")
    fn = zoo_model_fn(name, featurize, compute_dtype=cdt)
    if feature_cut:
        from sparkdl_tpu_torch.parallel.engine import dense_head_row

        return fn, _cached_model(name), overrides, dense_head_row
    return fn, _cached_model(name), overrides


def _zoo_engine(name: str, featurize: bool, batch_size: int) -> InferenceEngine:
    """One cached engine per (model, build variant, cut, batch, compute
    dtype, device, ``SPARKDL_BATCHES_PER_DISPATCH``).

    ``SPARKDL_ZOO_COMPUTE_DTYPE=bfloat16`` runs the model in bf16 and
    fetches bf16 outputs, widened to f32 on the host.  The default stays
    float32 end to end (the fused layers round to bf16 inside, as in JAX).
    """
    key = _zoo_engine_key(name, featurize, batch_size)
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        # make room first: the cached engines' pools are known by now
        _ENGINE_CACHE.reaccount()
        fn, module, overrides = zoo_serving_bundle(key[0], featurize)
        eng = InferenceEngine(fn, module, device=resolve_device(),
                              device_batch_size=batch_size,
                              batches_per_dispatch=key[6], **overrides)
        _ENGINE_CACHE.put(key, eng)
    return eng


def _zoo_engine_key(name: str, featurize: bool, batch_size: int) -> tuple:
    """The engine cache's key: (model, build variant, cut, batch, compute
    dtype, device, ``SPARKDL_BATCHES_PER_DISPATCH``)."""
    name = get_model_spec(name).name
    return (name, model_variant_key(name), featurize, batch_size,
            zoo_compute_dtype_name(), str(resolve_device()),
            batches_per_dispatch_from_env())


def _float_list_array(mat: np.ndarray, valid_idx: Sequence[int],
                      num_rows: int) -> pa.Array:
    """Rows of ``mat`` at positions ``valid_idx``; nulls elsewhere.  Built
    from the float32 matrix in one piece (offsets + values + null mask),
    not row by row through Python floats: the same column, without a
    Python call per value."""
    mat = np.asarray(mat, np.float32)
    idx = np.asarray(valid_idx, np.int64)
    order = np.argsort(idx, kind="stable")  # rows in table order
    lengths = np.zeros(num_rows, np.int32)
    lengths[idx] = mat.shape[1]
    offsets = np.zeros(num_rows + 1, np.int32)
    np.cumsum(lengths, out=offsets[1:])
    valid = np.zeros(num_rows, bool)
    valid[idx] = True
    return pa.ListArray.from_arrays(
        pa.array(offsets), pa.array(mat[order].reshape(-1)),
        type=pa.list_(pa.float32()), mask=pa.array(~valid))


class _ImageInputStage(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    """Shared plumbing: pull the image-struct column, decode/resize valid
    rows into dense batches, keep nulls aligned (undecodable rows stay
    null).  The column is consumed one record batch at a time; host decode
    of chunk k+1 runs on another thread while the device computes chunk k:
    the engine's pipelined runner pulls the decode iterator on its prepare
    thread, and with ``SPARKDL_PIPELINE=0`` a prefetch thread does."""

    def _first_valid_struct(self, dataset) -> Optional[dict]:
        """First non-null image struct, without materializing the column."""
        col_idx = dataset.table.column_names.index(self.getInputCol())
        for rb in dataset.iter_batches(64):
            for s in rb.column(col_idx).to_pylist():
                if s is not None:
                    return s
        return None

    def _decoded_chunks(self, dataset, height: int, width: int,
                        chunk_rows: int, valid_idx: List[int],
                        origins: Optional[List[str]] = None):
        """Generator of decoded [b,h,w,3] uint8 RGB chunks over valid rows;
        appends the global row index of each valid row to ``valid_idx``
        (and its origin to ``origins`` if given) as it advances."""
        col_idx = dataset.table.column_names.index(self.getInputCol())
        offset = 0
        for rb in dataset.iter_batches(chunk_rows):
            col = rb.column(col_idx)
            batch, ok = arrowStructsToBatch(col, height, width, compact=True)
            vi_local = np.nonzero(ok)[0]
            if len(vi_local):
                valid_idx.extend(int(offset + i) for i in vi_local)
                if origins is not None:
                    ocol = col.field("origin")
                    origins.extend(
                        (ocol[int(i)].as_py() or "") for i in vi_local)
                yield batch
            offset += len(col)

    def _stream_model_outputs(self, dataset, engine_factory, height: int,
                              width: int, valid_idx: List[int],
                              origins: Optional[List[str]] = None):
        """Lazily yield per-piece model outputs for the image column; the
        engine is only built once the first decoded chunk proves there is
        work to do.  Under the pipelined engine (``SPARKDL_PIPELINE``, on by
        default) the runner's prepare thread pulls the decode iterator
        itself; ``prefetch_iter`` would only add a queue hop, so it serves
        the serial path only."""
        chunks = self._decoded_chunks(dataset, height, width,
                                      max(1, int(self.getBatchSize())),
                                      valid_idx, origins)
        it = (iter(chunks) if pipeline_enabled_from_env()
              else prefetch_iter(chunks, depth=2))
        first = next(it, None)
        if first is None:
            return
        engine = engine_factory()
        t0 = time.perf_counter()
        yield from engine.map_batches(chain([first], it))
        elapsed = time.perf_counter() - t0
        n = len(valid_idx)
        ips = n / elapsed if elapsed > 0 else float("inf")
        logger.info("%s: %d images in %.3fs — %.1f img/s on %s",
                    type(self).__name__, n, elapsed, ips, engine.device)

    def _run_streaming(self, dataset, engine_factory, height: int,
                       width: int, origins: Optional[List[str]] = None):
        """(outputs [n_valid, ...] or None when nothing decoded, valid_idx)."""
        valid_idx: List[int] = []
        outs = list(self._stream_model_outputs(
            dataset, engine_factory, height, width, valid_idx, origins))
        if not outs:
            return None, valid_idx
        return np.concatenate(outs, axis=0), valid_idx


class _NamedImageTransformer(_ImageInputStage, HasModelName):
    """Base of the zoo stages — resolves modelName against the registry."""

    featurize: bool = False

    def __init__(self):
        super().__init__()
        self.modelName.typeConverter = SparkDLTypeConverters.supportedNameConverter(
            SUPPORTED_MODELS)
        self._setDefault(batchSize=64)

    def _run_model(self, dataset) -> Tuple[np.ndarray, list, int]:
        name = self.getModelName()
        spec = get_model_spec(name)
        h, w = spec.input_size
        used = []

        def factory():
            used.append(_zoo_engine_key(name, self.featurize,
                                        self.getBatchSize()))
            return _zoo_engine(name, self.featurize, self.getBatchSize())

        try:
            out, valid_idx = self._run_streaming(dataset, factory, h, w)
        finally:
            # the engine's pool is known after its capture: account it and
            # evict over the bound (never the engine just used), outside
            # every engine's lock; within a transform the engine in use may
            # take the cache past the bound by its own pool
            if used:
                _ENGINE_CACHE.reaccount(keep=used[0])
        if out is None:
            dim = spec.feature_size if self.featurize else 1000
            return np.zeros((0, dim), np.float32), valid_idx, len(dataset)
        return out, valid_idx, len(dataset)


class DeepImageFeaturizer(_NamedImageTransformer):
    """Zoo-model featurization for transfer learning: the output column
    holds the penultimate-layer vector (2048-d for InceptionV3 and
    Xception, 1280-d for MobileNetV2)."""

    featurize = True

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelName: Optional[str] = None,
                 batchSize: Optional[int] = None):
        super().__init__()
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelName: Optional[str] = None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def _transform(self, dataset):
        feats, valid_idx, n = self._run_model(dataset)
        return dataset.withColumn(
            self.getOutputCol(), _float_list_array(feats, valid_idx, n))


class DeepImagePredictor(_NamedImageTransformer):
    """Zoo-model prediction: class probabilities, optionally decoded to
    top-K ``(class, description, probability)`` structs."""

    featurize = False

    decodePredictions = Param(
        "undefined", "decodePredictions",
        "decode the output probabilities into top-K (class, description, "
        "probability) rows", typeConverter=TypeConverters.toBoolean)

    topK = HasTopK.topK

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelName: Optional[str] = None,
                 decodePredictions: bool = False,
                 topK: int = 5,
                 batchSize: Optional[int] = None):
        super().__init__()
        self._setDefault(decodePredictions=False, topK=5)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelName: Optional[str] = None,
                  decodePredictions: Optional[bool] = None,
                  topK: Optional[int] = None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getDecodePredictions(self):
        return self.getOrDefault(self.decodePredictions)

    def getTopK(self):
        return self.getOrDefault(self.topK)

    def _transform(self, dataset):
        probs, valid_idx, n = self._run_model(dataset)
        out_col = self.getOutputCol()
        if not self.getDecodePredictions():
            return dataset.withColumn(
                out_col, _float_list_array(probs, valid_idx, n))
        decoded = decode_predictions(probs, top=self.getTopK())
        pred_type = pa.list_(pa.struct([
            pa.field("class", pa.string()),
            pa.field("description", pa.string()),
            pa.field("probability", pa.float32()),
        ]))
        values: List[Optional[list]] = [None] * n
        for row, i in zip(decoded, valid_idx):
            values[i] = [
                {"class": c, "description": d, "probability": p}
                for c, d, p in row]
        return dataset.withColumn(out_col, pa.array(values, type=pred_type))


class TFImageTransformer(PersistableModelFunctionMixin, _ImageInputStage,
                         HasOutputMode):
    """A user :class:`ModelFunction` over the image column: the
    reference's ``TFImageTransformer`` with a ModelFunction in place of a
    TF graph, applied to the decoded ``[B,H,W,3]`` uint8 RGB batch on the
    card.  ``outputMode="vector"`` emits a flat float vector per row;
    ``"image"`` packs a ``[H,W,C]`` float output back into an image struct
    (C of 3 or 4, RGB(A) turned back to the struct's BGR(A)), chunk by
    chunk as the engine yields them."""

    modelFunction = Param(
        "undefined", "modelFunction",
        "ModelFunction applied to the decoded [B,H,W,3] uint8 RGB batch",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    inputSize = Param(
        "undefined", "inputSize",
        "[height, width] the images are resized to before the model; "
        "defaults to the first row's stored size",
        typeConverter=TypeConverters.toList)

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 modelFunction=None,
                 inputSize: Optional[Sequence[int]] = None,
                 outputMode: str = "vector",
                 batchSize: Optional[int] = None):
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=64)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  modelFunction=None,
                  inputSize: Optional[Sequence[int]] = None,
                  outputMode: Optional[str] = None,
                  batchSize: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)

    def transformStream(self, batches, params=None):
        """Stream with one input size: when ``inputSize`` is unset it is
        read once from the first valid struct and pinned for the whole
        stream, so that batches whose first images differ in size do not
        emit different feature widths into one column."""
        if params:
            yield from self.copy(params).transformStream(batches)
            return
        if self.isDefined(self.inputSize):
            yield from super().transformStream(batches)
            return
        from sparkdl_tpu_torch.frame import DataFrame

        it = iter(batches)
        buffered, size = [], None
        for rb in it:
            buffered.append(rb)
            s = self._first_valid_struct(DataFrame(rb))
            if s is not None:
                size = [int(s["height"]), int(s["width"])]
                break
        if size is None:
            raise ValueError(
                f"No decodable images in column {self.getInputCol()!r}")
        pinned = self.copy({"inputSize": size})
        yield from pinned.transformStream(chain(buffered, it))

    def _transform(self, dataset):
        if self.isDefined(self.inputSize):
            h, w = (int(v) for v in self.getOrDefault(self.inputSize))
        else:
            first = self._first_valid_struct(dataset)
            if first is None:
                raise ValueError(
                    f"No decodable images in column {self.getInputCol()!r}")
            h, w = int(first["height"]), int(first["width"])
        n = len(dataset)

        def factory():
            return get_cached_engine(self, self.getModelFunction(),
                                     device_batch_size=self.getBatchSize())

        if self.getOutputMode() == "image":
            return self._transform_image_mode(dataset, factory, h, w, n)
        out, valid_idx = self._run_streaming(dataset, factory, h, w)
        if out is None:
            # nothing decodable but the size was known (explicit or pinned
            # by transformStream): an all-null batch mid-stream stays null
            return dataset.withColumn(
                self.getOutputCol(),
                pa.array([None] * n, type=pa.list_(pa.float32())))
        flat = np.asarray(out).reshape(len(out), -1)
        return dataset.withColumn(
            self.getOutputCol(), _float_list_array(flat, valid_idx, n))

    def _transform_image_mode(self, dataset, engine_factory, h, w, n):
        origins: List[str] = []
        valid_idx: List[int] = []
        packed: List[dict] = []
        consumed = 0
        for out in self._stream_model_outputs(
                dataset, engine_factory, h, w, valid_idx, origins):
            out = np.asarray(out)
            if out.ndim != 4:
                raise ValueError(
                    f'outputMode="image" needs [B,H,W,C] model output, got '
                    f"shape {out.shape}")
            for row, origin in zip(out, origins[consumed:consumed + len(out)]):
                if row.shape[-1] == 3:
                    row = row[:, :, ::-1]  # model RGB -> struct BGR
                elif row.shape[-1] == 4:
                    row = row[:, :, [2, 1, 0, 3]]  # RGBA -> BGRA
                packed.append(imageArrayToStruct(
                    np.ascontiguousarray(row, dtype=np.float32),
                    origin=origin))
            consumed += len(out)
        values: List[Optional[dict]] = [None] * n
        for struct, i in zip(packed, valid_idx):
            values[i] = struct
        return dataset.withColumn(
            self.getOutputCol(), pa.array(values, type=imageSchema))
