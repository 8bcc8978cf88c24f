"""UDF registry + builders (port of ``sparkdl_tpu/udf/registry.py``).

``registerKerasImageUDF(name, model, preprocessor)`` keeps the reference's
composition contract (``udf/keras_image_model.py``): [image-struct
converter] ∘ [optional preprocessor] ∘ [model] in ONE program, here one
captured CUDA graph on the card (the JAX package: one XLA program).  The
host ships uint8 BGR batches; the BGR -> RGB flip and the cast to float
run inside that program.  ``register_serving_udf`` exposes a running
``serving.Server`` as a column UDF.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# Declared return types -> arrow types for apply()/pandas_udf emission.
_RETURN_TYPES = {
    "array<float>": pa.list_(pa.float32()),
    "array<double>": pa.list_(pa.float64()),
    "float": pa.float32(),
    "double": pa.float64(),
    "int": pa.int64(),
    "bigint": pa.int64(),
    "string": pa.string(),
    "boolean": pa.bool_(),
}


class RegisteredUDF:
    """A vectorized function column -> column."""

    def __init__(self, name: str, fn: Callable[[Sequence], List],
                 returns: str = "array<float>"):
        if returns not in _RETURN_TYPES:
            raise ValueError(f"Unsupported UDF return type {returns!r}; "
                             f"supported: {sorted(_RETURN_TYPES)}")
        self.name = name
        self.fn = fn
        self.returns = returns

    @property
    def arrow_type(self) -> pa.DataType:
        return _RETURN_TYPES[self.returns]

    def __call__(self, column) -> List:
        """column: sequence / pyarrow Array / pandas Series of row values.

        Arrow-aware UDFs (``fn.accepts_arrow``) receive the Arrow column
        as-is — the image path reads struct buffers zero-copy instead of
        round-tripping every row through a Python dict (``to_pylist``).
        """
        if isinstance(column, (pa.Array, pa.ChunkedArray)):
            if getattr(self.fn, "accepts_arrow", False):
                return self.fn(column)
            column = column.to_pylist()
        elif hasattr(column, "tolist") and not isinstance(column, list):
            column = column.tolist()
        return self.fn(list(column))


class UDFRegistry:
    """Process-wide name -> UDF map (the stand-in for Spark's SQL function
    registry; ``spark.sql`` is replaced by ``apply`` over our frames)."""

    def __init__(self):
        self._udfs: Dict[str, RegisteredUDF] = {}

    def register(self, name: str, fn: Callable, returns: str = "array<float>"
                 ) -> RegisteredUDF:
        udf = fn if isinstance(fn, RegisteredUDF) else RegisteredUDF(
            name, fn, returns)
        self._udfs[name] = udf
        logger.info("registered UDF %r", name)
        return udf

    def get(self, name: str) -> RegisteredUDF:
        if name not in self._udfs:
            raise KeyError(f"No UDF named {name!r}; registered: "
                           f"{sorted(self._udfs)}")
        return self._udfs[name]

    def names(self) -> List[str]:
        return sorted(self._udfs)

    def apply(self, name: str, dataset, inputCol: str, outputCol: str):
        """SELECT name(inputCol) AS outputCol equivalent over a DataFrame."""
        udf = self.get(name)
        values = udf(dataset.table.column(inputCol))
        return dataset.withColumn(outputCol, pa.array(
            values, type=udf.arrow_type))

    def to_pandas_udf(self, name: str):
        """Bind to pyspark's pandas_udf when pyspark is installed (the
        reference's registration step; optional here)."""
        try:
            import pandas as pd
            from pyspark.sql.functions import pandas_udf
        except ImportError as e:
            raise ImportError(
                "pyspark is not installed; to_pandas_udf requires it "
                f"({e})") from e
        udf = self.get(name)

        @pandas_udf(udf.returns)
        def _udf(col: "pd.Series") -> "pd.Series":
            return pd.Series(udf(col))

        return _udf


udf_registry = UDFRegistry()
register_udf = udf_registry.register


def _first_valid_hw(column) -> Optional[Tuple[int, int]]:
    """(height, width) of the first non-null struct row, scanning chunk by
    chunk (no combine_chunks — its int32 offsets overflow past 2 GB)."""
    chunks = (column.chunks if isinstance(column, pa.ChunkedArray)
              else [column])
    for ch in chunks:
        valid = np.asarray(ch.is_valid()) if len(ch) else np.zeros(0, bool)
        if valid.any():
            i0 = int(np.nonzero(valid)[0][0])
            return (int(ch.field("height")[i0].as_py()),
                    int(ch.field("width")[i0].as_py()))
    return None


def bgr_uint8_to_rgb_float(x: torch.Tensor) -> torch.Tensor:
    """The image UDF's converter stage, on the device: uint8 BGR (the
    struct's byte order, so host packing stays a memcpy) -> float32 RGB in
    [0, 255], as the reference's converter subgraph did."""
    return x.flip(-1).to(torch.float32)


class _EngineHolder:
    """Plain object whose __dict__ hosts get_cached_engine's cache."""


def register_image_udf(name: str, model_function, *,
                       input_size: Optional[Sequence[int]] = None,
                       preprocessor: Optional[Callable] = None,
                       batch_size: int = 32,
                       registry: Optional[UDFRegistry] = None
                       ) -> RegisteredUDF:
    """Register a ModelFunction as an image-column UDF.

    Per call: image structs are packed on the host into uint8 BGR batches
    (null rows stay null; resized to ``input_size`` where they differ, or
    read at the first valid row's size); then the converter stage, the
    optional ``preprocessor`` (a torch ``batch -> batch`` on the device)
    and the model run as one ModelFunction through the engine, on the
    card unless the CPU was asked for, pipelined under
    ``SPARKDL_PIPELINE``."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch, structsToBatch
    from sparkdl_tpu_torch.parallel.engine import get_cached_engine

    converter = ModelFunction.from_callable(bgr_uint8_to_rgb_float)
    if preprocessor is not None:
        converter = converter.compose(
            ModelFunction.from_callable(preprocessor))
    model_function = converter.compose(model_function)
    holder = _EngineHolder()  # one engine cache per registration

    def _score(batch: np.ndarray, valid_idx, n: int) -> List[Optional[list]]:
        out: List[Optional[list]] = [None] * n
        if batch.shape[0] == 0:
            return out
        eng = get_cached_engine(holder, model_function,
                                device_batch_size=batch_size)
        # pipelined __call__: the upload of piece k+1 overlaps the replay
        # of k and the fetch of k-1, into one preallocated output
        res = np.asarray(eng(batch))
        flat = res.reshape(res.shape[0], -1).astype(np.float32)
        for row_list, i in zip(flat.tolist(), valid_idx):
            out[i] = row_list
        return out

    def fn(rows) -> List[Optional[list]]:
        if isinstance(rows, (pa.Array, pa.ChunkedArray)):
            # zero-copy path: struct buffers -> batch, no dict per row
            if input_size is not None:
                h, w = int(input_size[0]), int(input_size[1])
            else:
                hw = _first_valid_hw(rows)
                if hw is None:
                    return [None] * len(rows)
                h, w = hw
            batch, ok = arrowStructsToBatch(rows, h, w, channel_order="bgr",
                                            compact=True)
            return _score(batch, np.nonzero(ok)[0], len(rows))
        valid_idx = [i for i, r in enumerate(rows) if r is not None]
        if not valid_idx:
            return [None] * len(rows)
        if input_size is not None:
            h, w = int(input_size[0]), int(input_size[1])
        else:
            first = rows[valid_idx[0]]
            h, w = int(first["height"]), int(first["width"])
        # list-of-dicts path: structsToBatch emits RGB; the converter
        # stage expects BGR, so flip back (off the Arrow path)
        batch = structsToBatch([rows[i] for i in valid_idx], h, w)
        return _score(np.ascontiguousarray(batch[..., ::-1]), valid_idx,
                      len(rows))

    fn.accepts_arrow = True

    registry = registry if registry is not None else udf_registry
    return registry.register(name, fn)


def register_serving_udf(name: str, server, *, returns: str = "array<float>",
                         max_admission_retries: int = 100,
                         timeout_ms: float = float("inf"),
                         registry: Optional[UDFRegistry] = None
                         ) -> RegisteredUDF:
    """Register a running ``serving.Server`` as a column UDF.

    Each row becomes ONE request on the server's admission queue, so
    offline column scoring and concurrent online traffic share the same
    micro-batches, deadlines and metrics.  All rows are submitted before
    any result is awaited, so the batcher fills micro-batches.

    Backpressure is honored: a ``QueueFullError`` sleeps the server's
    ``retry_after_s`` hint and resubmits, up to ``max_admission_retries``
    per row.  Null rows stay null.  Offline rows carry NO deadline by
    default (``timeout_ms=inf`` overrides the server's
    ``default_timeout_ms``: an online-sized deadline would shed the tail of
    a bulk submit); pass a finite ``timeout_ms`` to opt back in."""
    import time

    from sparkdl_tpu_torch.serving.errors import QueueFullError

    def _submit_with_backoff(value):
        for _ in range(max(1, int(max_admission_retries))):
            try:
                return server.submit(value, timeout_ms=timeout_ms)
            except QueueFullError as e:
                time.sleep(max(1e-3, e.retry_after_s))
        # final attempt: let rejection raise
        return server.submit(value, timeout_ms=timeout_ms)

    def fn(rows) -> List[Optional[list]]:
        if isinstance(rows, (pa.Array, pa.ChunkedArray)):
            rows = rows.to_pylist()
        out: List[Optional[list]] = [None] * len(rows)
        futures = []
        for i, r in enumerate(rows):
            if r is None:
                continue
            if isinstance(r, (list, tuple)):
                # arrow list rows arrive as Python lists; submit() treats a
                # list as a pytree of scalars, so densify here (struct rows
                # stay dicts: the server's host_preprocess owns those)
                r = np.asarray(r, dtype=np.float32)
            futures.append((i, _submit_with_backoff(r)))
        for i, fut in futures:
            res = np.asarray(fut.result())
            out[i] = [float(v) for v in res.reshape(-1)]
        return out

    registry = registry if registry is not None else udf_registry
    return registry.register(name, fn, returns=returns)


def registerKerasImageUDF(name: str, model_or_file, preprocessor=None,
                          registry: Optional[UDFRegistry] = None
                          ) -> RegisteredUDF:
    """Reference-parity entry (``udf/keras_image_model.py``): register a
    Keras model as an image UDF, the optional ``preprocessor`` (a torch
    ``batch -> batch``) in front.  ``model_or_file``: a ``.h5`` /
    ``.keras`` path, a ``KerasFile`` (a model held as its config and
    arrays), or an object with ``to_json()`` and per-layer
    ``get_weights()``; converted without Keras.  The images are resized to
    the model's input size where its config gives one."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.graph.keras_convert import keras_input_hw

    mf = ModelFunction.from_keras(model_or_file)
    return register_image_udf(
        name, mf, input_size=keras_input_hw(mf.module.model_config),
        preprocessor=preprocessor, registry=registry)
