"""Adapters: make existing pipeline stages servable (port of
``sparkdl_tpu/serving/adapters.py``).

``from_transformer`` lifts the batch-oriented stages (zoo transformers,
``TFImageTransformer``, ``ModelTransformer`` / ``KerasTransformer``) into a
running :class:`~sparkdl_tpu_torch.serving.server.Server`: the stage
supplies the model (same weights, same preprocess, same cached zoo loads)
and its ``batchSize`` seeds ``max_batch_size``; the serving layer adds the
queue, dynamic batching, deadlines and backpressure.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.serving.server import Server


def _image_request_preprocess(height: int, width: int):
    """Host-side request prep for image servers: an image-struct dict (the
    DataFrame wire format) or a ``[H, W, 3]`` uint8 RGB array, resized to
    the model's input size where needed.  Runs on the SUBMITTER's thread
    (``Server.host_preprocess``), never the dispatcher."""
    from sparkdl_tpu_torch.image.io import resizeImage, structToModelInput

    def pre(example: Any) -> np.ndarray:
        if isinstance(example, dict):  # image struct (origin/height/...)
            return structToModelInput(example, height, width).astype(
                np.uint8)
        arr = np.asarray(example)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(
                f"image request must be [H, W, 3] RGB (or an image "
                f"struct dict), got shape {arr.shape}")
        if arr.shape[:2] != (height, width):
            arr = resizeImage(arr.astype(np.uint8), height, width)
        return arr.astype(np.uint8)

    return pre


def _vector_request_preprocess(example: Any) -> np.ndarray:
    """Tensor-stage requests are 1-D float rows (the reference's
    KerasTransformer contract)."""
    return np.asarray(example, dtype=np.float32)


def from_transformer(transformer, **server_kwargs) -> Server:
    """Build a running :class:`Server` from a configured transformer
    stage::

        t = DeepImageFeaturizer(inputCol="image", outputCol="features",
                                modelName="Xception")
        with serving.from_transformer(t, max_wait_ms=3) as srv:
            vec = srv.predict(rgb_array)      # the row transform() emits

    Supported stages (each keeps its engine semantics and contributes
    ``batchSize`` as the default ``max_batch_size``):

    * ``DeepImageFeaturizer`` / ``DeepImagePredictor``: requests are
      ``[H, W, 3]`` uint8 RGB arrays or image-struct dicts (resized on the
      submitter's thread); results are the feature / probability rows.
    * ``TFImageTransformer``: the same request forms, through the stage's
      ``ModelFunction`` (resized to ``inputSize`` when it is set).
    * ``ModelTransformer`` / ``KerasTransformer``: requests are 1-D float
      arrays.

    Extra ``server_kwargs`` pass through to :class:`Server`.
    """
    from sparkdl_tpu_torch.transformers.named_image import (
        TFImageTransformer, _NamedImageTransformer, get_model_spec)
    from sparkdl_tpu_torch.transformers.tensor import ModelTransformer

    if isinstance(transformer, _NamedImageTransformer):
        name = transformer.getModelName()
        h, w = get_model_spec(name).input_size
        server_kwargs.setdefault("max_batch_size",
                                 int(transformer.getBatchSize()))
        server_kwargs.setdefault("host_preprocess",
                                 _image_request_preprocess(h, w))
        return Server(name, featurize=transformer.featurize,
                      **server_kwargs)
    if isinstance(transformer, TFImageTransformer):
        size = _tf_image_input_size(transformer)
        server_kwargs.setdefault("max_batch_size",
                                 int(transformer.getBatchSize()))
        if size is not None:
            server_kwargs.setdefault("host_preprocess",
                                     _image_request_preprocess(*size))
        return Server(transformer.getModelFunction(), **server_kwargs)
    if isinstance(transformer, ModelTransformer):
        server_kwargs.setdefault("max_batch_size",
                                 int(transformer.getBatchSize()))
        server_kwargs.setdefault("host_preprocess",
                                 _vector_request_preprocess)
        return Server(transformer.getModelFunction(), **server_kwargs)
    raise TypeError(
        f"from_transformer supports the zoo/image/tensor inference stages, "
        f"not {type(transformer).__name__}")


def _tf_image_input_size(transformer) -> Optional[Tuple[int, int]]:
    if transformer.isDefined(transformer.inputSize):
        h, w = (int(v) for v in
                transformer.getOrDefault(transformer.inputSize))
        return h, w
    return None
