"""sparkdl_tpu_torch.serving — online inference over the engine (port of
``sparkdl_tpu.serving``).

Where transformers and UDFs score whole DataFrames, this package serves
SINGLE requests under load: an async dynamic-batching front end over the
same :class:`~sparkdl_tpu_torch.parallel.engine.InferenceEngine`, with
deadlines, backpressure, fault isolation, graceful drain, a result cache
and latency/throughput metrics.

Public surface:

* :class:`Server`: ``Server(model, module=None, ...)`` takes a zoo model
  name, a ``ModelFunction``, or a ``fn(module, batch)`` with its module.
* :func:`from_transformer`: lift a zoo/image/tensor stage into a server.
* ``register_serving_udf`` (``sparkdl_tpu_torch.udf``): a running server
  as a column UDF, so offline scoring shares the online queue.
* :class:`InferenceCache`: the content-addressed result cache with
  single-flight coalescing.
* The error taxonomy: :class:`QueueFullError`,
  :class:`DeadlineExceededError`, :class:`DispatchTimeoutError`,
  :class:`ServiceUnavailableError`, :class:`ServerClosedError` (and the
  fleet's :class:`QuotaExceededError`).

Not ported yet (ROADMAP.md queue A): ``HeadFanoutServer`` (the next
serving slice) and the fleet (``Fleet``, ``ModelRegistry``,
``ModelVersion``, ``Rollout``, ``TenantQuota``).
"""

from sparkdl_tpu_torch.serving.adapters import from_transformer
from sparkdl_tpu_torch.serving.batcher import DynamicBatcher, Request
from sparkdl_tpu_torch.serving.cache import InferenceCache
from sparkdl_tpu_torch.serving.errors import (DeadlineExceededError,
                                              DispatchTimeoutError,
                                              QueueFullError,
                                              QuotaExceededError,
                                              ServerClosedError,
                                              ServiceUnavailableError,
                                              ServingError)
from sparkdl_tpu_torch.serving.server import Server, bucket_plan

__all__ = [
    "Server",
    "bucket_plan",
    "InferenceCache",
    "from_transformer",
    "DynamicBatcher",
    "Request",
    "ServingError",
    "QueueFullError",
    "QuotaExceededError",
    "DeadlineExceededError",
    "DispatchTimeoutError",
    "ServiceUnavailableError",
    "ServerClosedError",
]
