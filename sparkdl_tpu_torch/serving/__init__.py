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

* :class:`HeadFanoutServer`: one backbone ``Server`` at the feature cut,
  a feature-cut cache namespace and a stacked bank of per-tenant heads
  (kernel H1): a warm content digest costs a head pass only.
* :class:`Fleet` (``sparkdl_tpu_torch.serving.fleet``): the multi-model,
  multi-tenant front door: named versioned registry entries
  (:class:`ModelRegistry`, :class:`ModelVersion`), zero-downtime canary
  rollouts (:class:`Rollout`) with each version on its own captured
  engines, per-tenant token-bucket quotas and priority classes
  (:class:`TenantQuota`, :class:`QuotaExceededError`), aggregated
  ``Fleet.varz()`` / ``health()``.
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
from sparkdl_tpu_torch.serving.server import (HeadFanoutServer, Server,
                                              bucket_plan)
# the fleet package imports serving.server and serving.errors, so it comes
# last here
from sparkdl_tpu_torch.serving.fleet import (Fleet, ModelRegistry,
                                             ModelVersion, Rollout,
                                             TenantQuota)

__all__ = [
    "Server",
    "HeadFanoutServer",
    "bucket_plan",
    "InferenceCache",
    "from_transformer",
    "DynamicBatcher",
    "Request",
    "Fleet",
    "ModelRegistry",
    "ModelVersion",
    "Rollout",
    "TenantQuota",
    "ServingError",
    "QueueFullError",
    "QuotaExceededError",
    "DeadlineExceededError",
    "DispatchTimeoutError",
    "ServiceUnavailableError",
    "ServerClosedError",
]
