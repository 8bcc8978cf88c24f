"""Shared utilities: logging, metrics (the registry, the step timer, the
throughput shape), bounded caches, prefetch, the loss check, crash-safe JSONL (port of
``sparkdl_tpu.utils``)."""

from sparkdl_tpu_torch.utils.cache import BoundedCache, ByteBoundedLRU
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import (Metrics, StepTimer,
                                             throughput_counter)

__all__ = ["BoundedCache", "ByteBoundedLRU", "Metrics", "StepTimer",
           "get_logger", "throughput_counter"]
