"""Shared utilities: logging, metrics, bounded caches, prefetch, the loss
check (port of ``sparkdl_tpu.utils``).  ``StepTimer`` and
``throughput_counter`` are not ported yet (ROADMAP.md queue A item 6)."""

from sparkdl_tpu_torch.utils.cache import BoundedCache, ByteBoundedLRU
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

__all__ = ["BoundedCache", "ByteBoundedLRU", "Metrics", "get_logger"]
