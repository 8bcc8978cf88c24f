"""Batch inference engine, pipelined runner and single-device fits (port
of ``sparkdl_tpu.parallel``).  The device mesh (``get_mesh``,
``batch_sharding``, ``replicated_sharding``) and ``distributed`` are not
ported yet (ROADMAP.md queue A item 4)."""

from sparkdl_tpu_torch.parallel.engine import (CircuitOpenError,
                                               DispatchCircuitBreaker,
                                               InferenceEngine)
from sparkdl_tpu_torch.parallel.pipeline import (PipelinedRunner,
                                                 PipelineStageError,
                                                 PipelineStageFatalError,
                                                 pipeline_enabled_from_env)

__all__ = [
    "CircuitOpenError",
    "DispatchCircuitBreaker",
    "InferenceEngine",
    "PipelinedRunner",
    "PipelineStageError",
    "PipelineStageFatalError",
    "pipeline_enabled_from_env",
]
