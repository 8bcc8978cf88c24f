"""Batch inference engine, pipelined runner, the device mesh and its
sharding policy, multi-process bootstrap and the fits (port of
``sparkdl_tpu.parallel``)."""

from sparkdl_tpu_torch.parallel.mesh import (batch_sharding, get_mesh,
                                             replicated_sharding)
from sparkdl_tpu_torch.parallel.engine import (CircuitOpenError,
                                               DispatchCircuitBreaker,
                                               InferenceEngine)
from sparkdl_tpu_torch.parallel.pipeline import (PipelinedRunner,
                                                 PipelineStageError,
                                                 PipelineStageFatalError,
                                                 pipeline_enabled_from_env)
from sparkdl_tpu_torch.parallel import distributed

__all__ = [
    "CircuitOpenError",
    "DispatchCircuitBreaker",
    "InferenceEngine",
    "PipelinedRunner",
    "PipelineStageError",
    "PipelineStageFatalError",
    "batch_sharding",
    "distributed",
    "get_mesh",
    "pipeline_enabled_from_env",
    "replicated_sharding",
]
