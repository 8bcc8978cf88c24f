"""Typed, string-addressable parameter system (port of ``sparkdl_tpu.param``)."""

from sparkdl_tpu_torch.param.params import (
    Param,
    Params,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.param.shared import (
    HasInputCol,
    HasOutputCol,
    HasBatchSize,
    HasModelName,
    HasTopK,
    HasLabelCol,
    HasOutputMode,
    CanLoadImage,
)
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters

__all__ = [
    "Param",
    "Params",
    "TypeConverters",
    "keyword_only",
    "SparkDLTypeConverters",
    "HasInputCol",
    "HasOutputCol",
    "HasBatchSize",
    "HasModelName",
    "HasTopK",
    "HasLabelCol",
    "HasOutputMode",
    "CanLoadImage",
]
