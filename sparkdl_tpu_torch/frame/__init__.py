"""Arrow-backed columnar DataFrame (port of ``sparkdl_tpu.frame``)."""

from sparkdl_tpu_torch.frame.dataframe import DataFrame, Row

__all__ = ["DataFrame", "Row"]
