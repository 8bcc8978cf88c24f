"""Batch inference engine and head fits (port of ``sparkdl_tpu.parallel``)."""
