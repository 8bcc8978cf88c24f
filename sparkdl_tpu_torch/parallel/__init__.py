"""Batch inference engine (port of ``sparkdl_tpu.parallel``)."""
