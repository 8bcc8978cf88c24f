"""Observability (port of ``sparkdl_tpu.obs``): so far only the metrics
snapshot of :mod:`~sparkdl_tpu_torch.obs.export`, which ``Server.varz``
embeds.  Tracing, the flight recorder, exemplars, SLOs and the cost ledger
wait for ROADMAP.md queue A's observability item."""

from sparkdl_tpu_torch.obs.export import metrics_snapshot

__all__ = ["metrics_snapshot"]
