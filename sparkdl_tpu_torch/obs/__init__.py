"""sparkdl_tpu_torch.obs: span tracing, metrics export, slow-request
exemplars, the flight recorder, SLOs and the cost ledger for the scoring
and serving stack (port of ``sparkdl_tpu.obs``, the same names and env
gates).

* :mod:`~sparkdl_tpu_torch.obs.trace`: :class:`Tracer` and spans, the
  ``SPARKDL_TRACE=0|1|dir`` gate (the disabled path hands out the no-op
  :data:`NULL_SPAN` and creates no CUDA event).
* :mod:`~sparkdl_tpu_torch.obs.export`: Chrome trace-event JSON, span
  JSONL, Prometheus text and JSONL snapshots of the
  :class:`~sparkdl_tpu_torch.utils.metrics.Metrics` registry.
* :mod:`~sparkdl_tpu_torch.obs.exemplar`: the top-K slowest request span
  trees, surfaced by ``Server.varz()``.
* :mod:`~sparkdl_tpu_torch.obs.flight`: the :class:`FlightRecorder`
  black box (``SPARKDL_BLACKBOX=0|1|dir``), dumped at atexit, on SIGTERM
  and on every ready->degraded transition.
* :mod:`~sparkdl_tpu_torch.obs.slo`: declarative SLOs with multi-window
  burn rates, feeding ``HealthTracker`` degradation and
  ``Server.health()["slo"]``.
* :mod:`~sparkdl_tpu_torch.obs.cost`: the :class:`CostLedger`
  (``SPARKDL_COST``) and its perf-regression sentinel.

Instrumented surfaces: ``serving.Server`` / ``DynamicBatcher`` (request
and micro-batch spans; shed, drain and ``batch.topoff`` events; exemplars;
``slos=``; ``cost=``), ``serving.HeadFanoutServer`` (``cost=``,
``cache.feature_hit``), ``parallel.engine.InferenceEngine``
(``engine.call`` / ``engine.dispatch`` spans, ``device_ms`` from CUDA
timing events; breaker events), ``parallel.engine.HeadBank`` (``head.swap``),
``parallel.pipeline.PipelinedRunner`` (``pipeline.*`` spans),
``serving.cache.InferenceCache`` (``cache.*`` events),
``utils.health.HealthTracker`` (``health.*``), ``faults``
(``fault.fired``) and ``utils.retry`` (``retry.attempt``).
"""

from sparkdl_tpu_torch.obs.exemplar import ExemplarReservoir
from sparkdl_tpu_torch.obs.export import (load_spans, metrics_snapshot,
                                          prometheus_text, to_chrome_trace,
                                          write_chrome_trace,
                                          write_metrics_jsonl,
                                          write_spans_jsonl)
from sparkdl_tpu_torch.obs.trace import (NULL_SPAN, Span, Tracer, configure,
                                         configure_from_env,
                                         current_trace_id, get_tracer,
                                         tracing_from_env)
from sparkdl_tpu_torch.obs import flight
from sparkdl_tpu_torch.obs import slo as slo_module  # noqa: F401 — re-export
from sparkdl_tpu_torch.obs import cost as cost_module  # noqa: F401 — re-export
from sparkdl_tpu_torch.obs.cost import (CostLedger, CostRegression,
                                        cost_rider, resolve_cost)
from sparkdl_tpu_torch.obs.flight import FlightRecorder, blackbox_from_env
from sparkdl_tpu_torch.obs.slo import (SLO, SLOEngine, SLOViolation,
                                       slo_snapshot)

__all__ = [
    "Tracer",
    "Span",
    "NULL_SPAN",
    "get_tracer",
    "configure",
    "configure_from_env",
    "current_trace_id",
    "tracing_from_env",
    "to_chrome_trace",
    "write_chrome_trace",
    "write_spans_jsonl",
    "load_spans",
    "metrics_snapshot",
    "write_metrics_jsonl",
    "prometheus_text",
    "ExemplarReservoir",
    "flight",
    "FlightRecorder",
    "blackbox_from_env",
    "SLO",
    "SLOEngine",
    "SLOViolation",
    "slo_snapshot",
    "CostLedger",
    "CostRegression",
    "cost_rider",
    "resolve_cost",
]
