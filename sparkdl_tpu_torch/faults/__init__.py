"""sparkdl_tpu_torch.faults — deterministic fault injection (port of
``sparkdl_tpu/faults``).

* :class:`FaultPlan` — a seeded set of rules, parsed from a
  ``SPARKDL_FAULTS`` spec string (grammar in
  :mod:`~sparkdl_tpu_torch.faults.spec`) or built directly in tests.
* :func:`inject` — the hook the engine (``engine.dispatch``,
  ``engine.gather``), the pipelined runner (``pipeline.prepare``,
  ``pipeline.dispatch``, ``pipeline.gather``) and the serving layer
  (``serving.admit``, ``serving.model``, ``batch.topoff``, ``cache.hit``,
  ``cache.stampede``, and the head bank's ``head.swap`` and
  ``head.dispatch``), the fleet (``fleet.*``) and the stream scorer
  (``stream.source``, ``stream.commit``, ``stream.resume``) call.  With no plan active it
  is one global read and a ``None`` check.
* The error taxonomy (:mod:`~sparkdl_tpu_torch.faults.errors`).

::

    plan = faults.FaultPlan.parse(
        "seed=7;engine.dispatch:error:exc=transient,at=2")
    with faults.active(plan):
        run_workload()
    assert plan.fired("engine.dispatch") == 1
"""

from sparkdl_tpu_torch.faults.errors import (InjectedDeadDeviceError,
                                             InjectedDecodeError,
                                             InjectedFault,
                                             InjectedFatalError,
                                             InjectedTransientError)
from sparkdl_tpu_torch.faults.plan import (FaultPlan, active, clear,
                                           configure, configure_from_env,
                                           current_spec, get_plan, has_rules,
                                           inject)
from sparkdl_tpu_torch.faults.sites import SITE_HELP, validate_site
from sparkdl_tpu_torch.faults.spec import (ACTIONS, SITES, FaultRule,
                                           faults_from_env, format_spec,
                                           parse_spec)

__all__ = [
    "FaultPlan", "FaultRule", "SITES", "SITE_HELP", "validate_site",
    "ACTIONS", "inject", "has_rules", "active", "configure",
    "configure_from_env", "clear", "get_plan", "current_spec", "parse_spec",
    "format_spec", "faults_from_env", "InjectedFault",
    "InjectedTransientError", "InjectedDeadDeviceError",
    "InjectedFatalError", "InjectedDecodeError",
]
