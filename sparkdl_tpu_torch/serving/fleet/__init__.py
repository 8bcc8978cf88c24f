"""sparkdl_tpu_torch.serving.fleet: multi-tenant, versioned model-fleet
serving with zero-downtime hot-swap (port of ``sparkdl_tpu.serving.fleet``).

A :class:`~.registry.ModelRegistry` of named entries with monotonically
numbered :class:`~.registry.ModelVersion` s (weights only, as a
``state_dict``, over the entry's one resolved fn), per-version
:class:`~sparkdl_tpu_torch.serving.server.Server` s (each version its own
module copy, captured engines and graph pool), :class:`~.rollout.Rollout`
canary -> promote/rollback transitions that never fail an in-flight
request and capture no bucket again, and an
:class:`~.admission.AdmissionController` of per-tenant token-bucket
quotas, in-flight caps and shed-lowest-priority-first classes layered on
the servers' own backpressure errors.

Fault sites: ``fleet.admit``, ``fleet.canary``, ``fleet.swap``; span:
``fleet.request`` tagged with model, version and tenant; flight events
``rollout.start`` / ``rollout.promote`` / ``rollout.rollback`` and
``fleet.shed``; metrics: ``fleet.*`` counters plus per-model and
per-tenant ledgers in :meth:`~.fleet.Fleet.varz`.
"""

from sparkdl_tpu_torch.serving.errors import QuotaExceededError
from sparkdl_tpu_torch.serving.fleet.admission import (DEFAULT_SHED_PRESSURE,
                                                       PRIORITY_HIGH,
                                                       PRIORITY_LOW,
                                                       PRIORITY_NORMAL,
                                                       AdmissionController,
                                                       TenantQuota)
from sparkdl_tpu_torch.serving.fleet.fleet import Fleet
from sparkdl_tpu_torch.serving.fleet.registry import (FleetEntry,
                                                      ModelRegistry,
                                                      ModelVersion)
from sparkdl_tpu_torch.serving.fleet.rollout import Rollout

__all__ = [
    "Fleet",
    "ModelRegistry",
    "ModelVersion",
    "FleetEntry",
    "Rollout",
    "AdmissionController",
    "TenantQuota",
    "QuotaExceededError",
    "PRIORITY_LOW",
    "PRIORITY_NORMAL",
    "PRIORITY_HIGH",
    "DEFAULT_SHED_PRESSURE",
]
