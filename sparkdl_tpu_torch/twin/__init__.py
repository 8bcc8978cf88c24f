"""Traffic twin (port of ``sparkdl_tpu/twin``): deterministic virtual-time
load simulation plus closed-loop capacity and placement control over the
port's REAL fleet.

Public surface::

    from sparkdl_tpu_torch.twin import (ScenarioConfig, run_day,
                                        StaticPolicy, QuotaAutoscaler,
                                        plan_placement)

    result = run_day(ScenarioConfig(seed=16),
                     policy=QuotaAutoscaler(DEFAULT_TENANT_QUOTA))
    result.scores["slo_minutes"]     # what the day cost
    result.event_digest              # byte-identical across runs, and
                                     # equal to the JAX package's day

The day runs on the card unless the CPU is asked for (``device="cpu"`` or
``sparkdl_tpu_torch.default_device("cpu")``).
"""

from sparkdl_tpu_torch.twin.clock import VirtualClock
from sparkdl_tpu_torch.twin.placement import (MeshSlice, ModelPlacement,
                                              PlacementError, PlacementPlan,
                                              plan_placement)
from sparkdl_tpu_torch.twin.policy import (Policy, PolicyDecision,
                                           QuotaAutoscaler, StaticPolicy,
                                           TickObservation)
from sparkdl_tpu_torch.twin.scenario import Arrivals, Scenario, ScenarioConfig
from sparkdl_tpu_torch.twin.sim import (DEFAULT_TENANT_QUOTA, TrafficTwin,
                                        TwinResult, run_day)

__all__ = [
    "VirtualClock",
    "MeshSlice", "ModelPlacement", "PlacementError", "PlacementPlan",
    "plan_placement",
    "Policy", "PolicyDecision", "QuotaAutoscaler", "StaticPolicy",
    "TickObservation",
    "Arrivals", "Scenario", "ScenarioConfig",
    "DEFAULT_TENANT_QUOTA", "TrafficTwin", "TwinResult", "run_day",
]
