"""Card-memory-aware placement planner, the twin's control-plane half (b)
(port of ``sparkdl_tpu/twin/placement.py``).

Given the fleet's registered models (name -> param tree: a dict of arrays,
anything with ``shape`` and ``dtype`` leaves, or an ``nn.Module``, whose
tree is its ``state_dict``; the planner never needs real bytes), a
per-card memory budget and a total card budget, decide for EVERY model:

* which slice shape it runs on (``model_parallel`` in ``slice_chips``):
  the smallest tensor-parallel degree whose per-card footprint (from the
  port's ``param_sharding_stats`` under the port's partition rules) fits
  the per-card budget after ``reserve_fraction`` is held back for
  activations and runtime;
* whether that choice actually shards (``partition_digest`` not
  ``"replicated"``) or degenerates to replication (small models on a
  one-card slice, the cheap, classic layout);

then first-fit-decreasing bin-pack the chosen slices onto hosts of
``slice_chips[-1]`` cards so same-degree models share hosts, and verify the
whole plan against the card budget.  Infeasible demands (a model that fits
no allowed slice, or a plan needing more cards than the budget) raise
:class:`PlacementError`.

The planner needs no device: mesh geometry enters only through
:class:`MeshSlice`, a shape-only stand-in exposing the ``.shape[axis]`` /
``.axis_names`` surface the mesh helpers read, so the code paths that
resolve a real engine's policy (``default_partition_rules`` ->
``match_partition_rules`` -> ``spec_shards_leaf`` ->
``param_sharding_stats`` -> ``partition_digest``) run on the CPU.  For the
same entries a plan's ``as_dict()`` and ``digest()`` equal the JAX
package's.  The argument names keep the JAX package's ``chip`` spelling:
here a chip is one card.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                             default_partition_rules,
                                             match_partition_rules,
                                             param_sharding_stats,
                                             partition_digest)

__all__ = ["MeshSlice", "ModelPlacement", "PlacementPlan",
           "PlacementError", "plan_placement"]


class PlacementError(RuntimeError):
    """A model or plan that cannot fit the declared budgets."""


class MeshSlice:
    """Shape-only mesh stand-in: ``shape[axis]`` + ``axis_names`` is the
    whole surface the partition-rule/stats helpers consume, so planning
    math runs device-free and identically to a real ``Mesh`` of the
    same geometry."""

    def __init__(self, data: int = 1, model: int = 1):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got "
                             f"data={data} model={model}")
        self.shape = {DATA_AXIS: int(data), MODEL_AXIS: int(model)}
        self.axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def chips(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def __repr__(self) -> str:
        return (f"MeshSlice(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]})")


@dataclass
class ModelPlacement:
    """One model's resolved slot in the plan."""

    model: str
    model_parallel: int
    chips: int
    host: int
    replicated: bool
    partition_digest: str
    stats: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {"model": self.model,
                "model_parallel": self.model_parallel,
                "chips": self.chips, "host": self.host,
                "replicated": self.replicated,
                "partition_digest": self.partition_digest,
                "param_bytes_per_chip":
                    self.stats["param_bytes_per_chip"]}


@dataclass
class PlacementPlan:
    """The whole fleet's placement + the budget it was proven under."""

    placements: List[ModelPlacement]
    chip_hbm_bytes: int
    usable_hbm_bytes: int
    total_chip_budget: int
    chips_used: int
    hosts: List[List[str]] = field(default_factory=list)

    def digest(self) -> str:
        """Content digest of the plan — two runs of one seeded day must
        agree on it byte-for-byte."""
        doc = {"budget": [self.chip_hbm_bytes, self.total_chip_budget],
               "placements": [p.as_dict() for p in self.placements]}
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def as_dict(self) -> Dict[str, Any]:
        return {"chip_hbm_bytes": self.chip_hbm_bytes,
                "usable_hbm_bytes": self.usable_hbm_bytes,
                "total_chip_budget": self.total_chip_budget,
                "chips_used": self.chips_used,
                "hosts": [list(h) for h in self.hosts],
                "digest": self.digest(),
                "placements": [p.as_dict() for p in self.placements]}


def _fit_slice(name: str, params: Any, usable: int,
               slice_chips: Sequence[int], rules
               ) -> Tuple[int, bool, str, Dict[str, Any]]:
    """Smallest allowed ``model_parallel`` degree whose per-chip bytes
    (REAL stats under the REAL rules) fit ``usable``."""
    last_stats: Optional[Dict[str, Any]] = None
    for m in slice_chips:
        mesh = MeshSlice(data=1, model=m)
        rule_list = rules(mesh) if callable(rules) else rules
        if rule_list is None:
            rule_list = default_partition_rules(mesh)
        specs = match_partition_rules(rule_list, params)
        stats = param_sharding_stats(mesh, params, specs)
        last_stats = stats
        if stats["param_bytes_per_chip"] <= usable:
            digest = partition_digest(specs)
            return m, digest == "replicated", digest, stats
    assert last_stats is not None
    raise PlacementError(
        f"model {name!r} fits no allowed slice: per-chip "
        f"{last_stats['param_bytes_per_chip']}B at model_parallel="
        f"{slice_chips[-1]} exceeds usable {usable}B "
        f"(largest replicated leaf "
        f"{last_stats['largest_replicated_leaf_bytes']}B — a finer "
        f"partition rule may unlock a deeper split)")


def plan_placement(entries: Dict[str, Any], *,
                   chip_hbm_bytes: int,
                   total_chip_budget: int,
                   slice_chips: Sequence[int] = (1, 2, 4, 8),
                   rules=None,
                   reserve_fraction: float = 0.25) -> PlacementPlan:
    """Plan the fleet onto mesh slices under the declared budgets.

    ``entries`` — model name -> param tree (a dict of arrays or of
    leaves with ``shape`` and ``dtype``, or an ``nn.Module``).  ``slice_chips`` — the allowed
    tensor-parallel degrees, ascending.  ``rules`` — partition rules
    (or ``mesh -> rules`` factory); default
    :func:`default_partition_rules`.  ``reserve_fraction`` of each
    chip's memory is held back for activations, the captured graphs,
    and runtime scratch.

    Packing: models group by chosen degree and first-fit-decreasing
    (by per-chip bytes) into hosts of ``max(slice_chips)`` chips —
    co-resident models on one host share its chips, so their per-chip
    footprints ADD and the sum must stay under the usable budget.
    """
    if chip_hbm_bytes <= 0 or total_chip_budget <= 0:
        raise ValueError("chip_hbm_bytes and total_chip_budget must be "
                         "positive")
    if not entries:
        raise ValueError("no models to place")
    slice_chips = sorted(int(m) for m in slice_chips)
    if slice_chips[0] < 1:
        raise ValueError(f"slice_chips must be >= 1, got {slice_chips}")
    if not 0.0 <= reserve_fraction < 1.0:
        raise ValueError(f"reserve_fraction must be in [0, 1), got "
                         f"{reserve_fraction}")
    usable = int(chip_hbm_bytes * (1.0 - reserve_fraction))

    chosen: List[ModelPlacement] = []
    for name in sorted(entries):
        m, replicated, digest, stats = _fit_slice(
            name, entries[name], usable, slice_chips, rules)
        chosen.append(ModelPlacement(
            model=name, model_parallel=m, chips=m, host=-1,
            replicated=replicated, partition_digest=digest, stats=stats))

    # First-fit-decreasing within each degree group: a host is
    # max(slice_chips) chips; a model of degree m claims m of them and
    # co-residents stack their per-chip bytes on the shared chips.
    host_chips = slice_chips[-1]
    hosts: List[Dict[str, Any]] = []  # {free_chips, per_chip_used, models}
    for p in sorted(chosen,
                    key=lambda p: (-p.model_parallel,
                                   -p.stats["param_bytes_per_chip"],
                                   p.model)):
        need = p.stats["param_bytes_per_chip"]
        placed = False
        for i, h in enumerate(hosts):
            if (h["free_chips"] >= p.chips
                    and h["per_chip_used"] + need <= usable):
                h["free_chips"] -= p.chips
                h["per_chip_used"] += need
                h["models"].append(p.model)
                p.host = i
                placed = True
                break
        if not placed:
            hosts.append({"free_chips": host_chips - p.chips,
                          "per_chip_used": need, "models": [p.model]})
            p.host = len(hosts) - 1

    chips_used = len(hosts) * host_chips
    if chips_used > total_chip_budget:
        raise PlacementError(
            f"plan needs {chips_used} chips ({len(hosts)} hosts x "
            f"{host_chips}) but the budget is {total_chip_budget}; "
            f"raise the budget, allow deeper slices, or drop models")

    chosen.sort(key=lambda p: p.model)
    plan = PlacementPlan(
        placements=chosen, chip_hbm_bytes=int(chip_hbm_bytes),
        usable_hbm_bytes=usable,
        total_chip_budget=int(total_chip_budget),
        chips_used=chips_used,
        hosts=[list(h["models"]) for h in hosts])
    flight_emit("placement.plan", models=len(chosen),
                chips_used=chips_used, hosts=len(hosts),
                digest=plan.digest()[:16])
    return plan
