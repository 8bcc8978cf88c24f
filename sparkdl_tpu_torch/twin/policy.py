"""Closed-loop capacity policy, the twin's control-plane half (a) (port of
``sparkdl_tpu/twin/policy.py``).

A :class:`Policy` looks at ONE deterministic per-tick observation
(:class:`TickObservation`, distilled by the simulator from ``varz()``
and the fleet SLO engine's burn rates) and returns a
:class:`PolicyDecision` — a list of lever adjustments the simulator
applies to the REAL fleet before the next tick's arrivals:

* ``quota``   — a tenant's token-bucket ``rate_per_s``/``burst``
  (applied via ``AdmissionController.set_quota``; the re-seeded bucket
  gives raised tenants instant burst headroom);
* ``deadline``— the submit ``timeout_ms`` for the next tick's traffic
  (the ragged-deadline knob);
* ``canary``  — the live rollout's traffic ``fraction`` (or a
  ``promote`` once it has soaked clean);
* ``bucket_plan`` — an ADVISORY compiled-bucket recommendation from
  the observed flush sizes (recorded in the decision; recompiling a
  live server mid-day is exactly the thing real fleets schedule for
  the next rollout, so the twin records rather than applies it).

Determinism contract: ``decide`` must be a pure function of the
observation stream (plus its own accumulated state) — no RNG, no wall
clock — so two runs of one seed produce identical decisions and the
decision record can be byte-compared across runs.

Policies are scored (sim.py) on SLO-minutes burned, goodput, and
per-tenant fairness; :class:`StaticPolicy` is the do-nothing baseline
every adaptive policy must beat.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.serving.fleet.admission import TenantQuota

__all__ = ["TickObservation", "PolicyDecision", "Policy", "StaticPolicy",
           "QuotaAutoscaler"]


@dataclass
class TickObservation:
    """What a policy may legally see: the deterministic distillation of
    one tick (racy diagnostics like queue depths stay in ``varz`` and
    out of here — the determinism contract above)."""

    tick: int
    vt: float                       # virtual time at tick END
    arrivals: int
    admitted: int
    completed: int
    shed_total: int
    shed_by_reason: Dict[str, int]
    shed_by_tenant: Dict[str, int]  # tenant name -> sheds this tick
    slo_state: str                  # "ok" | "breach" | "no_data"
    burn_short: Optional[float]
    burn_long: Optional[float]
    canary_active: bool = False
    canary_fraction: float = 0.0
    flush_sizes: Dict[int, int] = field(default_factory=dict)
    #: cumulative per-tenant measured cost: deterministic cost units —
    #: the ledger's attributed FLOPs where a program has them in the
    #: program lockfile, plain rows otherwise (the twin's dense model has
    #: no audited program in either package) — so
    #: fairness is scored on what tenants actually burned, not on
    #: request counts, while the byte-compared event stream stays free
    #: of wall-clock values (the determinism contract above)
    cost_by_tenant: Dict[str, float] = field(default_factory=dict)


@dataclass
class PolicyDecision:
    """An ordered list of lever adjustments (canonical dicts — the
    simulator applies them in order and folds them verbatim into the
    byte-compared event record)."""

    adjustments: List[Dict[str, Any]] = field(default_factory=list)

    def add(self, lever: str, **kv: Any) -> None:
        self.adjustments.append({"lever": lever, **kv})

    def __bool__(self) -> bool:
        return bool(self.adjustments)


class Policy:
    """Base policy: fixed deadline, no adjustments."""

    name = "static"

    def __init__(self, *, deadline_ms: float = 750_000.0):
        #: submit timeout for the next tick's traffic, in VIRTUAL ms
        self.deadline_ms = float(deadline_ms)

    def decide(self, obs: TickObservation) -> PolicyDecision:
        return PolicyDecision()


class StaticPolicy(Policy):
    """The scored baseline: whatever quotas the fleet was born with."""


class QuotaAutoscaler(Policy):
    """Burn-rate-driven quota autoscaler + canary shepherd.

    Control law, evaluated once per tick on the PREVIOUS tick's
    observation:

    * while the availability SLO is burning (breach, or short-window
      burn at/above ``burn_trigger``) every tenant shed for quota last
      tick gets its rate and burst multiplied by ``step`` (capped at
      ``max_scale`` × base) — shed traffic under burn means the quota,
      not capacity, is the bottleneck (the twin's no-race envelope
      keeps real queue pressure far from saturation, mirroring a fleet
      with chip headroom);
    * once the burn clears, scaled tenants decay by ``step`` per clean
      tick back toward 1× (quota hygiene: the crowd's grant must not
      become the new normal);
    * deadlines widen ``deadline_stretch`` × while burning (trade tail
      latency for goodput), and relax back when clean;
    * a live canary holds its fraction during burn, grows by
      ``canary_step`` per clean tick, and is promoted after it reaches
      1.0 — so an incident freezes the rollout instead of riding it;
    * every tick it re-derives an advisory ``bucket_plan`` from the
      observed flush-size histogram (largest power of two covering the
      p95 flush, plus the baseline residual buckets).
    """

    name = "quota-autoscaler"

    def __init__(self, base_quota: TenantQuota, *,
                 deadline_ms: float = 750_000.0,
                 step: float = 2.0, max_scale: float = 8.0,
                 burn_trigger: float = 14.4,
                 deadline_stretch: float = 1.5,
                 canary_step: float = 0.25,
                 cost_share_cap: Optional[float] = None):
        super().__init__(deadline_ms=deadline_ms)
        if base_quota.rate_per_s is None:
            raise ValueError("QuotaAutoscaler needs a rate-limited "
                             "base quota to scale")
        self.base_quota = base_quota
        self.step = float(step)
        self.max_scale = float(max_scale)
        self.burn_trigger = float(burn_trigger)
        self.deadline_stretch = float(deadline_stretch)
        self.canary_step = float(canary_step)
        # cost-aware grants: a tenant already holding more
        # than this share of the fleet's MEASURED cost
        # (obs.cost_by_tenant) is denied quota scale-ups — shed-count
        # pressure alone must not let the biggest spender crowd the
        # grant loop.  None (default) preserves the pre-cost law.
        self.cost_share_cap = (None if cost_share_cap is None
                               else float(cost_share_cap))
        self._base_deadline_ms = self.deadline_ms
        self._scale: Dict[str, float] = {}
        self._promoted = False

    # -- the control law ---------------------------------------------------
    def _burning(self, obs: TickObservation) -> bool:
        if obs.slo_state == "breach":
            return True
        return (obs.burn_short is not None
                and obs.burn_short >= self.burn_trigger)

    def _quota_for(self, scale: float) -> TenantQuota:
        b = self.base_quota
        return TenantQuota(
            rate_per_s=b.rate_per_s * scale,
            burst=int(round(b.effective_burst() * scale)),
            max_inflight=b.max_inflight, priority=b.priority)

    def decide(self, obs: TickObservation) -> PolicyDecision:
        d = PolicyDecision()
        burning = self._burning(obs)
        quota_sheds = {t: n for t, n in sorted(obs.shed_by_tenant.items())
                       if n > 0}
        if burning and quota_sheds:
            total_cost = sum(obs.cost_by_tenant.values())
            for t in quota_sheds:
                if (self.cost_share_cap is not None and total_cost > 0
                        and (obs.cost_by_tenant.get(t, 0.0) / total_cost
                             > self.cost_share_cap)):
                    # over the measured-cost cap: record the denial so
                    # the decision stream explains the missing grant
                    d.add("quota_denied", tenant=t, reason="cost_share",
                          share=round(obs.cost_by_tenant[t] / total_cost,
                                      6), cap=self.cost_share_cap)
                    continue
                cur = self._scale.get(t, 1.0)
                new = min(self.max_scale, cur * self.step)
                if new != cur:
                    self._scale[t] = new
                    q = self._quota_for(new)
                    d.add("quota", tenant=t, scale=new,
                          rate_per_s=round(q.rate_per_s, 6),
                          burst=int(q.effective_burst()))
        elif not burning:
            for t in sorted(self._scale):
                if quota_sheds.get(t):
                    continue  # still shedding: hold the grant
                new = max(1.0, self._scale[t] / self.step)
                if new != self._scale[t]:
                    self._scale[t] = new
                    q = self._quota_for(new)
                    d.add("quota", tenant=t, scale=new,
                          rate_per_s=round(q.rate_per_s, 6),
                          burst=int(q.effective_burst()))
                if new == 1.0:
                    del self._scale[t]
        # deadline lever
        want_deadline = (self._base_deadline_ms * self.deadline_stretch
                         if burning else self._base_deadline_ms)
        if want_deadline != self.deadline_ms:
            self.deadline_ms = want_deadline
            d.add("deadline", timeout_ms=round(want_deadline, 3))
        # canary shepherd
        if obs.canary_active and not self._promoted:
            if burning:
                pass  # freeze the rollout while the fleet burns
            elif obs.canary_fraction >= 1.0:
                self._promoted = True
                d.add("canary", action="promote")
            else:
                frac = min(1.0, round(obs.canary_fraction
                                      + self.canary_step, 6))
                d.add("canary", fraction=frac)
        # advisory bucket plan from the flush histogram
        plan = self._bucket_recommendation(obs.flush_sizes)
        if plan is not None:
            d.add("bucket_plan", buckets=plan, advisory=True)
        return d

    @staticmethod
    def _bucket_recommendation(flush_sizes: Dict[int, int]
                               ) -> Optional[List[int]]:
        if not flush_sizes:
            return None
        sizes = sorted(flush_sizes)
        total = sum(flush_sizes.values())
        acc = 0
        p95 = sizes[-1]
        for s in sizes:
            acc += flush_sizes[s]
            if acc >= 0.95 * total:
                p95 = s
                break
        top = 1
        while top < p95:
            top *= 2
        plan = sorted({max(1, top // 4), max(1, top // 2), top})
        return plan
