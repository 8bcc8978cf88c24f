"""Per-tenant admission control: token-bucket rate quotas, in-flight
caps and priority classes (port of
``sparkdl_tpu/serving/fleet/admission.py``, pure Python with the same
arithmetic, so a fixed submission schedule on an injected clock admits and
sheds exactly as the JAX package does).

Layered ON TOP of the existing serving backpressure, never instead of
it: the server's bounded queue still rejects with ``QueueFullError``
when genuinely full and sheds everyone with ``ServiceUnavailableError``
while a breaker is open; this controller decides, per TENANT, who is
turned away first as those pressure signals build.

Shed order under pressure (lowest priority first):

* **breaker open / device failing**: tenants below ``PRIORITY_HIGH``
  are shed at the fleet door with ``ServiceUnavailableError`` carrying
  the breaker's ``retry_after_s``; high-priority traffic still reaches
  the server (whose own gate decides: half-open trials have to come
  from somewhere).
* **queue pressure**: each priority class has a shed threshold as a
  fraction of the target server's queue (defaults: low 0.5, normal 0.8,
  high never): a 60%-full queue sheds low-priority tenants while normal
  and high still board.
* **rate quota**: a per-tenant token bucket (``rate_per_s`` refill,
  ``burst`` cap); an empty bucket raises :class:`QuotaExceededError`
  with the refill estimate.  ``rate_per_s=0`` is a ZERO-QUOTA tenant:
  never admitted (the deny-by-config form).
* **in-flight cap**: at most ``max_inflight`` unsettled requests per
  tenant; the fleet releases the slot when the request's future
  settles.

Every shed is a ``fleet.shed`` flight event naming its reason.  The
bucket runs on an injected monotonic ``clock`` (``time.monotonic`` by
default) and holds no RNG.  Its lock is the lock audit's
``named_lock("fleet.admission")``, as in the JAX module.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.serving.errors import (QuotaExceededError,
                                              ServiceUnavailableError)

#: Priority classes, lowest shed first.
PRIORITY_LOW, PRIORITY_NORMAL, PRIORITY_HIGH = 0, 1, 2

#: Default shed thresholds: queue pressure (depth / max_queue) at which
#: a class is turned away.  > 1 means "never shed here" (the server's
#: own QueueFullError still applies at 1.0).
DEFAULT_SHED_PRESSURE: Dict[int, float] = {
    PRIORITY_LOW: 0.50,
    PRIORITY_NORMAL: 0.80,
    PRIORITY_HIGH: 1.01,
}


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract.

    ``rate_per_s=None`` means unlimited rate; ``0.0`` means zero quota
    (never admitted).  ``burst`` defaults to ``max(1, rate_per_s)``
    rounded up — one second of quota.  ``max_inflight=None`` means no
    in-flight cap.
    """

    rate_per_s: Optional[float] = None
    burst: Optional[int] = None
    max_inflight: Optional[int] = None
    priority: int = PRIORITY_NORMAL

    def effective_burst(self) -> float:
        # zero-rate FIRST: rate_per_s=0.0 is the deny-by-config tenant
        # and stays denied even with a leftover explicit burst
        if not self.rate_per_s:  # unlimited (None) or zero quota (0.0)
            return 0.0
        if self.burst is not None:
            return max(0.0, float(self.burst))
        return max(1.0, float(int(self.rate_per_s + 0.999999)))

    def as_dict(self) -> Dict[str, Any]:
        return {"rate_per_s": self.rate_per_s, "burst": self.burst,
                "max_inflight": self.max_inflight,
                "priority": self.priority}


class AdmissionController:
    """Thread-safe tenant gate.  :meth:`admit` charges one token and one
    in-flight slot or raises; :meth:`release` frees the slot when the
    request settles (the fleet wires it to the future's done callback).
    """

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 shed_pressure: Optional[Dict[int, float]] = None,
                 retry_after_cap_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None):
        self._quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self.default_quota = (default_quota if default_quota is not None
                              else TenantQuota())
        self.shed_pressure = dict(DEFAULT_SHED_PRESSURE)
        if shed_pressure:
            self.shed_pressure.update(shed_pressure)
        self.retry_after_cap_s = float(retry_after_cap_s)
        #: monotonic seconds source for bucket refills — injectable so a
        #: virtual-time harness can drive admission deterministically
        self._clock = clock if clock is not None else time.monotonic
        self._lock = named_lock("fleet.admission")
        #: tenant -> [tokens, last_refill_monotonic]
        self._buckets: Dict[str, list] = {}
        self._inflight: Dict[str, int] = {}
        self._admitted: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}

    # -- configuration -----------------------------------------------------
    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota
            self._buckets.pop(tenant, None)  # re-seed at the new burst

    def quota(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._quotas.get(tenant, self.default_quota)

    # -- the gate ----------------------------------------------------------
    def admit(self, tenant: str, pressure: float = 0.0,
              unavailable_retry_after: Optional[float] = None
              ) -> TenantQuota:
        """Gate one request for ``tenant`` against a target server whose
        queue pressure is ``pressure`` (and whose breaker, if OPEN,
        supplies ``unavailable_retry_after``).  Returns the tenant's
        quota on success; raises ``ServiceUnavailableError`` (priority
        shed) or :class:`QuotaExceededError` (rate / in-flight / zero
        quota).  Shed checks run BEFORE the token charge so a shed
        request costs no quota."""
        q = self.quota(tenant)
        if unavailable_retry_after is not None and q.priority < PRIORITY_HIGH:
            self._note_shed(tenant)
            flight_emit("fleet.shed", tenant=tenant, reason="breaker_open",
                        priority=q.priority,
                        retry_after_s=round(unavailable_retry_after, 4))
            raise ServiceUnavailableError(
                f"tenant {tenant!r} (priority {q.priority}) shed: model "
                f"circuit breaker open; retry in "
                f"{unavailable_retry_after:.2f}s",
                retry_after_s=unavailable_retry_after)
        threshold = self.shed_pressure.get(q.priority, 1.01)
        if pressure >= threshold:
            self._note_shed(tenant)
            flight_emit("fleet.shed", tenant=tenant, reason="pressure",
                        priority=q.priority, pressure=round(pressure, 4))
            raise ServiceUnavailableError(
                f"tenant {tenant!r} (priority {q.priority}) shed under "
                f"queue pressure {pressure:.2f} (threshold "
                f"{threshold:.2f}); higher-priority traffic boards first",
                retry_after_s=0.05)
        shed_exc: Optional[BaseException] = None
        reason = None
        with self._lock:
            # cap check BEFORE the token charge: a capped-out rejection
            # must not also burn rate quota ("a shed request costs no
            # quota" — retrying clients at their cap would otherwise
            # starve their own rate).  Shed exceptions are built here
            # but RAISED after the lock is released, so the fleet.shed
            # flight event never fires under the admission lock.
            cap = q.max_inflight
            cur = self._inflight.get(tenant, 0)
            if cap is not None and cur >= int(cap):
                self._shed[tenant] = self._shed.get(tenant, 0) + 1
                reason = "inflight_cap"
                shed_exc = QuotaExceededError(
                    f"tenant {tenant!r} at its in-flight cap ({cur}/"
                    f"{int(cap)}); retry when a request settles",
                    retry_after_s=0.05, tenant=tenant)
            elif q.rate_per_s is not None:
                rate = float(q.rate_per_s)
                burst = q.effective_burst()
                now = self._clock()
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = [burst, now]
                tokens = min(burst, bucket[0] + (now - bucket[1]) * rate)
                bucket[1] = now
                if tokens < 1.0:
                    bucket[0] = tokens
                    self._shed[tenant] = self._shed.get(tenant, 0) + 1
                    if rate > 0:
                        hint = min(self.retry_after_cap_s,
                                   (1.0 - tokens) / rate)
                        msg = (f"tenant {tenant!r} rate quota exhausted "
                               f"({rate:g}/s, burst "
                               f"{burst:g}); retry in {hint:.3f}s")
                        reason = "rate_quota"
                    else:
                        hint = self.retry_after_cap_s
                        msg = f"tenant {tenant!r} has zero quota"
                        reason = "zero_quota"
                    shed_exc = QuotaExceededError(msg, retry_after_s=hint,
                                                  tenant=tenant)
                else:
                    bucket[0] = tokens - 1.0
            if shed_exc is None:
                self._inflight[tenant] = cur + 1
                self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
        if shed_exc is not None:
            flight_emit("fleet.shed", tenant=tenant, reason=reason,
                        priority=q.priority)
            raise shed_exc
        return q

    def release(self, tenant: str) -> None:
        """Free one in-flight slot (future settled / submit failed)."""
        with self._lock:
            cur = self._inflight.get(tenant, 0)
            self._inflight[tenant] = max(0, cur - 1)

    def refund(self, tenant: str) -> None:
        """Undo one :meth:`admit` whose request never reached a server
        (the fleet's swap-window re-route): free the slot, return the
        rate token, and back out the admitted count — the retry will
        charge afresh, so one request never costs a tenant two tokens."""
        q = self.quota(tenant)
        with self._lock:
            cur = self._inflight.get(tenant, 0)
            self._inflight[tenant] = max(0, cur - 1)
            if q.rate_per_s is not None:
                bucket = self._buckets.get(tenant)
                if bucket is not None:
                    bucket[0] = min(q.effective_burst(), bucket[0] + 1.0)
            self._admitted[tenant] = max(
                0, self._admitted.get(tenant, 0) - 1)

    def _note_shed(self, tenant: str) -> None:
        with self._lock:
            self._shed[tenant] = self._shed.get(tenant, 0) + 1

    # -- introspection -----------------------------------------------------
    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable admission state (``Fleet.varz`` embeds it)."""
        with self._lock:
            tenants = sorted(set(self._quotas) | set(self._inflight)
                             | set(self._admitted) | set(self._shed))
            out: Dict[str, Any] = {
                "default_quota": self.default_quota.as_dict(),
                "shed_pressure": {str(k): v
                                  for k, v in self.shed_pressure.items()},
                "tenants": {},
            }
            for t in tenants:
                q = self._quotas.get(t, self.default_quota)
                bucket = self._buckets.get(t)
                out["tenants"][t] = {
                    "quota": q.as_dict(),
                    "inflight": self._inflight.get(t, 0),
                    "admitted": self._admitted.get(t, 0),
                    "shed": self._shed.get(t, 0),
                    "tokens": (round(bucket[0], 3) if bucket is not None
                               else None),
                }
        return out
