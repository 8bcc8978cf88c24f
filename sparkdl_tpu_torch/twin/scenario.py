"""Seeded traffic-day generator, the twin's deterministic workload (port
of ``sparkdl_tpu/twin/scenario.py``, numpy only: its arrays equal the JAX
package's byte for byte for the same config).

One :class:`ScenarioConfig` seed expands into a full simulated "day"
of tenant traffic in the ``faults.FaultPlan`` style: every random draw
comes from a per-(seed, stream, tick) ``numpy.random.default_rng``, so
the same config produces the byte-identical arrival sequence on every
run, on every machine — the precondition for the twin's two-runs-
byte-identical acceptance bar.

The day's shape (all knobs on the config):

* **heavy-tailed tenants** — tenant identity is Zipf-distributed, so a
  few head tenants carry most of the traffic and a long tail trickles
  (the "millions of users behind tens of tenants" shape);
* **diurnal ramp** — a sinusoid over the day scales the per-tick
  arrival rate between night trough and evening peak;
* **flash crowd** — for ``[flash_start, flash_end)`` ticks the head
  ``flash_tenants`` tenants multiply their traffic ``flash_multiplier``
  times (the incident the policy engine is scored on);
* **retry storm** — every shed arrival re-presents next tick amplified
  by ``retry_factor`` (capped), so shedding feeds back exactly the way
  real retrying clients make a bad tick worse;
* **Zipfian content** — each arrival's payload is drawn from a fixed
  ``digest_universe`` of feature vectors with Zipf popularity, so the
  REAL content-addressed inference cache sees a realistic hit curve;
* **slow-loris stream** — every ``stream_every`` ticks one small chunk
  drips into a ``MemorySource`` feeding a real ``StreamScorer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["ScenarioConfig", "Scenario", "Arrivals"]


@dataclass(frozen=True)
class ScenarioConfig:
    """Knobs for one simulated day.  Defaults are the canonical seeded
    day: 288 five-minute virtual ticks, 64 tenants,
    ~110k virtual requests."""

    seed: int = 16
    ticks: int = 288                 # 24h of 5-minute ticks
    tick_s: float = 300.0            # virtual seconds per tick
    tenants: int = 64
    feature_dim: int = 8
    mean_arrivals_per_tick: float = 360.0
    #: hard per-tick clip — keeps worst-case queue pressure below every
    #: admission shed threshold (the twin's no-race envelope; sim.py's
    #: module docstring)
    max_arrivals_per_tick: int = 3400
    tenant_zipf: float = 1.1
    digest_universe: int = 512
    digest_zipf: float = 1.05
    diurnal_amplitude: float = 0.45
    flash_start: int = 150
    flash_end: int = 170             # exclusive
    flash_multiplier: float = 6.0
    flash_tenants: int = 8           # the crowd hits the head tenants
    retry_factor: float = 1.5
    retry_cap_per_tick: int = 1200
    canary_tick: Optional[int] = 60  # None = no rollout leg
    stream_every: int = 6            # slow-loris cadence (0 = no stream)
    stream_rows: int = 16
    traffic_models: Tuple[str, ...] = ("ranker", "detector")
    model_mix: Tuple[float, ...] = (0.65, 0.35)

    def __post_init__(self):
        if self.tenants < 1 or self.ticks < 1:
            raise ValueError("tenants and ticks must be >= 1")
        if len(self.traffic_models) != len(self.model_mix):
            raise ValueError("model_mix must pair 1:1 with traffic_models")
        if abs(sum(self.model_mix) - 1.0) > 1e-9:
            raise ValueError(f"model_mix must sum to 1, got "
                             f"{self.model_mix}")
        if not 0 <= self.flash_start <= self.flash_end:
            raise ValueError("need 0 <= flash_start <= flash_end")


@dataclass
class Arrivals:
    """One tick's arrival batch (parallel arrays, one row each)."""

    tenant: np.ndarray   # int32 tenant index
    model: np.ndarray    # int32 index into traffic_models
    digest: np.ndarray   # int32 index into the payload universe
    retry: np.ndarray    # bool — re-presented after a shed last tick
    clipped: int = 0     # arrivals dropped by max_arrivals_per_tick

    def __len__(self) -> int:
        return int(self.tenant.shape[0])


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


class Scenario:
    """Expands a :class:`ScenarioConfig` into per-tick arrivals.

    Stateless across ticks except for precomputed weight tables — the
    retry-storm feedback (shed counts) is OWNED by the simulator and
    passed back in, so arrival randomness never depends on outcomes
    and the per-tick RNG streams stay independent."""

    def __init__(self, config: ScenarioConfig):
        self.config = config
        c = config
        self._tenant_w = _zipf_weights(c.tenants, c.tenant_zipf)
        self._digest_w = _zipf_weights(c.digest_universe, c.digest_zipf)
        self._model_w = np.asarray(c.model_mix, dtype=np.float64)
        # the fixed content universe: payload i IS digest index i —
        # submitting it exercises the real content-addressed cache
        rng = np.random.default_rng([c.seed, 101])
        self.payloads = rng.standard_normal(
            (c.digest_universe, c.feature_dim)).astype(np.float32)

    # -- shape of the day ---------------------------------------------------
    def diurnal(self, tick: int) -> float:
        c = self.config
        phase = 2.0 * np.pi * (tick / max(1, c.ticks))
        return float(1.0 + c.diurnal_amplitude * np.sin(phase - np.pi / 2))

    def in_flash(self, tick: int) -> bool:
        return self.config.flash_start <= tick < self.config.flash_end

    def phase(self, tick: int) -> str:
        if self.in_flash(tick):
            return "flash_crowd"
        if self.config.canary_tick is not None \
                and tick >= self.config.canary_tick:
            return "canary"
        return "steady"

    # -- per-tick draws -----------------------------------------------------
    def arrivals(self, tick: int,
                 retry_counts: Optional[Dict[int, int]] = None) -> Arrivals:
        """The tick's arrival batch.  ``retry_counts`` (tenant index ->
        sheds last tick) drives the retry storm: each shed re-presents
        ``retry_factor`` times, capped at ``retry_cap_per_tick`` total.
        Fresh randomness comes from the per-tick stream
        ``default_rng([seed, 7, tick])`` only."""
        c = self.config
        rng = np.random.default_rng([c.seed, 7, tick])
        lam = c.mean_arrivals_per_tick * self.diurnal(tick)
        n_base = int(rng.poisson(lam))
        n_flash = 0
        if self.in_flash(tick):
            n_flash = int(rng.poisson(lam * (c.flash_multiplier - 1.0)))
        tenant = [rng.choice(c.tenants, size=n_base, p=self._tenant_w)
                  .astype(np.int32)]
        if n_flash:
            tenant.append(rng.integers(
                0, min(c.flash_tenants, c.tenants), size=n_flash,
                dtype=np.int32))
        retry_list = []
        if retry_counts:
            budget = c.retry_cap_per_tick
            for t in sorted(retry_counts):
                n_retry = min(budget,
                              int(np.ceil(retry_counts[t]
                                          * c.retry_factor)))
                budget -= n_retry
                if n_retry > 0:
                    retry_list.append(np.full(n_retry, t, dtype=np.int32))
                if budget <= 0:
                    break
        n_fresh = n_base + n_flash
        tenant_arr = np.concatenate(tenant + retry_list)
        retry_arr = np.zeros(tenant_arr.size, dtype=bool)
        retry_arr[n_fresh:] = True
        total = tenant_arr.size
        digest = rng.choice(c.digest_universe, size=total,
                            p=self._digest_w).astype(np.int32)
        model = rng.choice(len(c.traffic_models), size=total,
                           p=self._model_w).astype(np.int32)
        # interleave fresh and retry traffic, then clip: the permutation
        # is part of the seeded stream, so the clip (and everything
        # downstream) is deterministic
        order = rng.permutation(total)
        clipped = max(0, total - c.max_arrivals_per_tick)
        keep = order[:c.max_arrivals_per_tick]
        return Arrivals(tenant=tenant_arr[keep], model=model[keep],
                        digest=digest[keep], retry=retry_arr[keep],
                        clipped=clipped)

    def stream_payload(self, tick: int) -> Optional[np.ndarray]:
        """The slow-loris drip: one small chunk every ``stream_every``
        ticks (None otherwise)."""
        c = self.config
        if c.stream_every <= 0 or tick % c.stream_every != 0:
            return None
        rng = np.random.default_rng([c.seed, 23, tick])
        return rng.standard_normal(
            (c.stream_rows, c.feature_dim)).astype(np.float32)

    def tenant_name(self, idx: int) -> str:
        return f"t{int(idx):03d}"
