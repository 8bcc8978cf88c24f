"""Declarative SLOs evaluated with multi-window burn-rate math (port of
``sparkdl_tpu/obs/slo.py``).

A set of :class:`SLO` objectives (availability: a good/total counter
ratio; tail latency: the p99 of a timing series; lag: a gauge) is
evaluated by an :class:`SLOEngine` over an EXISTING
:class:`~sparkdl_tpu_torch.utils.metrics.Metrics` registry: the counters
the stack already records are the SLIs.  The p99 reads the registry's
bounded recent window (``Metrics.max_samples``, 16,384, oldest half
dropped on overflow), the JAX registry's window.

Burn-rate semantics, as in the JAX package:

* **availability**: the engine keeps a bounded history of counter samples
  (one per :meth:`SLOEngine.evaluate`; monitoring polls drive sampling)
  and differences them over a SHORT and a LONG window.  ``burn =
  windowed_bad_fraction / (1 - objective)``.  An objective BREACHES when
  both windows burn at ``burn_threshold`` or faster, and RECOVERS when the
  short window drops back under.
* **latency**: ``burn = p99 / threshold``; breach at ``burn_threshold``
  (default 1.0).
* **lag**: ``burn = gauge / threshold``; breach at ``burn_threshold``.

A breach feeds the owner's :class:`~sparkdl_tpu_torch.utils.health.
HealthTracker` (``note_failure`` with an :class:`SLOViolation`, so
``health()`` flips degraded and names the objective in ``last_error``) and
emits ``slo.breach`` into the flight recorder; recovery of the LAST
breaching objective notes success, but only while the tracker's
``last_error`` is still the SLO's own violation.  ``Server`` accepts
``slos=[...]`` and surfaces the evaluation in ``health()["slo"]``.

Determinism: :meth:`SLOEngine.evaluate` accepts an explicit ``now``
(monotonic seconds), so tests drive the windows synthetically and the
breach flips at the exact burn-rate crossing.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.utils.metrics import Metrics

__all__ = [
    "SLO",
    "SLOEngine",
    "SLOViolation",
    "default_objectives",
    "slo_snapshot",
]

_KINDS = ("availability", "latency", "lag")


class SLOViolation(RuntimeError):
    """What a breaching objective records into ``health()["last_error"]``
    (never raised by the engine — the policy is degrade + keep serving,
    the stream-stall pattern)."""


class SLO:
    """One declarative objective.  ``kind`` picks the SLI shape:

    * ``availability`` — ``good``/``total`` counter names plus
      ``objective`` in (0, 1) (e.g. 0.999: at most 0.1% of requests
      fail).  ``burn_threshold`` defaults to 14.4 — the fast-burn page
      threshold (a 30-day budget gone in ~2 days).
    * ``latency`` — ``series`` timing name plus ``threshold_ms``;
      ``burn_threshold`` defaults to 1.0 (p99 at the threshold IS the
      breach).
    * ``lag`` — ``gauge`` name plus ``threshold_s``; default 1.0.
    """

    __slots__ = ("name", "kind", "objective", "good", "total", "series",
                 "threshold_ms", "gauge", "threshold_s", "burn_threshold")

    def __init__(self, name: str, kind: str, *,
                 objective: Optional[float] = None,
                 good: Optional[str] = None,
                 total: Optional[str] = None,
                 series: Optional[str] = None,
                 threshold_ms: Optional[float] = None,
                 gauge: Optional[str] = None,
                 threshold_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None):
        if kind not in _KINDS:
            raise ValueError(f"SLO kind must be one of {_KINDS}, "
                             f"got {kind!r}")
        self.name = str(name)
        self.kind = kind
        if kind == "availability":
            if not good or not total:
                raise ValueError(f"availability SLO {name!r} needs good= "
                                 f"and total= counter names")
            if objective is None or not 0.0 < float(objective) < 1.0:
                raise ValueError(f"availability SLO {name!r} needs an "
                                 f"objective in (0, 1), got {objective!r}")
            self.objective = float(objective)
            self.good, self.total = str(good), str(total)
            self.burn_threshold = (14.4 if burn_threshold is None
                                   else float(burn_threshold))
        elif kind == "latency":
            if not series or threshold_ms is None or float(threshold_ms) <= 0:
                raise ValueError(f"latency SLO {name!r} needs series= and "
                                 f"a positive threshold_ms=")
            self.series = str(series)
            self.threshold_ms = float(threshold_ms)
            self.burn_threshold = (1.0 if burn_threshold is None
                                   else float(burn_threshold))
        else:  # lag
            if not gauge or threshold_s is None or float(threshold_s) <= 0:
                raise ValueError(f"lag SLO {name!r} needs gauge= and a "
                                 f"positive threshold_s=")
            self.gauge = str(gauge)
            self.threshold_s = float(threshold_s)
            self.burn_threshold = (1.0 if burn_threshold is None
                                   else float(burn_threshold))
        if self.burn_threshold <= 0:
            raise ValueError(f"SLO {name!r} burn_threshold must be "
                             f"positive")

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "kind": self.kind,
                               "burn_threshold": self.burn_threshold}
        if self.kind == "availability":
            out.update(objective=self.objective, good=self.good,
                       total=self.total)
        elif self.kind == "latency":
            out.update(series=self.series, threshold_ms=self.threshold_ms)
        else:
            out.update(gauge=self.gauge, threshold_s=self.threshold_s)
        return out


class SLOEngine:
    """Evaluates a set of objectives against one ``Metrics`` registry.

    ``health`` is an optional :class:`~sparkdl_tpu.utils.health.
    HealthTracker` the engine degrades on breach (and recovers when the
    last breach clears).  ``seed_zero_baseline=True`` seeds an implicit
    all-zero counter sample "at the beginning of time", so a one-shot
    evaluation (:func:`slo_snapshot`) rates the whole run instead of
    reporting no-data.
    """

    def __init__(self, metrics: Metrics, objectives: Sequence[SLO], *,
                 health: Any = None,
                 short_window_s: float = 60.0,
                 long_window_s: float = 300.0,
                 max_samples: int = 512,
                 seed_zero_baseline: bool = False,
                 clock: Optional[Callable[[], float]] = None):
        self.metrics = metrics
        # monotonic source for evaluate()'s implicit ``now`` — injectable
        # so a virtual-time harness samples burn windows deterministically
        self._clock = clock if clock is not None else time.monotonic
        self.objectives: List[SLO] = list(objectives)
        for o in self.objectives:
            if not isinstance(o, SLO):
                raise TypeError(f"objectives must be SLO instances, got "
                                f"{type(o).__name__}")
        self._health = health
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        if self.short_window_s > self.long_window_s:
            raise ValueError("short_window_s must be <= long_window_s")
        self._counter_names = sorted(
            {o.good for o in self.objectives if o.kind == "availability"}
            | {o.total for o in self.objectives
               if o.kind == "availability"})
        self._lock = named_lock("obs.slo.state")
        #: (t_monotonic, {counter: value}) history; t=None marks the
        #: seeded zero baseline ("before everything").
        self._samples: deque = deque(maxlen=max(2, int(max_samples)))
        if seed_zero_baseline and self._counter_names:
            self._samples.append(
                (None, {n: 0.0 for n in self._counter_names}))
        self._breaching: Dict[str, bool] = {o.name: False
                                            for o in self.objectives}

    # -- window math -------------------------------------------------------
    def _baseline(self, now: float, window_s: float):
        """Newest sample at or before ``now - window_s`` (seeded zero
        baseline matches any window), else the OLDEST sample (partial
        window), else None (no history at all) — caller holds the
        lock."""
        cutoff = now - window_s
        best = None
        for t, vals in self._samples:
            if t is None or t <= cutoff:
                best = (t, vals)
            else:
                break  # samples are time-ordered
        if best is not None:
            return best
        return self._samples[0] if self._samples else None

    @staticmethod
    def _burn_availability(slo: SLO, cur: Dict[str, float],
                           base: Optional[tuple]) -> Optional[float]:
        """Windowed burn rate, or None when the window holds no
        traffic (no verdict — absence of requests is not availability)."""
        if base is None:
            return None
        base_vals = base[1]
        total_d = cur.get(slo.total, 0.0) - base_vals.get(slo.total, 0.0)
        if total_d <= 0:
            return None
        good_d = cur.get(slo.good, 0.0) - base_vals.get(slo.good, 0.0)
        bad_fraction = min(1.0, max(0.0, (total_d - good_d) / total_d))
        return bad_fraction / (1.0 - slo.objective)

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Take one sample, rate every objective, and return the
        JSON-serializable snapshot (the JAX package's schema).
        Transitions feed the health tracker and the flight recorder AFTER
        the engine lock is released."""
        if now is None:
            now = self._clock()
        raw = self.metrics.snapshot_raw()
        counters = raw["counters"]
        cur = {n: float(counters.get(n, 0.0)) for n in self._counter_names}
        statuses: List[Dict[str, Any]] = []
        breached: List[tuple] = []
        recovered: List[str] = []
        with self._lock:
            if self._counter_names:
                self._samples.append((now, cur))
            was_any = any(self._breaching.values())
            for slo in self.objectives:
                st = self._status(slo, cur, now, raw)
                was = self._breaching[slo.name]
                is_breach = st["state"] == "breach"
                # two-window hysteresis for availability: an active
                # breach only clears when the SHORT window drops back
                # under (the long window lags by design)
                if slo.kind == "availability" and was and not is_breach:
                    if (st["burn_short"] is not None
                            and st["burn_short"] >= slo.burn_threshold):
                        is_breach = True
                        st["state"] = "breach"
                self._breaching[slo.name] = is_breach
                if is_breach and not was:
                    breached.append((slo.name, st.get("burn")))
                elif was and not is_breach:
                    recovered.append(slo.name)
                statuses.append(st)
            now_any = any(self._breaching.values())
        state = "breach" if now_any else "ok"
        for name, burn in breached:
            flight_emit("slo.breach", slo=name, burn=burn)
            if self._health is not None:
                self._health.note_failure(SLOViolation(
                    f"SLO {name!r} burning at {burn} >= threshold"))
        for name in recovered:
            flight_emit("slo.recovered", slo=name)
        if was_any and not now_any and recovered and self._health is not None:
            # clear only a degradation the SLO engine itself caused: if
            # some OTHER failure (a dispatch error, a stall) degraded
            # the tracker since the breach, its "no success since"
            # episode must survive this objective's recovery
            last = self._health.snapshot().get("last_error")
            if last is not None and last.get("type") == "SLOViolation":
                self._health.note_success()
        return {"state": state, "t_mono": round(now, 3),
                "objectives": statuses}

    def _status(self, slo: SLO, cur: Dict[str, float], now: float,
                raw: Dict[str, Dict]) -> Dict[str, Any]:
        """One objective's status (caller holds the engine lock)."""
        st: Dict[str, Any] = {"name": slo.name, "kind": slo.kind,
                              "burn_threshold": slo.burn_threshold}
        if slo.kind == "availability":
            b_short = self._burn_availability(
                slo, cur, self._baseline(now, self.short_window_s))
            b_long = self._burn_availability(
                slo, cur, self._baseline(now, self.long_window_s))
            breach = (b_short is not None and b_long is not None
                      and b_short >= slo.burn_threshold
                      and b_long >= slo.burn_threshold)
            st.update({
                "objective": slo.objective,
                "burn_short": (None if b_short is None
                               else round(b_short, 4)),
                "burn_long": (None if b_long is None
                              else round(b_long, 4)),
                "burn": (None if b_short is None and b_long is None
                         else round(max(b_short or 0.0, b_long or 0.0),
                                    4)),
                "short_window_s": self.short_window_s,
                "long_window_s": self.long_window_s,
            })
        elif slo.kind == "latency":
            series = raw["timings_s"].get(slo.series) or []
            p99_s = (Metrics._percentile(series, 99) if series else None)
            burn = (None if p99_s is None
                    else (p99_s * 1e3) / slo.threshold_ms)
            breach = burn is not None and burn >= slo.burn_threshold
            st.update({
                "threshold_ms": slo.threshold_ms,
                "p99_ms": (None if p99_s is None
                           else round(p99_s * 1e3, 3)),
                "burn": None if burn is None else round(burn, 4),
            })
        else:  # lag
            g = raw["gauges"].get(slo.gauge)
            burn = None if g is None else float(g) / slo.threshold_s
            breach = burn is not None and burn >= slo.burn_threshold
            st.update({
                "threshold_s": slo.threshold_s,
                "lag_s": None if g is None else round(float(g), 3),
                "burn": None if burn is None else round(burn, 4),
            })
        st["state"] = "breach" if breach else "ok"
        return st


#: The JAX package's defaults for the one-shot stamp: informational
#: objectives derived from whichever series a registry recorded.
_DEFAULT_AVAILABILITY = 0.999
_DEFAULT_LATENCY_MS = 1000.0
_DEFAULT_LAG_S = 30.0


def default_objectives(metrics: Metrics) -> List[SLO]:
    """The standard objective set for whatever a registry recorded:
    serving/fleet availability + p99 latency, streaming commit
    availability + watermark lag — each included only when its series
    exists."""
    raw = metrics.snapshot_raw()
    counters, timings = raw["counters"], raw["timings_s"]
    objs: List[SLO] = []
    if "serving.requests" in counters:
        objs.append(SLO("serving-availability", "availability",
                        good="serving.completed",
                        total="serving.requests",
                        objective=_DEFAULT_AVAILABILITY))
    if timings.get("serving.request_latency"):
        objs.append(SLO("serving-p99-latency", "latency",
                        series="serving.request_latency",
                        threshold_ms=_DEFAULT_LATENCY_MS))
    if "fleet.requests" in counters:
        objs.append(SLO("fleet-availability", "availability",
                        good="fleet.completed", total="fleet.requests",
                        objective=_DEFAULT_AVAILABILITY))
    if timings.get("fleet.request_latency"):
        objs.append(SLO("fleet-p99-latency", "latency",
                        series="fleet.request_latency",
                        threshold_ms=_DEFAULT_LATENCY_MS))
    if "stream.chunks" in counters:
        objs.append(SLO("stream-commit-availability", "availability",
                        good="stream.commits", total="stream.chunks",
                        objective=_DEFAULT_AVAILABILITY))
    if "stream.lag_seconds" in raw["gauges"]:
        objs.append(SLO("stream-watermark-lag", "lag",
                        gauge="stream.lag_seconds",
                        threshold_s=_DEFAULT_LAG_S))
    return objs


def slo_snapshot(metrics: Metrics) -> Optional[Dict[str, Any]]:
    """One-shot whole-run evaluation of :func:`default_objectives` —
    the ``slo`` rider a run stamps next to ``metrics_snapshot``
    (burn_threshold left at the kind defaults; the zero baseline makes
    the single sample rate the entire run).  None when the registry
    holds nothing the default objectives apply to."""
    objs = default_objectives(metrics)
    if not objs:
        return None
    eng = SLOEngine(metrics, objs, seed_zero_baseline=True)
    return eng.evaluate()
