"""The traffic twin: a seeded day of load replayed against a REAL fleet on
virtual time (port of ``sparkdl_tpu/twin/sim.py``).

Not a mock: every arrival is a real ``Fleet.submit`` through the port's
admission controller, dynamic batcher, single-flight inference cache,
rollout router and SLO engine, and every admitted row runs on the fleet's
device (the card unless the CPU is asked for); only TIME is simulated.
One :class:`~sparkdl_tpu_torch.twin.clock.VirtualClock` drives every
``clock=`` of the serving stack, so a 24-hour day of token-bucket refills,
wait-window flushes and SLO burn windows plays out in the seconds the
actual work takes.

Per-tick protocol (the order is load-bearing):

1. ``inject("twin.tick")``, the chaos hook (a sleep rule stretches wall
   time; virtual time, and therefore every event byte, must not move);
2. apply the policy decision computed from the PREVIOUS tick's
   observation (quotas, deadline, canary): control acts one tick behind
   its signal, like every real control loop;
3. submit the tick's seeded arrivals (clock FROZEN: every request in a
   tick shares one admission timestamp); quota sheds raise synchronously
   on this thread and are scored, ``twin.arrival`` error rules drop
   arrivals at the door;
4. advance virtual time one tick and ``Fleet.wake()`` the dispatchers (a
   frozen clock satisfies wait windows only when something re-evaluates
   them);
5. drip the slow-loris stream chunk, if due, through a real
   ``StreamScorer`` whose sink submits with a tiny VIRTUAL deadline,
   inside the batcher's deadline guard, so rows flush without another
   clock advance;
6. drain: wait every future, then spin until the fleet's settle callbacks
   and admission releases have all landed (counter barrier): nothing from
   tick N may bleed into tick N+1's accounting;
7. take ONE ``Fleet.varz()`` (the tick's SLO evaluation at an exact
   virtual timestamp), distill the :class:`TickObservation`, ask the
   policy for next tick's decision, and append the canonical event line.

Determinism (two runs byte-identical) holds because the twin's own thread is
the ONLY submitter (admission, canary routing and shed order are program
order), all randomness is seeded per (seed, stream, tick), and the
no-race envelope keeps every racy mechanism out of the scored numbers:
arrivals per tick are clipped so queue pressure stays under the lowest
shed threshold, deadlines span several ticks, the digest universe fits
the cache, and event lines carry only race-free aggregates
(``cache.hits + cache.coalesced``: the split depends on flush timing, the
sum does not).  Event lines hold counts, virtual times, SLO burns, cost
units and decisions, never model outputs, so a day of the port equals the
JAX package's day byte for byte.

The model is the JAX twin's dense layer, ``tanh(x @ w)``, as a module
holding ``w`` (:class:`DenseTanh`) from the same seeded numpy arrays; the
cost units are the ledger's attributed rows (the port has no program
lockfile, and the JAX ledger has no FLOPs for this program either).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

import torch
from torch import nn

from sparkdl_tpu_torch import DeviceLike, default_device, resolve_device
from sparkdl_tpu_torch.faults import InjectedFault, inject
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.obs.slo import SLO
from sparkdl_tpu_torch.serving.errors import (QueueFullError,
                                              QuotaExceededError,
                                              ServiceUnavailableError)
from sparkdl_tpu_torch.serving.fleet import Fleet
from sparkdl_tpu_torch.serving.fleet.admission import TenantQuota
from sparkdl_tpu_torch.twin.clock import VirtualClock
from sparkdl_tpu_torch.twin.placement import PlacementPlan, plan_placement
from sparkdl_tpu_torch.twin.policy import (Policy, PolicyDecision,
                                           StaticPolicy, TickObservation)
from sparkdl_tpu_torch.twin.scenario import Scenario, ScenarioConfig
from sparkdl_tpu_torch.utils.metrics import Metrics

__all__ = ["DEFAULT_TENANT_QUOTA", "DenseTanh", "TwinResult",
           "TrafficTwin", "run_day"]

#: admission envelope: quota a tenant starts the day with (refills 180
#: tokens per 300 s tick — clears the diurnal peak of the Zipf head,
#: sheds hard under a 6x flash crowd; the policy's whole story)
DEFAULT_TENANT_QUOTA = TenantQuota(rate_per_s=0.6, burst=200)

#: barrier limits (WALL seconds — liveness only, never part of scoring)
_FUTURE_WAIT_S = 120.0
_BARRIER_WAIT_S = 60.0


class DenseTanh(nn.Module):
    """The twin's model: one dense layer, ``tanh(x @ w)``, ``w`` a buffer
    (the JAX twin's ``{"w": ...}`` variables)."""

    def __init__(self, w: np.ndarray):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.array(w)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ self.w)


def _model_fn(module: DenseTanh, x: torch.Tensor) -> torch.Tensor:
    return module(x)


@dataclass
class TwinResult:
    """One simulated day, fully scored and byte-comparable."""

    policy: str
    config: ScenarioConfig
    event_lines: List[str]
    event_digest: str
    scores: Dict[str, Any]
    placement: Optional[Dict[str, Any]] = None
    final_varz: Dict[str, Any] = field(default_factory=dict)
    #: the day's device, and per fleet server (every version that served,
    #: a drained one as of its drain): its device, dispatches, graph
    #: captures and pool bytes; outside the byte-compared record
    device: Optional[str] = None
    servers: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def slo_minutes(self) -> float:
        return self.scores["slo_minutes"]


class _FleetSink:
    """Server-shaped stream sink: each row rides the REAL fleet door as
    tenant ``stream``.  The tiny VIRTUAL deadline is the trick that
    makes streaming work under a frozen clock: ``deadline - now``
    lands inside the batcher's 10 ms deadline guard, so the dispatcher
    flushes the rows immediately instead of waiting for a clock
    advance that cannot happen while ``StreamScorer.run`` blocks this
    thread."""

    def __init__(self, fleet: Fleet, model: str,
                 timeout_ms: float = 5.0):
        self._fleet = fleet
        self._model = model
        self._timeout_ms = float(timeout_ms)

    def submit(self, row):
        return self._fleet.submit(self._model, row, tenant="stream",
                                  timeout_ms=self._timeout_ms)


class TrafficTwin:
    """One (config, policy) pair -> one :class:`TwinResult`.

    ``workdir`` holds the stream journal/artifacts (a throwaway temp
    dir by default); ``chip_hbm_bytes``/``total_chip_budget`` feed the
    placement planner run over the fleet's real entries before traffic
    starts (``None`` skips planning).  ``device`` is where the fleet's
    servers run: the default device (the card unless the CPU was asked
    for); it raises at :meth:`run_day` when that is the card and there is
    none."""

    def __init__(self, config: Optional[ScenarioConfig] = None, *,
                 policy: Optional[Policy] = None,
                 workdir: Optional[str] = None,
                 default_quota: Optional[TenantQuota] = None,
                 chip_hbm_bytes: Optional[int] = 64 * 1024,
                 total_chip_budget: int = 16,
                 device: DeviceLike = None):
        self.config = config if config is not None else ScenarioConfig()
        self.policy = policy if policy is not None else StaticPolicy()
        self.scenario = Scenario(self.config)
        self.default_quota = (default_quota if default_quota is not None
                              else DEFAULT_TENANT_QUOTA)
        self._workdir = workdir
        self._chip_hbm_bytes = chip_hbm_bytes
        self._total_chip_budget = int(total_chip_budget)
        self._device = device
        self._servers: List[Dict[str, Any]] = []

    # -- fleet under test --------------------------------------------------
    def _weights(self, stream: int) -> np.ndarray:
        """The JAX twin's ``_variables(stream)["w"]``, the same bytes."""
        c = self.config
        rng = np.random.default_rng([c.seed, stream])
        return rng.standard_normal(
            (c.feature_dim, c.feature_dim)).astype(np.float32)

    def _module(self, stream: int) -> DenseTanh:
        return DenseTanh(self._weights(stream))

    def _build_fleet(self, clock: VirtualClock, metrics: Metrics) -> Fleet:
        from sparkdl_tpu_torch.obs.cost import CostLedger
        from sparkdl_tpu_torch.parallel.mesh import get_mesh
        from sparkdl_tpu_torch.serving.cache import InferenceCache

        c = self.config
        slo = SLO("fleet-availability", "availability",
                  good="fleet.completed", total="fleet.requests",
                  objective=0.999)
        # The twin's mesh pin: a head fan-out entry deployed under the
        # twin hands this same mesh to its HeadBank, whose stacked
        # weights are replicated per device, so on the one-device pin the
        # bank costs one copy of card memory and every server's engines
        # sit on the day's device.  Assert the pin rather than trust it.
        twin_mesh = get_mesh(num_devices=1)
        assert len(twin_mesh.devices.flat) == 1, (
            "twin harness requires the single-device mesh pin")

        fleet = Fleet(
            default_quota=self.default_quota,
            # the stream tenant is infrastructure, not a customer: no
            # rate cap, or the slow-loris leg would poison quota scores
            quotas={"stream": TenantQuota()},
            slos=[slo],
            cache=InferenceCache(metrics=metrics),
            # measured cost attribution: the policy's cost_by_tenant
            # axis reads this ledger's rows (deterministic, never wall
            # seconds), and max_tenants is sized past any twin day
            # so top-K folding (ranked by wall-measured spend) can
            # never perturb the byte-compared event stream
            cost=CostLedger(max_tenants=max(256, c.tenants + 8)),
            metrics=metrics,
            clock=clock,
            max_batch_size=64,
            max_wait_ms=50.0,
            # no-race envelope: max tick arrivals (3400) must stay
            # under the LOW shed threshold (0.5) of this queue
            max_queue=8192,
            bucket_sizes=(16, 64),
            # single-device dispatch: the twin studies admission and
            # SLO control, not data parallelism
            mesh=twin_mesh,
        )
        try:
            for i, name in enumerate(c.traffic_models):
                fleet.add_model(name, _model_fn, self._module(31 + i))
            fleet.add_model("scorer", _model_fn, self._module(47))
        except BaseException:
            fleet.close(drain=False)
            raise
        return fleet

    def _plan_placement(self, fleet: Fleet) -> Optional[PlacementPlan]:
        if self._chip_hbm_bytes is None:
            return None
        entries = {name: self._module(31 + i)
                   for i, name in enumerate(self.config.traffic_models)}
        entries["scorer"] = self._module(47)
        return plan_placement(entries,
                              chip_hbm_bytes=self._chip_hbm_bytes,
                              total_chip_budget=self._total_chip_budget)

    # -- the drain barrier -------------------------------------------------
    @staticmethod
    def _barrier(fleet: Fleet, expected_completed: int,
                 expected_failed: int) -> None:
        """Spin until every settle callback and admission release from
        this tick has landed — ``f.result()`` returning only proves the
        result is set, not that the done-callbacks ran."""
        deadline = time.monotonic() + _BARRIER_WAIT_S
        while True:
            stats = fleet.stats()
            done = (int(stats.get("fleet.completed", 0))
                    >= expected_completed
                    and int(stats.get("fleet.request_failures", 0))
                    >= expected_failed)
            if done:
                snap = fleet.admission.snapshot()
                inflight = sum(t["inflight"]
                               for t in snap["tenants"].values())
                if inflight == 0:
                    return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"twin barrier: fleet never quiesced "
                    f"(completed={stats.get('fleet.completed')} "
                    f"expected={expected_completed})")
            fleet.wake()
            time.sleep(0.0005)

    # -- one day -----------------------------------------------------------
    def run_day(self) -> TwinResult:
        device = resolve_device(self._device)
        clock = VirtualClock()
        metrics = Metrics()
        owns_workdir = self._workdir is None
        workdir = (tempfile.mkdtemp(prefix="twin-")
                   if owns_workdir else self._workdir)
        os.makedirs(workdir, exist_ok=True)
        self._servers = []
        try:
            # the fleet's servers resolve their device where they are built
            # (this thread: add_model, start_rollout)
            with default_device(device):
                fleet = self._build_fleet(clock, metrics)
                try:
                    result = self._run_day(fleet, clock, workdir)
                    self._note_servers(fleet)
                finally:
                    fleet.close(drain=False)
        finally:
            if owns_workdir:
                import shutil

                shutil.rmtree(workdir, ignore_errors=True)
        result.device = str(device)
        result.servers = list(self._servers)
        return result

    # -- per-server readings (outside the byte-compared record) -----------
    @staticmethod
    def _server_summary(name: str, version: int, server) -> Dict[str, Any]:
        return {"model": name, "version": int(version),
                "device": str(server.device),
                "dispatches": int(server.stats().get("serving.batches", 0)),
                "captures": sum(int(e["executables"]) for e in
                                server.executable_state().values()),
                "pool_bytes": int(server.graph_pool_bytes)}

    def _note_servers(self, fleet: Fleet) -> None:
        """Every live server's summary (the day's end)."""
        for name in fleet.models():
            state = fleet._state(name)
            self._servers.append(self._server_summary(
                name, state.version, state.server))
            ro = state.rollout
            if ro is not None and ro.active:
                self._servers.append(self._server_summary(
                    name, ro.canary_version, ro.canary_server))

    def _run_day(self, fleet: Fleet, clock: VirtualClock,
                 workdir: str) -> TwinResult:
        from sparkdl_tpu_torch.streaming.runner import StreamScorer
        from sparkdl_tpu_torch.streaming.source import MemorySource

        c = self.config
        placement = self._plan_placement(fleet)
        source = MemorySource()
        scorer = StreamScorer(
            _FleetSink(fleet, "scorer"), source,
            journal_path=os.path.join(workdir, "journal.jsonl"),
            out_dir=os.path.join(workdir, "out"),
            stall_deadline_s=60.0)

        canary_model = c.traffic_models[0]
        rollout = None
        decision = PolicyDecision()
        retry_counts: Dict[int, int] = {}
        shed_tenant_cum = np.zeros(c.tenants, dtype=np.int64)
        offered_tenant = np.zeros(c.tenants, dtype=np.int64)
        completed_tenant = np.zeros(c.tenants, dtype=np.int64)
        submitted_total = 0
        offered_total = 0
        shed_total = 0
        fault_drops = 0
        stream_commits = 0
        breach_ticks = 0
        last_phase = None
        event_lines: List[str] = []
        digest = hashlib.sha256()
        decisions_applied: List[Dict[str, Any]] = []

        try:
            for tick in range(c.ticks):
                inject("twin.tick")
                phase = self.scenario.phase(tick)
                if phase != last_phase:
                    flight_emit("twin.scenario", tick=tick, phase=phase,
                                vt=round(clock.now, 3))
                    last_phase = phase

                # (2) control acts on the PREVIOUS tick's observation
                applied = self._apply_decision(fleet, decision, rollout,
                                               canary_model, tick)
                decisions_applied.extend(applied)
                if rollout is not None and not rollout.active:
                    rollout = None  # promoted: the fleet owns v2 now
                if c.canary_tick is not None and tick == c.canary_tick:
                    fleet.add_version(canary_model, {
                        "w": torch.from_numpy(self._weights(37))})
                    rollout = fleet.start_rollout(canary_model,
                                                  canary_fraction=0.1)

                # (3) the tick's seeded arrivals, clock frozen
                arr = self.scenario.arrivals(tick, retry_counts)
                futures = []
                shed_reason = {"quota": 0, "pressure": 0, "queue": 0}
                shed_tenant_tick: Dict[int, int] = {}
                admitted_tenant_tick: Dict[int, List[int]] = {}
                for i in range(len(arr)):
                    t_idx = int(arr.tenant[i])
                    offered_tenant[t_idx] += 1
                    offered_total += 1
                    tenant = self.scenario.tenant_name(t_idx)
                    model = c.traffic_models[int(arr.model[i])]
                    payload = self.scenario.payloads[int(arr.digest[i])]
                    try:
                        inject("twin.arrival")
                        fut = fleet.submit(
                            model, payload, tenant=tenant,
                            timeout_ms=self.policy.deadline_ms)
                    except InjectedFault:
                        fault_drops += 1
                        shed_tenant_tick[t_idx] = \
                            shed_tenant_tick.get(t_idx, 0) + 1
                        continue
                    except QuotaExceededError:
                        shed_reason["quota"] += 1
                        shed_tenant_tick[t_idx] = \
                            shed_tenant_tick.get(t_idx, 0) + 1
                        continue
                    except ServiceUnavailableError:
                        shed_reason["pressure"] += 1
                        shed_tenant_tick[t_idx] = \
                            shed_tenant_tick.get(t_idx, 0) + 1
                        continue
                    except QueueFullError:
                        shed_reason["queue"] += 1
                        shed_tenant_tick[t_idx] = \
                            shed_tenant_tick.get(t_idx, 0) + 1
                        continue
                    futures.append(fut)
                    admitted_tenant_tick.setdefault(t_idx, []).append(i)
                admitted = len(futures)
                submitted_total += admitted
                tick_shed = len(arr) - admitted
                shed_total += tick_shed
                for t_idx, n in shed_tenant_tick.items():
                    shed_tenant_cum[t_idx] += n

                # (4) one tick of virtual time, then re-arm the flush
                # triggers the jump just satisfied
                clock.advance(c.tick_s)
                fleet.wake()

                # (5) slow-loris drip through the real scorer
                chunk = self.scenario.stream_payload(tick)
                if chunk is not None:
                    source.feed(chunk)
                    summary = scorer.run(max_chunks=1)
                    submitted_total += int(chunk.shape[0])
                    stream_commits += int(summary["chunks_scored"])

                # (6) drain to a quiesced fleet
                for fut in futures:
                    fut.result(timeout=_FUTURE_WAIT_S)
                self._barrier(fleet, submitted_total, 0)
                for t_idx in admitted_tenant_tick:
                    completed_tenant[t_idx] += len(
                        admitted_tenant_tick[t_idx])

                # (7) the tick's ONE observation -> next tick's decision
                varz = fleet.varz()
                obs = self._observe(varz, tick, clock.now, arr,
                                    admitted, tick_shed, shed_reason,
                                    shed_tenant_tick, rollout)
                if obs.slo_state == "breach":
                    breach_ticks += 1
                decision = self.policy.decide(obs)
                if decision:
                    flight_emit("policy.adjust", tick=tick,
                                policy=self.policy.name,
                                levers=[a["lever"]
                                        for a in decision.adjustments])
                retry_counts = dict(shed_tenant_tick)

                line = self._event_line(obs, varz, decision, phase)
                event_lines.append(line)
                digest.update(line.encode())
                digest.update(b"\n")
        finally:
            scorer.close()

        cache_hits = self._cache_hits(fleet)
        scores = self._scores(
            breach_ticks=breach_ticks, offered=offered_total,
            submitted=submitted_total, shed=shed_total,
            fault_drops=fault_drops, cache_hits=cache_hits,
            stream_commits=stream_commits,
            offered_tenant=offered_tenant,
            completed_tenant=completed_tenant,
            cost_by_tenant=(fleet.cost.tenant_costs()
                            if fleet.cost is not None else {}))
        final_varz = fleet.varz()
        flight_emit("twin.scenario", tick=c.ticks, phase="done",
                    vt=round(clock.now, 3),
                    slo_minutes=scores["slo_minutes"],
                    goodput=scores["goodput"])
        return TwinResult(
            policy=self.policy.name, config=c,
            event_lines=event_lines,
            event_digest=digest.hexdigest(), scores=scores,
            placement=placement.as_dict() if placement else None,
            final_varz=final_varz)

    # -- decision application ----------------------------------------------
    def _apply_decision(self, fleet: Fleet, decision: PolicyDecision,
                        rollout, canary_model: str,
                        tick: int) -> List[Dict[str, Any]]:
        applied: List[Dict[str, Any]] = []
        for adj in decision.adjustments:
            lever = adj["lever"]
            if lever == "quota":
                fleet.admission.set_quota(
                    adj["tenant"],
                    TenantQuota(rate_per_s=adj["rate_per_s"],
                                burst=adj["burst"]))
            elif lever == "deadline":
                self.policy.deadline_ms = float(adj["timeout_ms"])
            elif lever == "canary":
                if rollout is None or not rollout.active:
                    continue  # decision raced the rollout's end
                if adj.get("action") == "promote":
                    # the stable version's server drains in the promote
                    self._servers.append(self._server_summary(
                        canary_model, rollout.stable_version,
                        rollout.stable_server))
                    fleet.promote(canary_model)
                else:
                    rollout.set_fraction(float(adj["fraction"]))
            # bucket_plan is advisory: recorded, never applied mid-day
            applied.append(dict(adj, tick=tick))
        return applied

    # -- observation / scoring ---------------------------------------------
    def _observe(self, varz: Dict[str, Any], tick: int, vt: float,
                 arr, admitted: int, tick_shed: int,
                 shed_reason: Dict[str, int],
                 shed_tenant_tick: Dict[int, int],
                 rollout) -> TickObservation:
        slo = varz["health"].get("slo") or {}
        objectives = slo.get("objectives") or [{}]
        avail = objectives[0]
        c = self.config
        # deterministic IDEALIZED flush histogram (admitted volume cut
        # at max_batch_size) — the realized one depends on dispatcher
        # timing and would break the byte-identity contract
        flush: Dict[int, int] = {}
        model_counts = np.bincount(
            arr.model[:len(arr)], minlength=len(c.traffic_models))
        for n in model_counts:
            n = int(n)
            full, rem = divmod(n, 64)
            if full:
                flush[64] = flush.get(64, 0) + full
            if rem:
                flush[rem] = flush.get(rem, 0) + 1
        return TickObservation(
            tick=tick, vt=round(vt, 3), arrivals=len(arr),
            admitted=admitted,
            completed=admitted,  # barrier proved every admit settled
            shed_total=tick_shed, shed_by_reason=dict(shed_reason),
            shed_by_tenant={self.scenario.tenant_name(t): n
                            for t, n in sorted(shed_tenant_tick.items())},
            slo_state=slo.get("state", "no_data"),
            burn_short=avail.get("burn_short"),
            burn_long=avail.get("burn_long"),
            canary_active=rollout is not None and rollout.active,
            canary_fraction=(rollout.fraction
                             if rollout is not None and rollout.active
                             else 0.0),
            flush_sizes=flush,
            cost_by_tenant=self._cost_units(varz))

    @staticmethod
    def _cost_units(varz: Dict[str, Any]) -> Dict[str, float]:
        """Cumulative per-tenant MEASURED cost in deterministic units:
        the ledger's attributed FLOPs where a program has them, attributed
        rows otherwise (always rows in the port: it has no program
        lockfile).  Safe inside the byte-compared observation: the
        tick barrier settles every charge first, and rows x analytic
        constants carry no wall-clock component (unlike the ledger's
        device_s axis, which stays out of here)."""
        out: Dict[str, float] = {}
        for t, v in ((varz.get("cost") or {}).get("tenants") or {}).items():
            out[t] = (v["flops"] if v["flops"] > 0 else float(v["rows"]))
        return out

    def _event_line(self, obs: TickObservation, varz: Dict[str, Any],
                    decision: PolicyDecision, phase: str) -> str:
        counters = varz["metrics"]["counters"]
        hits_coalesced = (int(counters.get("cache.hits", 0))
                          + int(counters.get("cache.coalesced", 0)))
        doc = {
            "tick": obs.tick, "vt": obs.vt, "phase": phase,
            "arrivals": obs.arrivals, "admitted": obs.admitted,
            "shed": obs.shed_by_reason,
            "shed_tenants": obs.shed_by_tenant,
            "slo": {"state": obs.slo_state,
                    "burn_short": obs.burn_short,
                    "burn_long": obs.burn_long},
            "requests_total": int(counters.get("fleet.requests", 0)),
            "completed_total": int(counters.get("fleet.completed", 0)),
            "cache_hits_coalesced_total": hits_coalesced,
            "canary": {"active": obs.canary_active,
                       "fraction": obs.canary_fraction},
            "cost_by_tenant": obs.cost_by_tenant,
            "decision": decision.adjustments,
        }
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    def _cache_hits(self, fleet: Fleet) -> int:
        stats = fleet.metrics.subset("cache.")
        return int(stats.get("cache.hits", 0)
                   + stats.get("cache.coalesced", 0))

    def _scores(self, *, breach_ticks: int, offered: int, submitted: int,
                shed: int, fault_drops: int, cache_hits: int,
                stream_commits: int, offered_tenant: np.ndarray,
                completed_tenant: np.ndarray,
                cost_by_tenant: Optional[Dict[str, float]] = None
                ) -> Dict[str, Any]:
        c = self.config
        active = offered_tenant > 0
        ratios = (completed_tenant[active]
                  / offered_tenant[active].astype(np.float64))
        n = int(ratios.size)
        fairness = (float((ratios.sum() ** 2)
                          / (n * float((ratios ** 2).sum())))
                    if n and float((ratios ** 2).sum()) > 0 else 1.0)
        # Jain over MEASURED cost units across customer
        # tenants — the request-count fairness above can read 1.0 while
        # one tenant burns all the hardware; this axis can't
        costs = np.asarray([v for t, v in sorted(
            (cost_by_tenant or {}).items()) if t != "stream"],
            dtype=np.float64)
        sq = float((costs ** 2).sum())
        cost_fairness = (float((costs.sum() ** 2) / (costs.size * sq))
                         if costs.size and sq > 0 else 1.0)
        return {
            "cost_fairness": round(cost_fairness, 6),
            "slo_minutes": round(breach_ticks * c.tick_s / 60.0, 3),
            "breach_ticks": breach_ticks,
            "goodput": (round((offered - shed) / offered, 6)
                        if offered else 1.0),
            "fairness": round(fairness, 6),
            "cache_hit_rate": (round(cache_hits / submitted, 6)
                               if submitted else 0.0),
            "offered": offered, "submitted": submitted,
            "shed": shed, "fault_drops": fault_drops,
            "stream_commits": stream_commits,
            "tenants_active": n,
        }


def run_day(config: Optional[ScenarioConfig] = None, *,
            policy: Optional[Policy] = None,
            workdir: Optional[str] = None,
            default_quota: Optional[TenantQuota] = None,
            chip_hbm_bytes: Optional[int] = 64 * 1024,
            total_chip_budget: int = 16,
            device: DeviceLike = None) -> TwinResult:
    """One seeded day against a real fleet: the module's front door.  The
    fleet runs on ``device`` (the default device: the card unless the CPU
    was asked for)."""
    return TrafficTwin(config, policy=policy, workdir=workdir,
                       default_quota=default_quota,
                       chip_hbm_bytes=chip_hbm_bytes,
                       total_chip_budget=total_chip_budget,
                       device=device).run_day()
