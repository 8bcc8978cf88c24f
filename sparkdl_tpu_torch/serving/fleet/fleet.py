"""The fleet front door: many named, versioned models behind one API
(port of ``sparkdl_tpu/serving/fleet/fleet.py``).

Where :class:`~sparkdl_tpu_torch.serving.server.Server` fronts exactly
ONE model for one anonymous caller, a :class:`Fleet` multiplexes many
registry entries over one card with per-tenant admission
(:mod:`.admission`), zero-downtime version rollouts (:mod:`.rollout`),
and aggregated health and metrics:

::

    with Fleet(max_batch_size=32, max_wait_ms=3) as fleet:
        fleet.add_model("feats", "InceptionV3", featurize=True)
        fleet.add_model("clf", my_fn, my_module)
        y = fleet.predict("clf", row, tenant="team-a")

        fleet.add_version("clf", state_dict_v2)      # register v2
        ro = fleet.start_rollout("clf", canary_fraction=0.1)
        ...                                          # watch varz()
        fleet.promote("clf")                         # or rollback("clf")

Request path: route (stable vs canary, deterministic fraction) ->
admission gate (tenant token bucket / in-flight cap / priority shed
against the TARGET server's queue pressure and breaker) -> the version's
own ``Server`` (dynamic batching, buckets, deadlines, watchdog,
breaker).  The returned future carries ``fleet_model`` /
``fleet_version`` / ``fleet_tenant`` / ``fleet_canary`` attributes so
callers can hold results to the right oracle.  Request spans
(``fleet.request``) tag model, version and tenant, and the per-version
server's request spans nest under them.

Versions and captured graphs: each deployed version has its own module
copy (``registry.FleetEntry.version_module``) behind its own ``Server``,
so its own captured engines and one graph pool per version's server; a
promote or rollback drains the losing server, whose ``close()`` gives its
pool back to the card.  ``mesh=`` and the partition knobs
(``partition_rules=``, ``param_shardings=``, ``donate_batch=``) are passed
to each version's ``Server``, which resolves them on this process's one
device; a policy that really splits a weight raises there (one card per
process, ROADMAP.md §C).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.obs.trace import get_tracer
from sparkdl_tpu_torch.serving.errors import ServerClosedError
from sparkdl_tpu_torch.serving.fleet.admission import (AdmissionController,
                                                       TenantQuota)
from sparkdl_tpu_torch.serving.fleet.registry import (HeadVersion,
                                                      ModelRegistry,
                                                      ModelVersion)
from sparkdl_tpu_torch.serving.fleet.rollout import Rollout
from sparkdl_tpu_torch.serving.server import HeadFanoutServer, Server
from sparkdl_tpu_torch.utils.health import HealthTracker
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)


class _ModelState:
    """One deployed entry: its live server, version, and rollout."""

    __slots__ = ("entry", "version", "server", "rollout",
                 "last_swap_report", "server_kwargs")

    def __init__(self, entry, version: int, server: Server,
                 server_kwargs: Dict[str, Any]):
        self.entry = entry
        self.version = version
        self.server = server
        self.rollout: Optional[Rollout] = None
        self.last_swap_report: Optional[Dict[str, Any]] = None
        self.server_kwargs = dict(server_kwargs)


class Fleet:
    """Multi-tenant, versioned model-fleet serving with zero-downtime
    hot-swap.  Constructor kwargs beyond the admission knobs are the
    DEFAULT per-version :class:`Server` configuration
    (``max_batch_size``, ``max_wait_ms``, ``max_queue``, buckets,
    breaker knobs, ...); ``add_model`` kwargs override them per entry.
    """

    def __init__(self, *,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 shed_pressure: Optional[Dict[int, float]] = None,
                 slos: Optional[List[Any]] = None,
                 cache: Any = None,
                 cost: Any = None,
                 program_fingerprints: Any = None,
                 metrics: Optional[Metrics] = None,
                 clock: Optional[Callable[[], float]] = None,
                 **server_defaults):
        self.metrics = metrics if metrics is not None else Metrics()
        # one injected monotonic clock drives the admission buckets, the
        # fleet SLO engine, latency accounting AND (via server_defaults)
        # every server this fleet builds, so a virtual-time harness steps
        # the whole serving stack on one deterministic timeline
        self._clock = clock if clock is not None else time.monotonic
        self.registry = ModelRegistry()
        # ONE result cache for the whole fleet, with per-version key
        # namespaces ``(model, version, fingerprint)`` so two versions can
        # never serve each other's rows.  ``cache=None`` resolves the
        # SPARKDL_CACHE process default; an explicit InferenceCache shares
        # across fleets; ``cache=False`` forces uncached.
        # ``program_fingerprints`` overrides how a version's program
        # identity is resolved for the hot-swap survival rule (a
        # ``{name: fp}`` dict or ``fn(name, entry)``).  The default is
        # ``serving.cache.lockfile_model_fingerprint``, None until the port
        # has a program lockfile (ROADMAP.md queue A item 8): no proof, so
        # a promote then always invalidates
        from sparkdl_tpu_torch.serving.cache import (resolve_cache,
                                                     unique_namespace)

        self._cache = resolve_cache(cache)[0]
        # per-fleet namespace prefix: two fleets sharing the process
        # cache may deploy the same (name, version) with DIFFERENT
        # weights — their entries must never collide — and the prefix
        # makes close()'s whole-fleet reclaim safe (nobody else can
        # reach keys under it)
        self._cache_prefix = (unique_namespace("fleet")
                              if self._cache is not None else ("fleet",))
        self._program_fingerprints = program_fingerprints
        #: (name, version) -> (program_fingerprint, weights_digest) for
        #: deployed versions — the promote-time survival comparison
        self._version_meta: Dict[Any, Any] = {}
        self.admission = AdmissionController(
            quotas=quotas, default_quota=default_quota,
            shed_pressure=shed_pressure, clock=self._clock)
        # fleet-level health: the per-model servers keep their own
        # trackers; this one carries fleet-wide objectives (an SLO breach
        # over the fleet.* series degrades it), and its snapshot is the
        # last_error/transitions half of the unified health() payload
        self._health = HealthTracker("fleet.health")
        # ONE cost ledger for the whole fleet: every server this fleet
        # builds charges the same instance, so showback and the regression
        # sentinel see the fleet-wide picture.  Bound to the FLEET tracker
        # (first binder wins), so an open cost regression degrades fleet
        # health() like an SLO breach
        from sparkdl_tpu_torch.obs.cost import resolve_cost

        self._cost = resolve_cost(cost)
        if self._cost is not None:
            self._cost.bind_health(self._health)
        self._slo_engine = None
        if slos:
            from sparkdl_tpu_torch.obs.slo import SLOEngine

            self._slo_engine = SLOEngine(self.metrics, slos,
                                         health=self._health,
                                         clock=self._clock)
        self._server_defaults = dict(server_defaults)
        if clock is not None:
            # explicit per-entry server_kwargs may still override
            self._server_defaults.setdefault("clock", clock)
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelState] = {}
        self._closed = False
        #: per-model / per-tenant request ledgers (varz sections); plain
        #: dicts mutated only under self._lock
        self._per_model: Dict[str, Dict[str, int]] = {}
        self._per_tenant: Dict[str, Dict[str, int]] = {}

    # -- deployment --------------------------------------------------------
    def add_model(self, name: str, model: Any, variables: Any = None, *,
                  featurize: bool = False, label: Optional[str] = None,
                  warm_example: Any = None,
                  **server_kwargs) -> ModelVersion:
        """Register entry ``name`` (v1) and deploy it immediately.
        ``model`` is a zoo name, a ``ModelFunction`` or a plain
        ``fn(module, batch)`` whose module is ``variables``
        (``registry.ModelRegistry.register``).  ``server_kwargs`` become
        this entry's Server configuration (on top of the fleet defaults)
        for v1 and every later version, the partition knobs
        (``partition_rules=`` / ``param_shardings=``) included."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("fleet is closed")
            if name in self._models:
                raise ValueError(
                    f"model {name!r} already deployed; use add_version() "
                    f"+ start_rollout() to ship new weights")
        mv = self.registry.register(name, model, variables,
                                    featurize=featurize, label=label)
        entry = self.registry.entry(name)
        server = None
        try:
            server = self._build_server(entry, mv, server_kwargs)
            if warm_example is not None:
                server.warmup(warm_example)
            state = _ModelState(entry, mv.version, server, server_kwargs)
            with self._lock:
                # re-check BOTH refusals: a close() or a racing
                # add_model of the same name may have landed during the
                # (slow, outside-lock) server build — inserting now
                # would leak a live dispatcher thread no close() will
                # ever stop, or silently replace the racer's state
                closed = self._closed
                dup = name in self._models
                if not closed and not dup:
                    self._models[name] = state
            if dup:
                raise ValueError(
                    f"model {name!r} already deployed; use add_version() "
                    f"+ start_rollout() to ship new weights")
            if closed:
                raise ServerClosedError("fleet is closed")
        except BaseException:  # noqa: BLE001 — cleaned up, re-raised
            # a failed deploy must leave nothing behind: no live
            # dispatcher thread, and no catalog entry poisoning the
            # name for a retry
            if server is not None:
                server.close(drain=False)
            self.registry.discard(name, mv.version)
            raise
        logger.info("fleet: deployed %s v%d", name, mv.version)
        return mv

    def add_version(self, name: str, variables: Any = None, *,
                    label: Optional[str] = None) -> ModelVersion:
        """Register the next version's weights (a ``state_dict``) for
        entry ``name``.  The version is CATALOG-only until a rollout
        deploys it."""
        return self.registry.register(name, variables=variables,
                                      label=label)

    # -- head fan-out deployment -------------------------------------------
    def add_fanout_model(self, name: str, model: Any, variables: Any = None,
                         *, head_fn: Optional[Callable] = None,
                         hbm_budget_bytes: Optional[int] = None,
                         label: Optional[str] = None,
                         warm_example: Any = None,
                         model_desc: Optional[str] = None,
                         **server_kwargs) -> ModelVersion:
        """Deploy ``name`` as a HEAD FAN-OUT entry: one shared backbone
        at the feature cut behind a
        :class:`~sparkdl_tpu_torch.serving.server.HeadFanoutServer`,
        serving per-tenant heads from a stacked
        :class:`~sparkdl_tpu_torch.parallel.engine.HeadBank` (kernel H1 for
        the zoo's dense heads): many tenant models for one backbone's card
        memory and FLOPs.

        Versioning for these entries is HEAD-ONLY (:meth:`add_head` /
        :meth:`swap_head`): the backbone's weights and program are
        pinned at deploy time, which is precisely what makes head churn
        provably recompile-free.  ``start_rollout`` refuses fan-out
        entries for the same reason.  The feature-cut cache namespace
        is backbone identity (``serving.cache.feature_namespace``), NOT
        the fleet's per-version prefix — a later deploy of the same
        backbone (any fleet) serves the warm entries."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("fleet is closed")
            if name in self._models:
                raise ValueError(
                    f"model {name!r} already deployed; fan-out entries "
                    f"version by HEAD (add_head/swap_head)")
        mv = self.registry.register(name, model, variables,
                                    featurize=True, label=label)
        entry = self.registry.entry(name)
        # no per-version cache namespace: HeadFanoutServer derives the
        # feature-cut one
        kw = self._server_kwargs(entry, server_kwargs)
        kw.setdefault("cache",
                      self._cache if self._cache is not None else False)
        server = None
        try:
            server = HeadFanoutServer(
                entry.fn, entry.version_module(mv), head_fn=head_fn,
                hbm_budget_bytes=hbm_budget_bytes,
                # zoo entries keep the zoo name as their desc; callables
                # let the server derive the fn name
                model_desc=(model_desc if model_desc is not None
                            else (model if isinstance(model, str)
                                  else None)),
                **kw)
            if warm_example is not None:
                server.warmup(warm_example)
            state = _ModelState(entry, mv.version, server, server_kwargs)
            with self._lock:
                closed = self._closed
                dup = name in self._models
                if not closed and not dup:
                    self._models[name] = state
            if dup:
                raise ValueError(
                    f"model {name!r} already deployed; fan-out entries "
                    f"version by HEAD (add_head/swap_head)")
            if closed:
                raise ServerClosedError("fleet is closed")
        except BaseException:  # noqa: BLE001 — cleaned up, re-raised
            if server is not None:
                server.close(drain=False)
            self.registry.discard(name, mv.version)
            raise
        logger.info("fleet: deployed fan-out entry %s v%d", name,
                    mv.version)
        return mv

    def _fanout_state(self, name: str) -> _ModelState:
        state = self._state(name)
        if not isinstance(state.server, HeadFanoutServer):
            raise TypeError(
                f"model {name!r} is not a head fan-out entry; deploy "
                f"with add_fanout_model() to use per-tenant heads")
        return state

    def add_head(self, name: str, tenant: str, weights, *,
                 label: Optional[str] = None) -> Dict[str, Any]:
        """Register + serve a NEW tenant head under fan-out entry
        ``name``.  Returns the ``head_swap_report`` no-backbone-
        recompile proof, extended with the catalog head version."""
        return self._head_op("add", name, tenant, weights, label)

    def swap_head(self, name: str, tenant: str, weights, *,
                  label: Optional[str] = None) -> Dict[str, Any]:
        """Hot-swap ``tenant``'s head under load.  The backbone cannot
        recompile (proven in the returned report) and the feature-cut
        cache stays warm — the namespace never saw the head."""
        return self._head_op("swap", name, tenant, weights, label)

    def remove_head(self, name: str, tenant: str) -> Dict[str, Any]:
        """Evict a departed tenant's head from the bank."""
        return self._head_op("remove", name, tenant, None, None)

    def _head_op(self, op: str, name: str, tenant: str, weights,
                 label: Optional[str]) -> Dict[str, Any]:
        state = self._fanout_state(name)
        server: HeadFanoutServer = state.server
        if op == "add":
            report = server.add_head(tenant, weights)
        elif op == "swap":
            report = server.swap_head(tenant, weights)
        else:
            report = server.remove_head(tenant)
        if op != "remove":
            hv: HeadVersion = self.registry.register_head(
                name, tenant, weights, label=label)
            report["head_version"] = hv.version
        with self._lock:
            state.last_swap_report = report
        self.metrics.incr("fleet.head_swaps")
        return report

    def _server_kwargs(self, entry,
                       server_kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """A version's Server configuration.  Precedence, most specific
        wins: explicit per-entry ``server_kwargs`` > the entry's resolved
        bundle overrides > the fleet-wide defaults; the bundle's dtype
        pair (zoo bf16 compute + f32 host rows) yields whenever the caller
        set either dtype knob anywhere.  The fleet's ledger is shared
        (False, not None, when unmetered: the fleet resolved the
        SPARKDL_COST default once, and its servers must not re-resolve
        it)."""
        dtype_keys = ("compute_dtype", "output_host_dtype")
        caller_set_dtype = any(k in server_kwargs
                               or k in self._server_defaults
                               for k in dtype_keys)
        kw = dict(self._server_defaults)
        for k, v in entry.engine_overrides.items():
            if k in dtype_keys and caller_set_dtype:
                continue
            kw[k] = v
        kw.update(server_kwargs)
        kw.setdefault("cost",
                      self._cost if self._cost is not None else False)
        return kw

    def _build_server(self, entry, mv: ModelVersion,
                      server_kwargs: Dict[str, Any]) -> Server:
        """``mv``'s own Server over its own module copy
        (``FleetEntry.version_module``), so its own captured engines and
        graph pool."""
        kw = self._server_kwargs(entry, server_kwargs)
        module = entry.version_module(mv)
        if "cache" not in kw:
            if self._cache is not None:
                from sparkdl_tpu_torch.utils.digest import module_digest

                fp = self._resolve_fingerprint(entry)
                self._version_meta[(entry.name, mv.version)] = (
                    fp, module_digest(module))
                kw["cache"] = self._cache
                kw["cache_namespace"] = self._cache_prefix + (
                    entry.name, mv.version, fp)
            else:
                # the fleet resolved the process default ONCE; the
                # per-version servers must not re-resolve it
                kw["cache"] = False
        # the cost ledger's lines carry the entry's model name (tolerate
        # registry doubles that carry none)
        md = getattr(entry, "model_desc", None)
        if md is not None:
            kw.setdefault("model_desc", md)
        return Server(entry.fn, module, **kw)

    def _resolve_fingerprint(self, entry) -> Optional[str]:
        """The entry's program identity for cache survival (the
        ``cache=`` comment in ``__init__``)."""
        pf = self._program_fingerprints
        if callable(pf):
            return pf(entry.name, entry)
        if isinstance(pf, dict):
            if entry.name in pf:
                return pf[entry.name]
        from sparkdl_tpu_torch.serving.cache import lockfile_model_fingerprint

        return lockfile_model_fingerprint(entry.model_desc)

    def _swap_cache_entries(self, name: str, report: Dict[str, Any],
                            old_version: int, new_version: int) -> tuple:
        """The promote-time half of "cache-warm-across-swap": entries
        SURVIVE (re-keyed under the new version's namespace) iff the new
        version's program fingerprint is known and unchanged AND its
        weights digest-equal the old version's
        (``utils.digest.module_digest``; new weights mean new outputs, so
        a weights rollout always invalidates).  Any other promote
        invalidates the old namespace outright; with no fingerprint (the
        port's default until it has a program lockfile) every promote
        does.  The verdict rides the swap report as
        ``report["cache"]``."""
        old_meta = self._version_meta.pop((name, old_version), None)
        new_meta = self._version_meta.get((name, new_version))
        old_fp, old_wd = old_meta if old_meta is not None else (None, None)
        new_fp, new_wd = new_meta if new_meta is not None else (None, None)
        fp_unchanged = old_fp is not None and old_fp == new_fp
        weights_unchanged = old_wd is not None and old_wd == new_wd
        survived = fp_unchanged and weights_unchanged
        old_ns = self._cache_prefix + (name, old_version, old_fp)
        if survived:
            entries = self._cache.adopt(
                old_ns, self._cache_prefix + (name, new_version, new_fp))
        else:
            entries = self._cache.invalidate(old_ns)
        report["cache"] = {
            "survived": survived,
            "entries": entries,
            "fingerprint_unchanged": fp_unchanged,
            "weights_unchanged": weights_unchanged,
        }
        # the caller sweeps this namespace AGAIN after the old server's
        # drain: in-flight old-version leaders settling during the
        # drain re-insert under it, and nothing can ever read those
        return old_ns

    # -- rollout lifecycle -------------------------------------------------
    def _state(self, name: str) -> _ModelState:
        with self._lock:
            state = self._models.get(name)
        if state is None:
            raise KeyError(f"model {name!r} is not deployed; deployed: "
                           f"{sorted(self._models) or 'none'}")
        return state

    def start_rollout(self, name: str, version: Optional[int] = None,
                      canary_fraction: float = 0.1,
                      warm_example: Any = None) -> Rollout:
        """Load ``version`` (default: latest registered) ALONGSIDE the
        live version and start routing ``canary_fraction`` of traffic to
        it.  Both versions serve until :meth:`promote` or
        :meth:`rollback`; in-flight requests always complete on the
        version that admitted them."""
        if not 0.0 <= float(canary_fraction) <= 1.0:
            # validate BEFORE building the canary server: a refused
            # rollout must not leak a live dispatcher thread
            raise ValueError(f"canary fraction must be in [0, 1], got "
                             f"{canary_fraction}")
        state = self._state(name)
        if isinstance(state.server, HeadFanoutServer):
            # the fan-out contract: the backbone is IMMUTABLE after
            # deploy (that immutability is the no-recompile proof) —
            # per-tenant versioning goes through swap_head instead
            raise RuntimeError(
                f"model {name!r} is a head fan-out entry; its backbone "
                f"never versions — hot-swap per-tenant heads with "
                f"swap_head() instead")
        with self._lock:
            if state.rollout is not None:
                raise RuntimeError(
                    f"a rollout for {name!r} is already in progress "
                    f"(v{state.rollout.canary_version}); promote or "
                    f"roll back first")
        mv = self.registry.get(name, version)
        if mv.version == state.version:
            raise ValueError(f"{name!r} is already serving v{mv.version}")
        canary = self._build_server(state.entry, mv, state.server_kwargs)
        if warm_example is not None:
            try:
                canary.warmup(warm_example)
            except BaseException:  # noqa: BLE001 — cleaned up, re-raised
                # a refused rollout must not leak a live dispatcher
                # thread; the version stays cataloged (it never deployed)
                canary.close(drain=False)
                raise
        ro = Rollout(name, state.version, state.server, mv.version, canary,
                     canary_fraction,
                     exec_before=state.server.program_state())
        with self._lock:
            if state.rollout is not None or self._closed:
                already = state.rollout is not None
                state_err = ("rollout already in progress" if already
                             else "fleet is closed")
            else:
                state_err = None
                state.rollout = ro
        if state_err is not None:
            canary.close(drain=False)
            raise RuntimeError(f"cannot start rollout for {name!r}: "
                               f"{state_err}")
        self.metrics.incr("fleet.rollouts")
        flight_emit("rollout.start", model=name,
                    stable_version=ro.stable_version,
                    canary_version=mv.version,
                    fraction=float(canary_fraction))
        logger.info("fleet: rollout %s v%d -> v%d (canary %.0f%%)",
                    name, state.version, mv.version,
                    100 * canary_fraction)
        return ro

    def promote(self, name: str) -> Dict[str, Any]:
        """Flip ``name`` to its canary version and drain the old one.
        Returns the swap report (per-bucket no-recompile proof).  An
        injected ``fleet.swap`` fault aborts BEFORE any state changes —
        both versions keep serving and promote() can be retried."""
        state = self._state(name)
        ro = state.rollout
        if ro is None:
            raise RuntimeError(f"no rollout in progress for {name!r}")
        report = ro.promote()  # fleet.swap fires here; raises = no-op
        with self._lock:
            old_server = state.server
            state.server = ro.canary_server
            state.version = ro.canary_version
            state.rollout = None
            state.last_swap_report = report
            closed = self._closed
        old_ns = None
        if self._cache is not None:
            # between the phase flip above and this point v2 requests
            # simply miss (and lead their own flights) — survival only
            # decides whether the warm v1 entries carry over
            old_ns = self._swap_cache_entries(name, report,
                                              ro.stable_version,
                                              ro.canary_version)
        self.metrics.incr("fleet.swaps")
        flight_emit("rollout.promote", model=name,
                    version=ro.canary_version,
                    drained_version=ro.stable_version,
                    no_recompile=report.get("no_recompile"),
                    cache_survived=(report.get("cache") or {}).get(
                        "survived"))
        # the old version drains OUTSIDE the state lock: new requests
        # already route to the promoted server while every in-flight v1
        # request completes on v1
        old_server.close(drain=True)
        if self._cache is not None and old_ns is not None:
            # post-drain sweep: leaders that settled DURING the drain
            # re-inserted under the old namespace after the swap moved/
            # dropped it — unreachable forever, so reclaim the bytes
            self._cache.invalidate(old_ns)
        if closed:
            # a close() that raced the phase flip saw ro.active False,
            # skipped the canary, and closed only the old server — the
            # canary is the live server of a closed fleet now; stop it
            ro.canary_server.close(drain=True)
        return report

    def rollback(self, name: str) -> Dict[str, Any]:
        """Abandon ``name``'s canary: requests in flight on it complete
        on the canary version (graceful drain); the stable version never
        stopped serving."""
        state = self._state(name)
        ro = state.rollout
        if ro is None:
            raise RuntimeError(f"no rollout in progress for {name!r}")
        report = ro.rollback()  # fleet.swap fires here; raises = no-op
        with self._lock:
            state.rollout = None
            state.last_swap_report = report
        canary_ns = None
        if self._cache is not None:
            # the canary version will never serve again: its namespace
            # is unreachable — reclaim the bytes (the stable version's
            # entries never moved, so rollback keeps the cache warm)
            meta = self._version_meta.pop((name, ro.canary_version), None)
            fp = meta[0] if meta is not None else None
            canary_ns = self._cache_prefix + (name, ro.canary_version, fp)
            entries = self._cache.invalidate(canary_ns)
            report["cache"] = {"survived": False, "entries": entries,
                               "fingerprint_unchanged": None,
                               "weights_unchanged": None}
        self.metrics.incr("fleet.rollbacks")
        flight_emit("rollout.rollback", model=name,
                    drained_version=ro.canary_version,
                    version=ro.stable_version)
        ro.canary_server.close(drain=True)
        if self._cache is not None and canary_ns is not None:
            # post-drain sweep, same rationale as promote(): canary
            # leaders settling during the drain re-inserted under the
            # dead namespace
            self._cache.invalidate(canary_ns)
        return report

    def swap_report(self, name: str) -> Optional[Dict[str, Any]]:
        """The last promote/rollback report for ``name`` (None before
        the first swap)."""
        state = self._state(name)
        with self._lock:
            return state.last_swap_report

    # -- request path ------------------------------------------------------
    def submit(self, name: str, example: Any, *, tenant: str = "default",
               timeout_ms: Optional[float] = None) -> Future:
        """Admit one example for model ``name`` on behalf of ``tenant``.

        Raises ``KeyError`` (unknown model), ``ServerClosedError``
        (closed fleet), ``QuotaExceededError`` / ``QueueFullError`` /
        ``ServiceUnavailableError`` (admission — see :mod:`.admission`).
        The returned future settles exactly like ``Server.submit``'s and
        additionally carries ``fleet_model``/``fleet_version``/
        ``fleet_tenant``/``fleet_canary`` attributes."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("fleet is closed")
        state = self._state(name)
        self.metrics.incr("fleet.requests")
        inject("fleet.admit")
        # a promote/rollback between route() and the server submit can
        # close the losing server under us; one re-route retries onto
        # the winner — the zero-downtime guarantee for the racing window
        for attempt in (0, 1):
            version, server, is_canary = self._route(state)
            quota = self.admission.admit(
                tenant, pressure=server.queue_pressure(),
                unavailable_retry_after=server.breaker_retry_after())
            t0 = self._clock()
            tracer = get_tracer()
            span = tracer.start_span("fleet.request", model=name,
                                     version=version, tenant=tenant,
                                     canary=is_canary,
                                     priority=quota.priority)
            try:
                with tracer.use(span):
                    if isinstance(server, HeadFanoutServer):
                        # fan-out entries dispatch the admission tenant's
                        # OWN head after the shared backbone featurizes
                        fut = server.submit(example, tenant,
                                            timeout_ms=timeout_ms)
                    else:
                        fut = server.submit(example, timeout_ms=timeout_ms,
                                            tenant=tenant)
                break
            except ServerClosedError:
                span.finish("rejected")
                # the request never reached a live server: refund the
                # charge (slot AND token, admitted ledger backed out) —
                # whether we retry or reject, it must not cost quota
                self.admission.refund(tenant)
                with self._lock:
                    fleet_closed = self._closed
                if attempt == 0 and not fleet_closed:
                    continue  # re-route: the swap already installed v2
                self.metrics.incr("fleet.rejected")
                self._count(name, tenant, "rejected")
                raise
            except BaseException:  # noqa: BLE001 — accounted, re-raised
                self.admission.release(tenant)
                span.finish("rejected")
                self.metrics.incr("fleet.rejected")
                self._count(name, tenant, "rejected")
                raise
        self._count(name, tenant, "requests")
        if is_canary:
            self.metrics.incr("fleet.canary_requests")
            self._count(name, tenant, "canary")
        fut.fleet_model = name
        fut.fleet_version = version
        fut.fleet_tenant = tenant
        fut.fleet_canary = is_canary

        def _settle(f: Future) -> None:
            self.admission.release(tenant)
            failed = f.cancelled() or f.exception() is not None
            self.metrics.record_time("fleet.request_latency",
                                     self._clock() - t0)
            if failed:
                self.metrics.incr("fleet.request_failures")
                self._count(name, tenant, "failed")
                span.finish("error")
            else:
                self.metrics.incr("fleet.completed")
                self._count(name, tenant, "completed")
                span.finish()

        fut.add_done_callback(_settle)
        return fut

    def predict(self, name: str, example: Any, *, tenant: str = "default",
                timeout_ms: Optional[float] = None) -> Any:
        """Blocking single-request convenience: submit + wait."""
        return self.submit(name, example, tenant=tenant,
                           timeout_ms=timeout_ms).result()

    def _route(self, state: _ModelState):
        with self._lock:
            ro = state.rollout
            version, server = state.version, state.server
        if ro is not None:
            return ro.route()
        return version, server, False

    def _count(self, model: str, tenant: str, key: str) -> None:
        with self._lock:
            m = self._per_model.setdefault(model, {})
            m[key] = m.get(key, 0) + 1
            t = self._per_tenant.setdefault(tenant, {})
            t[key] = t.get(key, 0) + 1

    # -- introspection -----------------------------------------------------
    @property
    def cache(self):
        """The fleet-wide result cache (None when uncached)."""
        return self._cache

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def deployed_version(self, name: str) -> int:
        state = self._state(name)
        with self._lock:
            return state.version

    def wake(self) -> None:
        """Nudge every deployed server's batcher (stable AND canary) to
        re-evaluate its flush windows — the fleet-wide form of
        :meth:`Server.wake`, called by a virtual-time harness after it
        advances the injected clock."""
        with self._lock:
            states = list(self._models.values())
        for state in states:
            state.server.wake()
            ro = state.rollout
            if ro is not None and ro.active:
                ro.canary_server.wake()

    def health(self) -> Dict[str, Any]:
        """Aggregated liveness/readiness, built through the ONE
        :meth:`~sparkdl_tpu_torch.utils.health.HealthTracker.payload`
        schema every ``health()`` in the stack shares: fleet state is
        the WORST of its models' server states (plus canary servers
        mid-rollout) and the fleet tracker's own state (SLO breaches);
        per-model detail nests each server's own ``health()`` under the
        ``models`` extra, and ``slo`` carries the objective evaluation
        when ``slos=`` were configured."""
        extra: Dict[str, Any] = {}
        if self._slo_engine is not None:
            # evaluate BEFORE the aggregation: a breach crossing on this
            # very poll must already show as degraded
            extra["slo"] = self._slo_engine.evaluate()
        with self._lock:
            models = dict(self._models)
            closed = self._closed
        rank = {"ready": 0, "degraded": 1, "closed": 1}
        worst = "ready"
        per: Dict[str, Any] = {}
        for name, state in sorted(models.items()):
            h = state.server.health()
            entry: Dict[str, Any] = {"version": state.version,
                                     "stable": h}
            ro = state.rollout
            if ro is not None and ro.active:
                ch = ro.canary_server.health()
                entry["canary"] = {"version": ro.canary_version,
                                   "health": ch}
                if rank.get(ch["state"], 1) > rank[worst]:
                    worst = "degraded"
            per[name] = entry
            if rank.get(h["state"], 1) > rank[worst]:
                worst = "degraded"
        if rank.get(self._health.snapshot()["state"], 1) > rank[worst]:
            worst = "degraded"
        return self._health.payload(
            live=not closed,
            state_override="closed" if closed else worst,
            models=per, **extra)

    def stats(self) -> Dict[str, float]:
        """Flat fleet-level metrics summary (``fleet.*``)."""
        return self.metrics.subset("fleet.")

    def varz(self) -> Dict[str, Any]:
        """The ``/varz``-shaped fleet snapshot: per-model versions,
        rollout state, queue/bucket/executable state, and latency; the
        admission ledger; per-tenant counts; fleet counters and the full
        metrics snapshot.  JSON-serializable throughout —
        ``json.dumps(fleet.varz())`` IS the monitoring endpoint body
        (contract-tested, like ``Server.varz``)."""
        from sparkdl_tpu_torch.obs.export import metrics_snapshot

        with self._lock:
            models = dict(self._models)
            closed = self._closed
            per_model = {k: dict(v) for k, v in self._per_model.items()}
            per_tenant = {k: dict(v) for k, v in self._per_tenant.items()}
        model_section: Dict[str, Any] = {}
        for name, state in sorted(models.items()):
            srv = state.server
            ro = state.rollout

            def dist_ms(m: Metrics, metric: str) -> Dict[str, float]:
                out: Dict[str, float] = {}
                for q, key in ((50, "p50_ms"), (99, "p99_ms")):
                    v = m.percentile(metric, q, kind="timing")
                    if v is not None:
                        out[key] = round(v * 1e3, 3)
                return out

            model_section[name] = {
                "version": state.version,
                "versions": self.registry.versions(name),
                "featurize": state.entry.featurize,
                "model": state.entry.model_desc,
                "queue_depth": srv.queue_depth(),
                "queue_pressure": round(srv.queue_pressure(), 4),
                "buckets": srv.bucket_sizes,
                "executables": srv.executable_state(),
                "rollout": ro.status() if ro is not None else None,
                "last_swap": state.last_swap_report,
                "counters": per_model.get(name, {}),
                "latency_ms": dist_ms(srv.metrics,
                                      "serving.request_latency"),
            }
            if isinstance(srv, HeadFanoutServer):
                model_section[name]["headfanout"] = {
                    "tenants": srv.tenants(),
                    "bank": srv.head_state(),
                    "feature_namespace": list(srv.feature_namespace),
                }
        snap = metrics_snapshot(self.metrics)
        return {
            "fleet": {
                "closed": closed,
                "models": model_section,
                "registry": self.registry.as_dict(),
                "cache": (self._cache.info() if self._cache is not None
                          else None),
            },
            "health": self.health(),
            "admission": self.admission.snapshot(),
            "tenants": per_tenant,
            "cost": (self._cost.snapshot() if self._cost is not None
                     else None),
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith("fleet.")},
            "metrics": snap,
        }

    @property
    def cost(self):
        """The fleet-shared :class:`~sparkdl_tpu_torch.obs.cost.CostLedger`
        (None when cost attribution is off)."""
        return self._cost

    # -- lifecycle ---------------------------------------------------------
    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self, drain: bool = True) -> None:
        """Stop the whole fleet: every model's server (and any live
        canary) closes with the given drain semantics.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            models = dict(self._models)
        for name, state in sorted(models.items()):
            ro = state.rollout
            if ro is not None and ro.active:
                ro.canary_server.close(drain=drain)
            state.server.close(drain=drain)
        if self._cache is not None:
            # the whole fleet prefix dies with the fleet: every
            # per-version namespace under it is unreachable now, and
            # leaving the entries would charge a shared/process-default
            # cache's byte budget forever (the Server-anon reclaim
            # rule, applied fleet-wide)
            self._cache.invalidate(self._cache_prefix)
            self._version_meta.clear()
        logger.info("fleet: closed (%d models)", len(models))

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)
