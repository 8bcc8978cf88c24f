"""The fault-site registry (port of ``sparkdl_tpu/faults/sites.py``).

``SITE_HELP`` is the JAX package's table, copied whole, so every spec
string the JAX parser accepts or refuses is accepted or refused alike here.
The port's engine and pipelined runner call ``engine.dispatch``,
``engine.gather`` and ``pipeline.{prepare,dispatch,gather}``; the serving
layer ``serving.admit``, ``serving.model``, ``batch.topoff``, ``cache.hit``
and ``cache.stampede``; the head fan-out ``head.swap`` and
``head.dispatch``; the fleet ``fleet.admit``, ``fleet.canary`` and
``fleet.swap``; the stream scorer ``stream.source``, ``stream.commit`` and
``stream.resume``.  The sites of modules not ported yet (the compile cache,
the twin, ...) are registered but never fire.
"""

from __future__ import annotations

from typing import Tuple

#: site -> operator-facing description of what fires there.
SITE_HELP = {
    "engine.dispatch": "InferenceEngine H2D + program launch attempt",
    "engine.gather": ("InferenceEngine result force (D2H) — where a "
                      "dying device surfaces under async dispatch"),
    "pipeline.prepare": "PipelinedRunner host-prepare stage loop",
    "pipeline.dispatch": "PipelinedRunner dispatch stage loop",
    "pipeline.gather": "PipelinedRunner gather stage loop",
    "serving.admit": "DynamicBatcher.submit admission",
    "serving.model": "Server model-call attempt (watchdog-timed)",
    "batch.topoff": ("ragged top-off pull in Server._execute — a sleep "
                     "rule holds a forming batch open before dispatch; "
                     "an error rule aborts the pull, which must degrade "
                     "to baseline padding (base batch still dispatches, "
                     "no request lost)"),
    "compile.cache": ("persistent compile-cache configure/validation "
                      "(parallel.compile_cache) — an injected error is "
                      "a corrupt cache dir/manifest, which must degrade "
                      "to fresh compiles, never take down serving"),
    "cache.hit": ("InferenceCache hit return path — an injected error "
                  "corrupts the copy handed back, which the output-"
                  "digest re-check must catch (entry invalidated, "
                  "request re-dispatched)"),
    "cache.stampede": ("single-flight leader dispatch window in "
                       "Server.submit — a sleep rule holds the leader "
                       "open so follower coalescing is observable; an "
                       "error rule is a leader failure every follower "
                       "must see (and that must cache nothing)"),
    "head.dispatch": ("HeadBank vmapped head-pass dispatch (gather-by-"
                      "tenant-index over the stacked bank) — an error "
                      "rule fails that head pass only; the backbone "
                      "program and the bank state are untouched"),
    "head.swap": ("head-bank mutation attempt (add/swap/evict of one "
                  "tenant's head) — fires BEFORE any state changes, so "
                  "an injected fault aborts the mutation with the bank "
                  "unchanged and the old head still serving"),
    "fleet.admit": "Fleet front-door admission (tenant quota/priority gate)",
    "fleet.canary": "Fleet canary routing decision during a rollout",
    "fleet.swap": "Fleet version swap attempt (rollout promote/rollback)",
    "stream.source": ("StreamSource poll mid-iteration (a sleep is a "
                      "stalled source the watchdog must catch; a "
                      "transient error is a flaky feed the re-poll "
                      "backoff absorbs)"),
    "stream.commit": ("StreamScorer between output-artifact write and "
                      "journal commit — the exactly-once crash window"),
    "stream.resume": ("journal replay of an uncommitted chunk at "
                      "restart (redelivery-time failure)"),
    "twin.tick": ("traffic-twin virtual tick boundary — a sleep rule "
                  "stretches wall time without moving virtual time "
                  "(the determinism contract must hold); an error rule "
                  "is a control-plane crash mid-day"),
    "twin.arrival": ("traffic-twin per-arrival submit into the real "
                     "fleet — a transient error rule drops that "
                     "arrival at the door (scored as a shed, the "
                     "scenario replay stays deterministic)"),
    "probe.device": "__graft_entry__ device-count relay probe",
    "bench.relay_probe": "bench.py relay profile probe",
    "io.decode": "host image decode, per row",
    "cost.attr": ("cost-ledger attribution of a settled batch or cache "
                  "hit (observability: callers degrade to an error "
                  "counter, a ledger failure never fails the request)"),
}

#: Registered injection sites, in layer order.
SITES: Tuple[str, ...] = tuple(SITE_HELP)


def validate_site(site: str) -> str:
    """Return ``site`` if registered, else raise ``ValueError`` naming the
    known sites."""
    if site not in SITE_HELP:
        raise ValueError(
            f"unknown fault site {site!r}; known sites: "
            f"{', '.join(SITES)}")
    return site
