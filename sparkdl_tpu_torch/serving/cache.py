"""Content-addressed inference result cache + single-flight coalescing
(port of ``sparkdl_tpu/serving/cache.py``).

The engine computes a deterministic function of (program, weights, input),
so an identical input is an identical output.  A bounded (entries AND
bytes) LRU keyed on content digests serves repeats, and single-flight
coalescing makes N concurrent identical requests cost ONE engine dispatch.

Key schema: every entry key is a tuple ``(namespace..., input_digest)``.
``namespace`` says which function computed the result (a standalone
:class:`~sparkdl_tpu_torch.serving.server.Server` gets a process-unique
default, so two servers sharing the process cache never serve each
other's rows); ``input_digest`` is :mod:`sparkdl_tpu_torch.utils.digest`'s
sha256 over the payload's dtype/shape/bytes.

:meth:`InferenceCache.lookup` answers one of:

* **hit**: an independent copy of the stored value, after an integrity
  re-check (the output digest recorded at insert time is recomputed over
  the copy; a mismatch, such as the injected ``cache.hit`` corruption,
  invalidates the entry and demotes the call to a miss);
* **leader**: the first requester of a missing key; it runs the dispatch
  and MUST settle the flight (:meth:`InferenceCache.settle` inserts and
  resolves every parked follower with its own copy;
  :meth:`InferenceCache.fail` resolves them with the leader's error and
  caches nothing);
* **follower**: a request for a key some leader is computing; it parks on
  a future the leader resolves and costs zero dispatches.

Bounds: ``max_entries`` and ``max_bytes`` both cap the store (least
recently used first; an entry bigger than the whole byte budget is served
but never stored); a cap of 0 disables storage cleanly.

Gate: ``SPARKDL_CACHE`` (consulted once, on first use)::

    unset / "0" / "off"   -> no process-default cache (the default)
    "1" / "on"            -> process-default cache, default bounds
    "entries=N,mb=M"      -> process-default cache, custom bounds

Fault sites: ``cache.hit`` inside the hit path (an injected error corrupts
the copy handed back, which the digest re-check must catch) and
``cache.stampede`` on the leader's path in ``Server.submit``.

The head fan-out's half: :func:`feature_namespace` (the feature-cut
namespace, the JAX tuple), :func:`lockfile_model_fingerprint` (the
model's committed program identity in the port's
``PROGRAMS_TORCH.lock.json``, which pins the namespace and the hot-swap
and promote survival proofs) and :func:`head_fanout_benchmark`.

Given the same sequence of lookups, settles and evictions, the counters
(``cache.hits``, ``cache.misses``, ``cache.coalesced``,
``cache.evictions``, ...) and the flight events (``cache.hit``,
``cache.miss``, ``cache.coalesced``, ``cache.evict``,
``cache.invalidate``) are the JAX package's.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import Future
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.faults.errors import InjectedFault
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map
from sparkdl_tpu_torch.utils.digest import content_digest
from sparkdl_tpu_torch.utils.logging import get_logger
from sparkdl_tpu_torch.utils.metrics import Metrics

logger = get_logger(__name__)

__all__ = [
    "InferenceCache",
    "CacheFlight",
    "lockfile_model_fingerprint",
    "get_default",
    "configure",
    "configure_from_env",
    "cache_from_env",
]

#: default bounds for an env-configured cache ("1"/"on", or omitted keys
#: in the "entries=N,mb=M" form)
DEFAULT_MAX_ENTRIES = 4096
DEFAULT_MAX_BYTES = 256 << 20

_OFF = ("", "0", "false", "off", "no")
_ON = ("1", "true", "on", "yes")


def _tree_copy(value: Any) -> Any:
    """Independent deep copy of an array pytree: a cached value handed to
    one caller never aliases the stored entry or another caller's row."""
    return _tree_map(lambda a: np.array(a, copy=True), value)


def _tree_nbytes(value: Any) -> int:
    return sum(int(getattr(leaf, "nbytes", 0) or 0)
               for leaf in _tree_leaves(value))


class CacheFlight:
    """One in-flight single-flight computation: the leader's token.

    Followers park on :class:`~concurrent.futures.Future` s the
    leader's :meth:`InferenceCache.settle` / :meth:`InferenceCache.
    fail` resolves.  Plain data: all mutation happens under the cache
    lock."""

    __slots__ = ("key", "followers", "done")

    def __init__(self, key: Tuple[Hashable, ...]):
        self.key = key
        self.followers: List[Future] = []
        self.done = False


class _Entry:
    __slots__ = ("value", "nbytes", "digest", "hits")

    def __init__(self, value: Any, nbytes: int, digest: str):
        self.value = value
        self.nbytes = nbytes
        self.digest = digest
        self.hits = 0


class InferenceCache:
    """Bounded content-addressed LRU result store + single-flight table.

    Thread model: one lock guards the entry dict, the byte ledger and the
    flight table; value copies are made outside the lock (entries are
    immutable once inserted), so the lock hold is O(1) bookkeeping even
    for megabyte rows.  Metrics ride the cache's own registry unless one
    is shared in (``cache.*`` counters + entry/byte gauges, surfaced by
    ``Server.varz()``)."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 metrics: Optional[Metrics] = None):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = named_lock("serving.cache")
        self._data: Dict[Tuple[Hashable, ...], _Entry] = {}
        self._bytes = 0
        self._flights: Dict[Tuple[Hashable, ...], CacheFlight] = {}

    # -- the request path --------------------------------------------------
    def lookup(self, key: Tuple[Hashable, ...]):
        """``("hit", value)`` | ``("follower", future)`` |
        ``("leader", flight)`` — see the module docstring.  A leader
        MUST later call :meth:`settle` or :meth:`fail` with its
        flight."""
        hit = self._probe(key)
        if hit is not None:
            return "hit", hit
        fut: Optional[Future] = None
        with self._lock:
            # re-probe under the lock: a leader may have settled between
            # the optimistic probe above and here
            entry = self._data.get(key)
            if entry is not None:
                self._data.pop(key)
                self._data[key] = entry  # MRU position
                entry.hits += 1
                stored, hits = entry.value, entry.hits
            else:
                flight = self._flights.get(key)
                if flight is not None:
                    fut = Future()
                    flight.followers.append(fut)
                    n_followers = len(flight.followers)
                else:
                    flight = CacheFlight(key)
                    self._flights[key] = flight
        if entry is not None:
            # settled-while-we-looked: serve it (skip the digest
            # re-check — the entry was inserted microseconds ago,
            # under the lock we just held)
            self.metrics.incr("cache.hits")
            flight_emit("cache.hit", hits=hits)
            return "hit", _tree_copy(stored)
        if fut is not None:
            self.metrics.incr("cache.coalesced")
            flight_emit("cache.coalesced", followers=n_followers)
            return "follower", fut
        self.metrics.incr("cache.misses")
        flight_emit("cache.miss")
        return "leader", flight

    def _probe(self, key: Tuple[Hashable, ...]) -> Optional[Any]:
        """Optimistic hit probe: an independent copy of the stored
        value after the integrity re-check, or None (absent OR the
        re-check demoted a corrupt entry to a miss)."""
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return None
            self._data.pop(key)
            self._data[key] = entry  # MRU position
            entry.hits += 1
            stored, digest, hits, nbytes = (entry.value, entry.digest,
                                            entry.hits, entry.nbytes)
        value = _tree_copy(stored)
        corrupted = False
        try:
            # chaos hook: an error rule here stands in for bit rot / an
            # aliasing bug — the copy is corrupted and the digest
            # re-check below must catch it
            inject("cache.hit")
        except InjectedFault:
            corrupted = True
            self._corrupt_in_place(value)
        if content_digest(value) != digest:
            self.metrics.incr("cache.corruptions")
            logger.warning(
                "cache entry failed its output-digest re-check "
                "(injected=%s); invalidating and re-dispatching",
                corrupted)
            self.invalidate_key(key)
            return None  # demoted to a miss: the request re-computes
        self.metrics.incr("cache.hits")
        flight_emit("cache.hit", hits=hits, nbytes=nbytes)
        return value

    def settle(self, flight: CacheFlight, value: Any,
               store: bool = True) -> None:
        """Leader success: insert ``value`` (bounded; see class
        docstring) and resolve every follower with an independent
        copy.  ``store=False`` resolves the followers without
        inserting — how a leader that outlived its server's close()
        settles (its namespace was already reclaimed; inserting now
        would orphan the entry forever)."""
        stored = _tree_copy(value)
        nbytes = _tree_nbytes(stored)
        digest = content_digest(stored)
        evicted: List[int] = []  # the evicted entries' bytes
        inserted = False
        with self._lock:
            followers = flight.followers
            flight.done = True
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
            if (store and self.max_entries > 0 and self.max_bytes > 0
                    and nbytes <= self.max_bytes):
                if flight.key in self._data:
                    old = self._data.pop(flight.key)
                    self._bytes -= old.nbytes
                while self._data and (
                        len(self._data) >= self.max_entries
                        or self._bytes + nbytes > self.max_bytes):
                    k = next(iter(self._data))  # LRU = oldest position
                    old = self._data.pop(k)
                    self._bytes -= old.nbytes
                    evicted.append(old.nbytes)
                self._data[flight.key] = _Entry(stored, nbytes, digest)
                self._bytes += nbytes
                inserted = True
            entries, total = len(self._data), self._bytes
        if inserted:
            self.metrics.incr("cache.inserts")
        self.metrics.gauge("cache.entries", entries)
        self.metrics.gauge("cache.bytes", total)
        for nb in evicted:
            self.metrics.incr("cache.evictions")
            flight_emit("cache.evict", nbytes=nb)
        for fut in followers:
            if not fut.done():
                fut.set_result(_tree_copy(value))

    def fail(self, flight: CacheFlight, exc: BaseException) -> None:
        """Leader failure: every follower sees the leader's error;
        NOTHING is cached — a failed dispatch must never poison the
        store for the retries that follow it."""
        with self._lock:
            followers = flight.followers
            flight.done = True
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]
        self.metrics.incr("cache.leader_failures")
        for fut in followers:
            if not fut.done():
                fut.set_exception(exc)

    # -- direct get/put (the streaming replay path) ------------------------
    def get(self, key: Tuple[Hashable, ...]) -> Optional[Any]:
        """Plain probe without single-flight: the stored value as a
        copy (digest-re-checked like :meth:`lookup`), or None: no flight
        churn and no miss accounting (the streaming journal replay's
        probe in the JAX package)."""
        return self._probe(key)

    def put(self, key: Tuple[Hashable, ...], value: Any) -> None:
        """Direct insert (no flight)."""
        flight = CacheFlight(key)
        flight.done = True
        self.settle(flight, value)

    # -- invalidation ------------------------------------------------------
    def invalidate_key(self, key: Tuple[Hashable, ...]) -> int:
        with self._lock:
            entry = self._data.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
            entries, total = len(self._data), self._bytes
        if entry is None:
            return 0
        self.metrics.incr("cache.invalidations")
        self.metrics.gauge("cache.entries", entries)
        self.metrics.gauge("cache.bytes", total)
        flight_emit("cache.invalidate", scope="key", entries=1)
        return 1

    def invalidate(self, namespace: Tuple[Hashable, ...]) -> int:
        """Drop every entry whose key starts with ``namespace`` (a closed
        server's own namespace; a hot-swap whose weights changed)."""
        ns = tuple(namespace)
        with self._lock:
            doomed = [k for k in self._data if k[:len(ns)] == ns]
            dropped = 0
            for k in doomed:
                entry = self._data.pop(k)
                self._bytes -= entry.nbytes
                dropped += 1
            entries, total = len(self._data), self._bytes
        if dropped:
            self.metrics.incr("cache.invalidations", dropped)
            self.metrics.gauge("cache.entries", entries)
            self.metrics.gauge("cache.bytes", total)
            flight_emit("cache.invalidate", scope="namespace",
                        entries=dropped)
        return dropped

    def adopt(self, old_namespace: Tuple[Hashable, ...],
              new_namespace: Tuple[Hashable, ...]) -> int:
        """Re-key every ``old_namespace`` entry under ``new_namespace``
        (LRU order preserved): how entries survive a hot-swap to a
        version that provably computes the same function."""
        old = tuple(old_namespace)
        new = tuple(new_namespace)
        if old == new:
            return 0
        moved = 0
        with self._lock:
            for k in [k for k in self._data if k[:len(old)] == old]:
                entry = self._data.pop(k)
                nk = new + k[len(old):]
                existing = self._data.pop(nk, None)
                if existing is not None:
                    # a post-flip request already settled this key under
                    # the new namespace (it raced the adopt): keep the
                    # fresher entry and release the old one's bytes
                    self._bytes -= entry.nbytes
                    self._data[nk] = existing
                    continue
                self._data[nk] = entry
                moved += 1
        if moved:
            self.metrics.incr("cache.adopted", moved)
        return moved

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._data)

    @property
    def total_bytes(self) -> int:
        return self._bytes

    def info(self) -> Dict[str, Any]:
        """JSON-serializable snapshot (the ``cache`` section of
        ``Server.varz()``), the JAX package's schema: ``counters`` always
        carries the feature-cut keys (``cache.feature_hits`` /
        ``cache.feature_requests``), zero until the head fan-out tier is
        ported."""
        with self._lock:
            entries = len(self._data)
            total = self._bytes
            inflight = len(self._flights)
        counters = {"cache.feature_hits": 0, "cache.feature_requests": 0}
        counters.update(
            {k: v for k, v in
             self.metrics.snapshot_raw()["counters"].items()
             if k.startswith("cache.")})
        return {
            "entries": entries,
            "bytes": total,
            "max_entries": self.max_entries,
            "max_bytes": self.max_bytes,
            "inflight_leaders": inflight,
            "counters": counters,
        }

    @staticmethod
    def _corrupt_in_place(value: Any) -> None:
        """Flip one byte of the first non-empty leaf: the injected
        ``cache.hit`` corruption the digest re-check must catch."""
        for leaf in _tree_leaves(value):
            a = np.asarray(leaf)
            if a.size:
                flat = a.view(np.uint8).reshape(-1)
                flat[0] ^= 0xFF
                return


# -- swap-survival fingerprints --------------------------------------------
def lockfile_model_fingerprint(model: str,
                               path: Optional[str] = None
                               ) -> Optional[str]:
    """The committed program identity of ``model``'s serving programs:
    sha256 over the sorted ``(program_name, fingerprint)`` pairs of every
    dispatch record of the port's program lockfile
    (``PROGRAMS_TORCH.lock.json`` by default, ``analysis.program.
    lockfile.DEFAULT_LOCKFILE``) whose ``model`` matches, as the JAX
    package computes it over its own lockfile.  This is what makes "same
    computation" checkable without a card at hot-swap and promote time.
    None when the model has no audited programs (a caller's own fn) or
    the lockfile is missing or unreadable: with no fingerprint there is
    no proof, so swaps invalidate."""
    import hashlib

    from sparkdl_tpu_torch.analysis.program.lockfile import (
        DEFAULT_LOCKFILE, read_lockfile)

    path = path or DEFAULT_LOCKFILE
    if not os.path.isfile(path):
        return None
    try:
        doc = read_lockfile(path)
    except (ValueError, OSError):
        return None
    pairs = sorted(
        (name, rec.get("fingerprint", ""))
        for name, rec in doc.get("programs", {}).items()
        if rec.get("model") == model and rec.get("kind") == "dispatch")
    if not pairs:
        return None
    h = hashlib.sha256()
    for name, fp in pairs:
        h.update(f"{name}={fp}\n".encode())
    return h.hexdigest()


def feature_namespace(model_desc: str,
                      fingerprint: Optional[str],
                      weights_digest: str) -> Tuple[str, str, str, str]:
    """The FEATURE-CUT cache namespace of the head fan-out: ``("features",
    model_desc, backbone_program_fingerprint, backbone_weights_digest)``,
    the JAX package's tuple.

    Keyed on the backbone's identity and nothing about the heads: a head
    add, swap or evict changes neither part, so feature entries stay warm
    across head churn; a backbone weight change rotates
    ``weights_digest``, so stale features can never serve.
    ``fingerprint=None`` pins ``"unpinned"``."""
    return ("features", str(model_desc),
            fingerprint if fingerprint else "unpinned",
            str(weights_digest))


# -- module default (the faults.inject pattern) -----------------------------
_UNSET = object()   # before the first ask consults SPARKDL_CACHE
_default: Any = _UNSET
_default_lock = named_lock("serving.cache.configure")


def cache_from_env() -> Optional[InferenceCache]:
    """An :class:`InferenceCache` per the ``SPARKDL_CACHE`` grammar
    (module docstring), or None when the knob is off/unset.  Raises on a
    malformed spec: a typo'd cache config fails loudly instead of
    running uncached."""
    raw = os.environ.get("SPARKDL_CACHE", "").strip()
    low = raw.lower()
    if low in _OFF:
        return None
    if low in _ON:
        return InferenceCache()
    entries, max_bytes = DEFAULT_MAX_ENTRIES, DEFAULT_MAX_BYTES
    for pair in raw.split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"bad SPARKDL_CACHE clause {pair!r}; grammar: "
                             f"0|1|entries=N,mb=M")
        k, v = (s.strip() for s in pair.split("=", 1))
        try:
            if k == "entries":
                entries = int(v)
            elif k == "mb":
                max_bytes = int(float(v) * (1 << 20))
            else:
                raise ValueError(f"unknown SPARKDL_CACHE key {k!r} "
                                 f"(known: entries, mb)")
        except ValueError as e:
            if "SPARKDL_CACHE" in str(e):
                raise
            raise ValueError(f"bad SPARKDL_CACHE value {pair!r}") from None
    return InferenceCache(max_entries=entries, max_bytes=max_bytes)


def get_default() -> Optional[InferenceCache]:
    """The process-default cache (resolving ``SPARKDL_CACHE`` on first
    ask), or None.  Disabled path: one module-global read + identity
    check.  First-ask resolution is serialized under the configure lock,
    so two servers constructed concurrently never each build their own
    byte budget."""
    global _default
    c = _default
    if c is not _UNSET:
        return c
    with _default_lock:
        if _default is _UNSET:
            _default = cache_from_env()
        return _default


def configure(cache: Optional[InferenceCache]) -> Optional[InferenceCache]:
    """Install ``cache`` as the process default (None disables, and
    stops consulting the env until :func:`configure_from_env`)."""
    global _default
    with _default_lock:
        _default = cache
    return cache


def configure_from_env() -> Optional[InferenceCache]:
    """(Re-)configure the process default from ``SPARKDL_CACHE``."""
    return configure(cache_from_env())


_namespace_seq = itertools.count(1)  # next() is atomic in CPython


def unique_namespace(prefix: str) -> Tuple[str, str]:
    """A process-unique default namespace for a standalone consumer
    sharing the process-default cache: two servers that never declared
    a shared identity must never serve each other's rows."""
    return (prefix, f"anon-{next(_namespace_seq)}")


def example_digest(example: Any) -> str:
    """The request-payload digest ``Server.submit`` keys on (one shared
    spelling so tests and adapters can precompute keys)."""
    return content_digest(example)


def resolve_cache(cache: Any, namespace: Optional[Any] = None,
                  prefix: str = "server"
                  ) -> Tuple[Optional[InferenceCache],
                             Tuple[Hashable, ...], bool]:
    """The constructor-side resolution rule of ``Server``: ``(cache,
    namespace, owned)``.

    ``cache=None`` resolves the ``SPARKDL_CACHE`` process default;
    ``cache=False`` forces uncached; an :class:`InferenceCache` passes
    through.  An explicit ``namespace`` is NOT owned (its lifecycle
    belongs to whoever assigned it); with none given, a live cache gets a
    process-unique anon namespace the consumer OWNS and reclaims on
    close."""
    if cache is None:
        cache = get_default()
    elif cache is False:
        cache = None
    if namespace is not None:
        return cache, tuple(namespace), False
    if cache is not None:
        return cache, unique_namespace(prefix), True
    return None, (prefix,), False


def zipfian_cache_benchmark(n_requests: int = 160,
                            universe: int = 16,
                            zipf_s: float = 1.1,
                            dispatch_ms: float = 10.0,
                            seed: int = 0,
                            feature_dim: int = 16,
                            max_batch_size: int = 8,
                            max_entries: int = DEFAULT_MAX_ENTRIES,
                            max_bytes: int = DEFAULT_MAX_BYTES
                            ) -> Dict[str, Any]:
    """Chip-free proof of the cache's throughput lever: a sleep stands in
    for the device.

    A seeded Zipfian replay (``p(rank r) ∝ 1/r^zipf_s`` over ``universe``
    distinct payloads) is served twice through a
    :class:`~sparkdl_tpu_torch.serving.server.Server` whose bucket engines
    sleep ``dispatch_ms`` a dispatch: uncached (every request pays a
    dispatch) and through an :class:`InferenceCache` (only single-flight
    leaders do).  The replay is sequential and the cache holds the whole
    universe, so every repeat must hit: ``hits >= n_requests - distinct``.
    Outputs are checked bit-identical between the two passes.  The server
    runs on the entry points' default device."""
    import time

    import torch

    from sparkdl_tpu_torch.serving.server import Server

    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(
        size=(feature_dim, feature_dim)).astype(np.float32))
    module = torch.nn.Module()
    module.register_buffer("w", w)

    def fn(m, x):
        return torch.tanh(x @ m.w)

    payloads = [rng.normal(size=(feature_dim,)).astype(np.float32)
                for _ in range(universe)]
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    probs = ranks ** -float(zipf_s)
    probs /= probs.sum()
    seq = [int(i) for i in rng.choice(universe, size=n_requests, p=probs)]
    distinct = len(set(seq))
    analytic_hit_rate = (n_requests - distinct) / n_requests

    def build(cache):
        srv = Server(fn, module, max_batch_size=max_batch_size,
                     max_wait_ms=0.5, max_queue=n_requests + 16,
                     cache=cache)
        srv.warmup(payloads[0])  # capture BEFORE the sleep wrap below
        calls = [0]
        for b in srv.bucket_sizes:
            eng = srv._engine_for(b)
            real = eng.run_padded

            def slow(batch, _real=real):  # the synthetic slow device
                calls[0] += 1
                time.sleep(dispatch_ms / 1e3)
                return _real(batch)

            eng.run_padded = slow
        return srv, calls

    srv, calls = build(cache=False)
    t0 = time.perf_counter()
    uncached_out = [srv.predict(payloads[i]) for i in seq]
    uncached_s = time.perf_counter() - t0
    uncached_dispatches = calls[0]
    srv.close()

    cache = InferenceCache(max_entries=max_entries, max_bytes=max_bytes)
    srv, calls = build(cache=cache)
    t0 = time.perf_counter()
    cached_out = [srv.predict(payloads[i]) for i in seq]
    cached_s = time.perf_counter() - t0
    cached_dispatches = calls[0]
    # occupancy BEFORE close(): close() reclaims the anon namespace
    cache_entries, cache_bytes = len(cache), cache.total_bytes
    srv.close()

    bit_identical = all(np.array_equal(a, b)
                        for a, b in zip(uncached_out, cached_out))
    counters = cache.metrics.snapshot_raw()["counters"]
    hits = counters.get("cache.hits", 0.0)
    return {
        "n_requests": n_requests,
        "universe": universe,
        "zipf_s": zipf_s,
        "distinct": distinct,
        "dispatch_ms": dispatch_ms,
        "uncached_s": round(uncached_s, 4),
        "cached_s": round(cached_s, 4),
        "speedup": round(uncached_s / cached_s, 4),
        "hit_rate": round(hits / n_requests, 4),
        "analytic_hit_rate": round(analytic_hit_rate, 4),
        "hits": int(hits),
        "misses": int(counters.get("cache.misses", 0.0)),
        "uncached_dispatches": uncached_dispatches,
        "cached_dispatches": cached_dispatches,
        "bit_identical": bit_identical,
        "cache_entries": cache_entries,
        "cache_bytes": cache_bytes,
    }


def head_fanout_benchmark(n_requests: int = 160,
                          universe: int = 16,
                          tenants: int = 64,
                          zipf_s: float = 1.1,
                          dispatch_ms: float = 10.0,
                          seed: int = 0,
                          max_batch_size: int = 8,
                          device=None) -> Dict[str, Any]:
    """Deterministic proof of the shared-backbone fan-out, the JAX
    package's replay on the port: a seeded Zipf-content,
    ``tenants``-tenant replay served through a
    :class:`~sparkdl_tpu_torch.serving.server.HeadFanoutServer` over the
    stand-in backbone (:func:`~sparkdl_tpu_torch.parallel.engine.
    head_fanout_backbone_fn`) whose bucket engines sleep ``dispatch_ms`` a
    dispatch (the synthetic slow device, so the result is stable on any
    host), on the entry points' default device unless ``device`` is given:

    * FULL-MODEL BASELINE: the replay through an UNCACHED fan-out server,
      every request paying the backbone;
    * COLD PASS (feature cache on, empty): the replay is sequential, so
      backbone dispatches MUST equal the distinct content digests;
    * WARM PASS: the replay again, with ZERO further backbone dispatches.

    Every output row of the three passes must equal an INDEPENDENT
    per-tenant full-model oracle (``head_fanout_oracle_fn``, one unbatched
    row at a time) bit for bit (``bit_identical``).  The seeded draws are
    the JAX package's, so the deterministic keys (``distinct``,
    ``backbone_dispatches``, ``baseline_dispatches``, ``feature_hits``,
    ``bank_*``) equal its."""
    import time as _time

    import torch

    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.parallel.engine import (head_fanout_backbone_fn,
                                                   head_fanout_module,
                                                   head_fanout_oracle_fn)
    from sparkdl_tpu_torch.serving.server import HeadFanoutServer

    device = resolve_device(device)
    d_in, d_feat, classes = 12, 16, 4
    rng = np.random.default_rng(seed)
    variables = {"backbone": rng.normal(
        size=(d_in, d_feat)).astype(np.float32)}
    heads = {f"t{i:03d}": {
        "kernel": rng.normal(size=(d_feat, classes)).astype(np.float32),
        "bias": rng.normal(size=(classes,)).astype(np.float32),
    } for i in range(tenants)}
    payloads = [rng.normal(size=(d_in,)).astype(np.float32)
                for _ in range(universe)]
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    probs = ranks ** -float(zipf_s)
    probs /= probs.sum()
    seq = [(int(c), f"t{int(t):03d}") for c, t in zip(
        rng.choice(universe, size=n_requests, p=probs),
        rng.integers(0, tenants, size=n_requests))]
    distinct = len({c for c, _ in seq})
    module = head_fanout_module(variables)

    def oracle_row(content: int, tenant: str) -> np.ndarray:
        fused = head_fanout_module({**variables, **heads[tenant]}).to(device)
        with torch.inference_mode():
            row = torch.from_numpy(payloads[content]).to(device)
            return head_fanout_oracle_fn(fused, row).cpu().numpy()

    def build(cache):
        srv = HeadFanoutServer(
            head_fanout_backbone_fn, module, model_desc="headfanout",
            cache=cache, max_batch_size=max_batch_size, max_wait_ms=0.5,
            max_queue=n_requests + 16, device=device)
        for t, h in heads.items():
            srv.add_head(t, h)
        srv.warmup(payloads[0])  # capture BEFORE the sleep wrap below
        srv.warm_head(np.zeros(d_feat, np.float32))
        calls = [0]
        for b in srv.bucket_sizes:
            eng = srv.backbone._engine_for(b)
            real = eng.run_padded

            def slow(batch, _real=real):  # the synthetic slow device
                calls[0] += 1
                _time.sleep(dispatch_ms / 1e3)
                return _real(batch)

            eng.run_padded = slow
        return srv, calls

    def replay(srv):
        lat, out = [], []
        for content, tenant in seq:
            t0 = _time.perf_counter()
            y = srv.predict(payloads[content], tenant)
            lat.append(_time.perf_counter() - t0)
            out.append(np.asarray(y))
        return lat, out

    def pcts(lat):
        return (round(float(np.percentile(lat, 50)) * 1e3, 3),
                round(float(np.percentile(lat, 99)) * 1e3, 3))

    # full-model baseline: no feature cache, every request pays the
    # backbone
    srv, calls = build(cache=False)
    base_lat, base_out = replay(srv)
    baseline_dispatches = calls[0]
    srv.close()

    cache = InferenceCache()
    srv, calls = build(cache=cache)
    _, cold_out = replay(srv)
    cold_dispatches = calls[0]
    # sequential replay + single flight: a content digest pays the
    # backbone exactly once
    if cold_dispatches != distinct:
        raise AssertionError(
            f"backbone dispatched {cold_dispatches} times for "
            f"{distinct} distinct content digests")
    warm_lat, warm_out = replay(srv)
    if calls[0] != cold_dispatches:
        raise AssertionError(
            f"warm replay re-dispatched the backbone "
            f"({calls[0] - cold_dispatches} extra)")
    snap = srv.metrics.snapshot_raw()["counters"]
    feature_hits = int(snap.get("headfanout.feature_hits", 0))
    bank = srv.head_stats()
    srv.close()

    oracle = {key: oracle_row(*key) for key in set(seq)}
    bit_identical = all(
        np.array_equal(y, oracle[key])
        for outs in (base_out, cold_out, warm_out)
        for key, y in zip(seq, outs))
    base_p50, base_p99 = pcts(base_lat)
    warm_p50, warm_p99 = pcts(warm_lat)
    return {
        "n_requests": n_requests,
        "universe": universe,
        "tenants": tenants,
        "zipf_s": zipf_s,
        "distinct": distinct,
        "dispatch_ms": dispatch_ms,
        "backbone_dispatches": cold_dispatches,
        "baseline_dispatches": baseline_dispatches,
        "dispatch_ratio": round(cold_dispatches / distinct, 4),
        "baseline_p50_ms": base_p50,
        "baseline_p99_ms": base_p99,
        "warm_p50_ms": warm_p50,
        "warm_p99_ms": warm_p99,
        "p50_reduction": round(1.0 - warm_p50 / base_p50, 4),
        "feature_hits": feature_hits,
        "bank_param_bytes_per_chip": bank.get("param_bytes_per_chip"),
        "bank_capacity": bank.get("capacity"),
        "bank_mode": bank.get("mode"),
        "bit_identical": bit_identical,
    }
