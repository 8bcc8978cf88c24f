"""The port's result cache and content digests held against the JAX
package's, on the CPU.

A single array digests to the JAX package's hex exactly
(``array_digest``, ``content_chunk_id``, ``content_digest``); a pytree
digest hashes the port's own structure description (a documented
deviation), so it is held to discriminate as JAX's does, not to equal it.
The same seeded Zipf replay, with waves of concurrent identical requests,
through both packages' ``InferenceCache`` gives the same hit, miss,
coalesce, insert and eviction counters.  Then the contracts of the JAX
package's ``tests/test_cache.py`` through the port's ``Server``:
independent copies, LRU bounds, namespace isolation and reclaim,
single-flight coalescing, leader failure, follower deadlines, the injected
hit corruption, the chip-free Zipf benchmark and the ``SPARKDL_CACHE``
grammar.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import sparkdl_tpu.serving.cache as jcache
import sparkdl_tpu.utils.digest as jdigest
import sparkdl_tpu_torch
from sparkdl_tpu_torch import faults
from sparkdl_tpu_torch.serving import DeadlineExceededError, Server
from sparkdl_tpu_torch.serving import cache as cache_mod
from sparkdl_tpu_torch.serving.cache import (InferenceCache, cache_from_env,
                                             example_digest,
                                             zipfian_cache_benchmark)
from sparkdl_tpu_torch.utils.digest import (array_digest, content_chunk_id,
                                            content_digest)

# -- digests ---------------------------------------------------------------

ARRAYS = {
    "f32": np.arange(24, dtype=np.float32).reshape(4, 6),
    "f64": np.linspace(-1, 1, 7),
    "u8": np.random.default_rng(0).integers(0, 256, (3, 5, 3),
                                             dtype=np.uint8),
    "i64": np.arange(-4, 4, dtype=np.int64),
    "bool": np.array([True, False, True]),
    "0d": np.array(3.5, np.float32),
    "strided": np.arange(40, dtype=np.float32).reshape(5, 8)[:, ::3],
    "empty": np.zeros((0, 4), np.float16),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_single_array_digests_are_jax_hex(name):
    a = ARRAYS[name]
    assert array_digest(a) == jdigest.array_digest(a)
    assert content_digest(a) == jdigest.content_digest(a)
    assert content_chunk_id(42, a) == jdigest.content_chunk_id(42, a)
    assert example_digest(a) == jcache.example_digest(a)


def test_cpu_tensor_and_scalar_digest_as_numpy():
    a = ARRAYS["f32"]
    assert array_digest(torch.from_numpy(a)) == jdigest.array_digest(a)
    assert content_digest(torch.from_numpy(a)) == jdigest.content_digest(a)
    assert content_digest(2.5) == jdigest.content_digest(2.5)


def test_digest_discriminates_dtype_shape_bytes_and_structure():
    arr = ARRAYS["f32"]
    assert array_digest(arr) != array_digest(arr.astype(np.float64))
    assert array_digest(arr) != array_digest(arr.reshape(6, 4))
    mutated = arr.copy()
    mutated[0, 0] += 1
    assert array_digest(arr) != array_digest(mutated)
    assert content_chunk_id(7, arr) == f"{7:08d}-{array_digest(arr)[:16]}"
    # pytrees: leaves + the port's structure description (the JAX package
    # hashes str(jax treedef), so pytree digests differ across packages)
    assert content_digest({"a": arr}) != content_digest({"b": arr})
    assert content_digest([arr, arr]) != content_digest([arr])
    assert content_digest([arr]) != content_digest((arr,))
    assert content_digest({"a": arr, "b": arr}) == content_digest(
        {"b": arr.copy(), "a": arr.copy()})
    assert content_digest({"a": arr}) != jdigest.content_digest({"a": arr})


# -- the Zipf replay through both caches ------------------------------------

def _zipf_replay(mod, seed, max_entries, waves=40, universe=24):
    """Waves of 1-4 lookups (identical keys in a wave coalesce), each wave's
    leaders settled in order; returns the counters."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    c = mod.InferenceCache(max_entries=max_entries, max_bytes=1 << 20)
    for _ in range(waves):
        keys = rng.choice(universe, size=int(rng.integers(1, 5)), p=p)
        pending = []
        for k in keys:
            kind, res = c.lookup(("ns", int(k)))
            if kind == "leader":
                pending.append((res, np.full(16, k, np.float32)))
            elif kind == "follower":
                pending.append((None, res))
        for flight, value in pending:
            if flight is not None:
                c.settle(flight, value)
        for flight, fut in pending:
            if flight is None:
                assert fut.done()
    out = dict(c.metrics.snapshot_raw()["counters"])
    out["entries"] = len(c)
    out["bytes"] = c.total_bytes
    return out


@pytest.mark.parametrize("seed, max_entries", [(0, 64), (1, 6), (2, 3)])
def test_zipf_replay_counters_are_jax(seed, max_entries):
    want = _zipf_replay(jcache, seed, max_entries)
    got = _zipf_replay(cache_mod, seed, max_entries)
    assert got == want
    assert got["cache.hits"] > 0 and got["cache.coalesced"] > 0
    if max_entries < 24:
        assert got["cache.evictions"] > 0


# -- cache core --------------------------------------------------------------

def test_hit_returns_independent_copy():
    c = InferenceCache(max_entries=4, max_bytes=1 << 20)
    val = np.arange(8, dtype=np.float32)
    c.put(("ns", "d1"), val)
    got = c.get(("ns", "d1"))
    got[0] = 99.0
    np.testing.assert_array_equal(c.get(("ns", "d1")), val)


def test_bytes_cap_evicts_in_lru_order():
    row = np.zeros(256, dtype=np.float32)  # 1 KiB
    c = InferenceCache(max_entries=100, max_bytes=int(2.5 * row.nbytes))
    c.put(("a",), row)
    c.put(("b",), row + 1)
    c.put(("c",), row + 2)  # evicts a
    assert c.get(("a",)) is None
    assert c.get(("b",)) is not None  # b becomes most recent
    c.put(("d",), row + 3)  # evicts c, not b
    assert c.get(("c",)) is None and c.get(("b",)) is not None
    assert c.metrics.snapshot_raw()["counters"]["cache.evictions"] == 2.0
    c.put(("big",), np.zeros(4096, np.float32))  # over budget: not stored
    assert c.get(("big",)) is None


def test_adopt_collision_keeps_byte_ledger_consistent():
    c = InferenceCache()
    row = np.zeros(64, np.float32)
    c.put(("old", "k1"), row)
    c.put(("old", "k2"), row)
    c.put(("new", "k1"), row + 1)
    before = c.total_bytes
    assert c.adopt(("old",), ("new",)) == 1
    assert len(c) == 2 and c.total_bytes == before - row.nbytes
    np.testing.assert_array_equal(c.get(("new", "k1")), row + 1)


# -- through the Server ------------------------------------------------------

class Tanh(torch.nn.Module):
    def __init__(self, seed=0, dim=8, out=4):
        super().__init__()
        w = np.random.default_rng(seed).normal(size=(dim, out))
        self.register_buffer("w", torch.from_numpy(w.astype(np.float32)))


def _fn(m, x):
    return torch.tanh((x[..., :, None] * m.w).sum(-2))


def _server(cache, module=None, **kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_wait_ms", 1.0)
    return Server(_fn, module if module is not None else Tanh(),
                  cache=cache, **kw)


def _wrap_slow(srv, sleep_s=0.0):
    """Count (and optionally slow) every bucket engine's dispatches."""
    calls = [0]
    for b in srv.bucket_sizes:
        eng = srv._engine_for(b)
        real = eng.run_padded

        def slow(batch, _real=real):
            calls[0] += 1
            if sleep_s:
                time.sleep(sleep_s)
            return _real(batch)

        eng.run_padded = slow
    return calls


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def test_zero_capacity_disables_cleanly():
    for kw in ({"max_entries": 0}, {"max_bytes": 0}):
        c = InferenceCache(**kw)
        c.put(("k",), np.ones(4))
        assert len(c) == 0 and c.get(("k",)) is None
        with _server(c) as srv:
            x = np.ones(8, np.float32)
            np.testing.assert_array_equal(srv.predict(x), srv.predict(x))
        assert len(c) == 0


def test_namespace_isolation_between_servers():
    cache = InferenceCache()
    x = np.ones(8, np.float32)
    with _server(cache, Tanh(1)) as s1, _server(cache, Tanh(2)) as s2:
        y1, y2 = s1.predict(x), s2.predict(x)
        assert not np.array_equal(y1, y2)
        assert s1.cache_namespace != s2.cache_namespace
        np.testing.assert_array_equal(s1.predict(x), y1)
        np.testing.assert_array_equal(s2.predict(x), y2)
    counters = cache.metrics.snapshot_raw()["counters"]
    assert counters["cache.hits"] == counters["cache.misses"] == 2.0


def test_close_reclaims_owned_anon_namespace():
    cache = InferenceCache()
    x = np.ones(8, np.float32)
    srv = _server(cache)
    srv.predict(x)
    assert len(cache) == 1
    srv.close()
    assert len(cache) == 0 and cache.total_bytes == 0
    srv2 = _server(cache, cache_namespace=("shared", "ns"))
    srv2.predict(x)
    srv2.close()
    assert len(cache) == 1  # an explicit namespace is not the server's


def test_coalescing_n_concurrent_identical_one_dispatch():
    cache = InferenceCache()
    with _server(cache, max_wait_ms=5.0, max_queue=64) as srv:
        x = np.ones(8, np.float32)
        srv.warmup(x)
        calls = _wrap_slow(srv, sleep_s=0.15)
        futs = [srv.submit(x) for _ in range(6)]
        outs = [f.result(timeout=30) for f in futs]
    assert calls[0] == 1
    assert all(np.array_equal(o, outs[0]) for o in outs)
    counters = cache.metrics.snapshot_raw()["counters"]
    assert counters["cache.misses"] == 1.0
    assert counters["cache.coalesced"] == 5.0
    outs[1][0] = 123.0  # follower rows are copies, not views of one
    assert not np.array_equal(outs[1], outs[2])


def test_leader_failure_settles_followers_and_caches_nothing():
    cache = InferenceCache()
    plan = faults.FaultPlan.parse(
        "cache.stampede:sleep:ms=150,times=1;"
        "serving.model:error:exc=fatal,times=1")
    with _server(cache, max_wait_ms=5.0) as srv:
        x = np.ones(8, np.float32)
        srv.warmup(x)
        with faults.active(plan):
            leader = [None]

            def lead():
                leader[0] = srv.submit(x)  # held ~150 ms at the stampede

            t = threading.Thread(target=lead)
            t.start()
            time.sleep(0.05)
            followers = [srv.submit(x) for _ in range(3)]
            t.join(timeout=30)
            assert not t.is_alive()
            for f in [leader[0]] + followers:
                with pytest.raises(faults.InjectedFatalError):
                    f.result(timeout=30)
        assert len(cache) == 0
        assert srv.predict(x).shape == (4,)  # not sticky
    counters = cache.metrics.snapshot_raw()["counters"]
    assert counters["cache.leader_failures"] == 1.0
    assert counters["cache.coalesced"] == 3.0


def test_leader_settles_before_caller_and_result_is_unaliased():
    cache = InferenceCache()
    with _server(cache) as srv:
        x = np.ones(8, np.float32)
        y = srv.submit(x).result(timeout=30)
        assert len(cache) == 1  # stored before the caller's future
        y[:] = -1.0
        y2 = srv.predict(x)
    assert not np.array_equal(y, y2)
    assert cache.metrics.snapshot_raw()["counters"]["cache.hits"] == 1.0


def test_follower_keeps_its_own_deadline():
    cache = InferenceCache()
    with _server(cache, max_wait_ms=5.0) as srv:
        x = np.ones(8, np.float32)
        srv.warmup(x)
        _wrap_slow(srv, sleep_s=0.2)
        leader = srv.submit(x)
        follower = srv.submit(x, timeout_ms=50)
        with pytest.raises(DeadlineExceededError):
            follower.result(timeout=30)
        assert leader.result(timeout=30).shape == (4,)


def test_injected_hit_corruption_caught_by_digest_recheck():
    cache = InferenceCache()
    with _server(cache) as srv:
        x = np.ones(8, np.float32)
        y1 = srv.predict(x)
        calls = _wrap_slow(srv)
        with faults.active(faults.FaultPlan.parse("cache.hit:error:times=1")):
            y2 = srv.predict(x)
        counters = cache.metrics.snapshot_raw()["counters"]
    np.testing.assert_array_equal(y1, y2)
    assert calls[0] == 1
    assert counters["cache.corruptions"] == counters[
        "cache.invalidations"] == 1.0


def test_zipfian_replay_speedup_hit_rate_and_oracle():
    res = zipfian_cache_benchmark(n_requests=48, universe=8,
                                  dispatch_ms=6.0, seed=0)
    assert res["bit_identical"]
    assert res["hit_rate"] >= res["analytic_hit_rate"]
    assert res["uncached_dispatches"] == res["n_requests"]
    assert res["cached_dispatches"] == res["distinct"]
    assert res["cache_entries"] == res["distinct"]
    assert res["speedup"] >= 1.5


def test_sparkdl_cache_grammar(monkeypatch):
    monkeypatch.delenv("SPARKDL_CACHE", raising=False)
    assert cache_from_env() is None
    for off in ("0", "off", "no", "false", ""):
        monkeypatch.setenv("SPARKDL_CACHE", off)
        assert cache_from_env() is None
    monkeypatch.setenv("SPARKDL_CACHE", "1")
    assert isinstance(cache_from_env(), InferenceCache)
    monkeypatch.setenv("SPARKDL_CACHE", "entries=8,mb=2")
    c, j = cache_from_env(), jcache.cache_from_env()
    assert (c.max_entries, c.max_bytes) == (j.max_entries, j.max_bytes) \
        == (8, 2 << 20)
    for bad in ("bogus", "entries=zap", "shards=2"):
        monkeypatch.setenv("SPARKDL_CACHE", bad)
        with pytest.raises(ValueError):
            cache_from_env()


def test_server_uncached_by_default(monkeypatch):
    monkeypatch.delenv("SPARKDL_CACHE", raising=False)
    cache_mod.configure_from_env()
    try:
        with _server(cache=None) as srv:
            assert srv.cache is None
            x = np.ones(8, np.float32)
            np.testing.assert_array_equal(srv.predict(x), srv.predict(x))
            assert srv.varz()["cache"] is None
    finally:
        cache_mod.configure_from_env()


def test_varz_carries_cache_section_json_serializable():
    cache = InferenceCache()
    with _server(cache) as srv:
        x = np.ones(8, np.float32)
        srv.predict(x)
        srv.predict(x)
        v = srv.varz()
    json.dumps(v)
    assert v["cache"]["entries"] == 1
    assert v["cache"]["counters"]["cache.hits"] == 1.0
    assert v["counters"]["serving.cache_hits"] == 1.0
    assert sorted(v["cache"]) == sorted(InferenceCache().info())
