"""The port's serving ``Server`` held against the JAX package's, on the CPU.

The same seeded requests in the same order go through the JAX ``Server``
(``fn(variables, batch)``) and the port's (``fn(module, batch)`` with the
same numpy weights): rows agree within 1e-6 on a dense model and within
the zoo tests' 1e-3 on a narrowed Xception, and on the port's own side a
served row is the engine's row at the same padded shape, bit for bit,
whatever the arrival order.  Then the contracts of the JAX package's
``tests/test_serving.py``: deadline shedding before dispatch, backpressure
with ``retry_after_s``, per-batch fault isolation (raising and stalling
models, retries), health transitions, drain versus hard close, client
cancellation, rows that own their memory, the transformer adapters and the
serving UDF.  Every port server runs under ``default_device("cpu")``;
sleeps stay at or under 0.2 s.
"""

import asyncio
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu.serving as jserving
import sparkdl_tpu.transformers.named_image as jax_ni
import sparkdl_tpu_torch
from sparkdl_tpu_torch.parallel import mesh as mesh_lib
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu import faults as jfaults
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.models import get_model_spec as port_spec
from sparkdl_tpu_torch.models.convert import state_dict_from_jax
from sparkdl_tpu_torch.models.xception import Xception
from sparkdl_tpu_torch.parallel.engine import InferenceEngine
from sparkdl_tpu_torch.serving import (DeadlineExceededError,
                                       DispatchTimeoutError,
                                       QueueFullError, Server,
                                       ServerClosedError,
                                       ServiceUnavailableError,
                                       from_transformer)

TOL = dict(rtol=1e-6, atol=1e-6)     # the dense model, JAX vs port
ZOO_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_torch_named_image.py's TOL
SIZE = 96                             # Xception narrowed as there


def _jfn(v, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ v["w"] + v["b"])


class Dense(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.array(w)))
        self.register_buffer("b", torch.from_numpy(np.array(b)))


def _pfn(m, x):
    # x @ w as a broadcast multiply and a reduction: each row's arithmetic
    # is then the same wherever the row sits in a batch (the CPU's GEMM
    # picks its micro-kernels by row position, so a matmul's rows can move
    # by an ulp with the batch's composition)
    return torch.tanh((x[..., :, None] * m.w).sum(-2) + m.b)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    variables = {
        "w": rng.normal(size=(12, 5)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float32),
    }
    x = rng.normal(size=(45, 12)).astype(np.float32)
    return variables, Dense(variables["w"], variables["b"]), x


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cond()


# -- held to the JAX server ------------------------------------------------

def test_server_matches_jax_server_in_any_arrival_order(setup):
    """The same requests in the same shuffled order through both servers
    agree within 1e-6; the port's rows equal its engine's at the bucket
    shape bit for bit, also when three threads interleave submissions."""
    variables, module, x = setup
    order = np.random.default_rng(3).permutation(len(x))
    kw = dict(max_batch_size=16, max_wait_ms=5, bucket_sizes=[16],
              max_queue=256, cache=False)
    with jserving.Server(_jfn, variables, **kw) as jsrv:
        want = {int(i): np.asarray(jsrv.submit(x[int(i)]).result(60))
                for i in order}
    ref = InferenceEngine(_pfn, module, device_batch_size=16)(x)
    got = [None] * len(x)
    with Server(_pfn, module, **kw) as srv:
        def client(idxs):
            futs = [(int(i), srv.submit(x[int(i)])) for i in idxs]
            for i, f in futs:
                got[i] = f.result(timeout=60)

        threads = [threading.Thread(target=client, args=(order[k::3],))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    got = np.stack(got)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, np.stack([want[i]
                                              for i in range(len(x))]),
                               **TOL)


def test_pytree_requests_and_results_match_jax(setup):
    """Pytree payloads stack per leaf and demux per row, integer leaves
    stay integers, and both servers agree."""
    variables, module, x = setup

    def jfn(v, xb):
        import jax.numpy as jnp

        y = jnp.tanh(xb["a"] @ v["w"] + v["b"])
        return {"y": y, "ids": jnp.argmax(y, axis=-1)}

    def pfn(m, xb):
        y = _pfn(m, xb["a"])
        return {"y": y, "ids": torch.argmax(y, dim=-1)}

    kw = dict(max_batch_size=8, max_wait_ms=5, bucket_sizes=[8],
              cache=False)
    with jserving.Server(jfn, variables, **kw) as jsrv:
        want = [jsrv.submit({"a": r}).result(60) for r in x]
    with Server(pfn, module, **kw) as srv:
        got = [srv.submit({"a": r}).result(60) for r in x]
    ref = InferenceEngine(pfn, module, device_batch_size=8)({"a": x})
    np.testing.assert_array_equal(np.stack([r["y"] for r in got]), ref["y"])
    np.testing.assert_allclose(np.stack([r["y"] for r in got]),
                               np.stack([np.asarray(r["y"]) for r in want]),
                               **TOL)
    ids = np.stack([r["ids"] for r in got])
    assert ids.dtype.kind in "iu"
    np.testing.assert_array_equal(
        ids, np.stack([np.asarray(r["ids"]) for r in want]))


def test_queue_full_retry_after_matches_jax(setup):
    """Nothing flushes (the batch never fills, the wait is 10 s), so the
    fifth request is rejected; both servers give the same hint, and a
    drain serves the four parked requests."""
    variables, module, x = setup
    kw = dict(max_batch_size=64, max_wait_ms=10_000, max_queue=4,
              bucket_sizes=[64], cache=False)
    hints = []
    for make, m in ((jserving.Server, variables), (Server, module)):
        fn = _jfn if make is jserving.Server else _pfn
        srv = make(fn, m, **kw)
        try:
            futs = [srv.submit(x[i]) for i in range(4)]
            exc = (jserving.QueueFullError if make is jserving.Server
                   else QueueFullError)
            with pytest.raises(exc) as ei:
                srv.submit(x[4])
            hints.append(ei.value.retry_after_s)
            assert srv.metrics.counters["serving.rejected_queue_full"] == 1
            srv.close(drain=True)
            rows = np.stack([np.asarray(f.result(timeout=60))
                             for f in futs])
        finally:
            srv.close()
    assert hints[0] == hints[1] > 0
    np.testing.assert_array_equal(
        rows, InferenceEngine(_pfn, module, device_batch_size=64)(x[:4]))


def test_health_transitions_match_jax(setup):
    """One injected model failure degrades both servers, the next served
    batch restores ready: the same states in the same order, and the
    failure survives as ``last_error``."""
    variables, module, x = setup
    spec = "serving.model:error:exc=transient,times=1"
    kw = dict(max_batch_size=4, max_wait_ms=5, bucket_sizes=[4],
              cache=False)
    seqs = []
    for make, m, fmod in ((jserving.Server, variables, jfaults),
                          (Server, module, pfaults)):
        fn = _jfn if make is jserving.Server else _pfn
        with make(fn, m, **kw) as srv:
            with fmod.active(fmod.FaultPlan.parse(spec)):
                futs = [srv.submit(x[i]) for i in range(4)]
                for f in futs:
                    with pytest.raises(fmod.InjectedTransientError):
                        f.result(timeout=60)
            assert srv.health()["state"] == "degraded"
            srv.predict(x[0])
            h = srv.health()
        assert h["state"] == "ready" and h["live"]
        assert h["last_error"]["type"] == "InjectedTransientError"
        seqs.append([t["state"] for t in h["transitions"]])
        assert sorted(h) == sorted(["live", "state", "last_error",
                                    "transitions", "breaker"])
    assert seqs[0] == seqs[1] == ["ready", "degraded", "ready"]


def test_varz_has_jax_keys_and_serializes(setup):
    variables, module, x = setup
    kw = dict(max_batch_size=8, max_wait_ms=5, bucket_sizes=[8],
              cache=False)
    with jserving.Server(_jfn, variables, **kw) as jsrv:
        jsrv.predict(x[0])
        jv = jsrv.varz()
    with Server(_pfn, module, **kw) as srv:
        srv.predict(x[0])
        v = srv.varz()
    json.dumps(v)
    assert sorted(v) == sorted(jv)
    assert sorted(v["server"]) == sorted(jv["server"])
    assert sorted(v["latency_ms"]) == sorted(jv["latency_ms"])
    assert sorted(v["metrics"]) == sorted(jv["metrics"])
    assert v["cost"] is None
    # the JAX server's mesh spans the tests' 8 CPU devices, the port's is
    # this process's one device: the param bytes agree
    assert sorted(v["sharding"]) == sorted(list(jv["sharding"])
                                           + ["donate_batch"])
    assert v["sharding"]["mesh_shape"] == {"data": 1, "model": 1}
    for k in ("param_bytes_total", "param_bytes_per_chip",
              "largest_replicated_leaf_bytes", "total_leaves", "sharded",
              "sharding_digest"):
        assert v["sharding"][k] == jv["sharding"][k], k
    assert v["counters"]["serving.completed"] == \
        jv["counters"]["serving.completed"] == 1.0
    assert v["metrics"]["histograms"]["serving.batch_fill_ratio"] == \
        jv["metrics"]["histograms"]["serving.batch_fill_ratio"]


# -- zoo Xception: served == engine == transform, and JAX's served rows ----

@pytest.fixture(scope="module")
def xc_variables():
    spec = jax_spec("Xception")
    module = spec.build()
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda r, a: module.init(r, a, train=False))(
            jax.random.PRNGKey(3), x))


@pytest.fixture
def zoo(monkeypatch, xc_variables):
    """Both zoos serve the same Xception weights at a 96x96 input."""
    narrow_jax = dataclasses.replace(jax_spec("Xception"),
                                     input_size=(SIZE, SIZE))
    narrow_port = dataclasses.replace(port_spec("Xception"),
                                      input_size=(SIZE, SIZE))
    monkeypatch.setattr(jax_ni, "get_model_spec", lambda name: narrow_jax)
    monkeypatch.setattr(port_ni, "get_model_spec", lambda name: narrow_port)
    monkeypatch.setattr(jax_ni, "_ENGINE_CACHE", {})
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    monkeypatch.setitem(jax_ni._MODEL_CACHE, ("Xception", ""),
                        (narrow_jax.build(), xc_variables))
    model = Xception()
    model.load_state_dict(state_dict_from_jax("Xception", xc_variables))
    monkeypatch.setitem(port_ni._MODEL_CACHE, ("Xception", ""),
                        model.eval())


def test_zoo_xception_served_matches_jax_engine_and_transform(zoo):
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    df = DataFrame(structsToArrow([imageArrayToStruct(im) for im in imgs]))
    # exactly the uint8 RGB batch the transform decodes
    batch, ok = arrowStructsToBatch(df.table.column("image"), SIZE, SIZE)
    assert ok.all()
    order = rng.permutation(len(batch))
    kw = dict(featurize=True, max_batch_size=8, bucket_sizes=[8],
              max_wait_ms=200, cache=False)
    with jserving.Server("Xception", **kw) as jsrv:
        futs = {int(i): jsrv.submit(batch[int(i)]) for i in order}
        want = np.stack([np.asarray(futs[i].result(60))
                         for i in range(len(batch))])
    with Server("Xception", **kw) as srv:
        futs = {int(i): srv.submit(batch[int(i)]) for i in order}
        got = np.stack([futs[i].result(60) for i in range(len(batch))])
        assert srv.metrics.counters["serving.batches"] == 1
    assert got.shape == (8, 2048) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ZOO_TOL)
    engine_rows = port_ni._zoo_engine("Xception", True, 8)(batch)
    np.testing.assert_array_equal(got, engine_rows)
    feat = port_ni.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                       modelName="Xception", batchSize=8)
    np.testing.assert_array_equal(
        got, feat.transform(df).column_to_numpy("f"))


def test_named_model_honors_zoo_compute_dtype(zoo, monkeypatch):
    """``Server("<zoo name>")`` follows ``SPARKDL_ZOO_COMPUTE_DTYPE`` as
    the zoo engine does (bf16 compute, f32 rows on the host)."""
    from sparkdl_tpu_torch.serving import server as server_mod

    monkeypatch.setenv("SPARKDL_ZOO_COMPUTE_DTYPE", "bfloat16")
    _, module, ov = server_mod._resolve_model("Xception", None, True)
    zoo_mesh = {"donate_batch": False,
                "partition_rules": mesh_lib.default_partition_rules}
    assert ov == {"compute_dtype": torch.bfloat16,
                  "output_host_dtype": np.float32, **zoo_mesh}
    assert module is port_ni._cached_model("Xception")
    monkeypatch.setenv("SPARKDL_ZOO_COMPUTE_DTYPE", "float32")
    assert server_mod._resolve_model("Xception", None, True)[2] == zoo_mesh
    monkeypatch.setenv("SPARKDL_ZOO_COMPUTE_DTYPE", "bogus")
    with pytest.raises(ValueError, match="not supported"):
        server_mod._resolve_model("Xception", None, True)


# -- buckets and engines -----------------------------------------------------

def test_light_batch_takes_smallest_bucket_and_fill_is_honest(setup):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=16, max_wait_ms=5,
                bucket_sizes=[8, 16], cache=False) as srv:
        for f in [srv.submit(x[i]) for i in range(3)]:
            f.result(timeout=60)
        _wait_for(lambda: srv.metrics.histograms.get(
            "serving.batch_fill_ratio"))
        assert srv.metrics.histograms["serving.batch_fill_ratio"][0] == \
            pytest.approx(3 / 8)
        assert list(srv._engines) == [8]
        assert srv.metrics.counters["engine.pad_rows"] == 5


def test_warmup_builds_every_bucket_as_siblings_of_one_engine(setup):
    """Every bucket's engine shares the first one's device module (one
    copy of the weights), fold caches and graph core (one pool); warmup
    builds and captures the largest bucket first."""
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=16, max_wait_ms=5,
                bucket_sizes=[4, 8, 16], cache=False) as srv:
        srv.warmup(x[0])
        engines = [srv._engines[b] for b in (4, 8, 16)]
        assert [e.device_batch_size for e in engines] == [4, 8, 16]
        assert all(e.module is engines[0].module for e in engines)
        assert all(e._core is engines[0]._core for e in engines)
        assert len({id(e.breaker) for e in engines}) == 3
        assert srv.device == torch.device("cpu")
        assert sorted(srv._warm) == [4, 8, 16]
        # the largest bucket first: the others reuse its pool blocks
        assert list(srv._engines) == [16, 8, 4]


def test_close_releases_the_buckets_graph_pool(setup):
    """``close()`` releases every bucket's graphs once nothing is in
    flight.  No card here, so a captured graph and its pool are stood in
    by their bookkeeping."""
    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held

    _, module, x = setup
    srv = Server(_pfn, module, max_batch_size=8, bucket_sizes=[4, 8],
                 cache=False)
    srv.warmup(x[0])
    eng = srv._engines[4]
    eng._core.graphs[("sig",)] = object()
    eng._core.pool_bytes = 4096
    assert srv.graph_pool_bytes == srv._engines[8].graph_pool_bytes == 4096
    held = graph_pool_bytes_held()
    srv.close()
    assert srv.graph_pool_bytes == 0 and eng._core.graphs == {}
    assert graph_pool_bytes_held() == held - 4096


# -- deadlines / backpressure --------------------------------------------------

def test_expired_deadlines_shed_before_dispatch(setup):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=30,
                bucket_sizes=[4], cache=False) as srv:
        doomed = [srv.submit(x[i], timeout_ms=0) for i in range(2)]
        live = [srv.submit(x[i]) for i in range(2)]  # 4th fills the batch
        for f in doomed:
            with pytest.raises(DeadlineExceededError):
                f.result(timeout=60)
        for f in live:
            f.result(timeout=60)
        s = srv.metrics.summary()
    assert s["serving.shed_deadline"] == 2
    assert s["serving.completed"] == 2
    assert s["serving.batches"] == 1
    assert s["engine.rows"] == 2  # shed requests never reached the engine


def test_timeout_tighter_than_wait_window_still_serves(setup):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=64, max_wait_ms=5_000,
                bucket_sizes=[64], default_timeout_ms=150,
                cache=False) as srv:
        srv.predict(x[0])  # would be shed at the 5 s flush
        assert srv.metrics.counters.get("serving.shed_deadline", 0) == 0


def test_queue_full_fault_site_rejects_like_a_full_queue(setup):
    """``serving.admit:error:exc=queue_full`` rejects at admission with
    the rule's ``retry_after`` (default 0.05 s), as the JAX server does."""
    variables, module, x = setup
    spec = "serving.admit:error:exc=queue_full,retry_after=0.25,times=1"
    hints = []
    for make, m, fmod, exc in (
            (jserving.Server, variables, jfaults, jserving.QueueFullError),
            (Server, module, pfaults, QueueFullError)):
        fn = _jfn if make is jserving.Server else _pfn
        with make(fn, m, max_batch_size=4, bucket_sizes=[4],
                  cache=False) as srv:
            with fmod.active(fmod.FaultPlan.parse(spec)):
                with pytest.raises(exc) as ei:
                    srv.submit(x[0])
                hints.append(ei.value.retry_after_s)
                srv.predict(x[1])  # the rule fired once: admitted now
    assert hints == [0.25, 0.25]


# -- fault isolation -----------------------------------------------------------

def test_bad_batch_fails_only_its_own_futures(setup):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=50,
                bucket_sizes=[4], ragged=False, cache=False) as srv:
        poison = np.zeros((13,), np.float32)  # the model takes 12 features
        bad = [srv.submit(poison) for _ in range(4)]  # full batch -> flush
        good = [srv.submit(x[i]) for i in range(4)]
        for f in bad:
            with pytest.raises(RuntimeError):
                f.result(timeout=60)
        for f in good:
            f.result(timeout=60)
        assert srv.metrics.counters["serving.batch_failures"] == 1
        assert srv.metrics.counters["serving.completed"] == 4


class _Wrap:
    """An engine stand-in: ``hook(batch)`` before the real engine call."""

    def __init__(self, eng, hook):
        self._eng, self._hook = eng, hook
        self.device_batch_size = eng.device_batch_size

    def __call__(self, batch):
        self._hook(batch)
        return self._eng(batch)


def test_transient_failure_retried_through_utils_retry(setup, monkeypatch):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=20,
                bucket_sizes=[4], max_retries=1, cache=False) as srv:
        calls = {"n": 0}

        def flaky(batch):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device hiccup")

        real = srv._engine_for
        monkeypatch.setattr(srv, "_engine_for",
                            lambda b: _Wrap(real(b), flaky))
        for f in [srv.submit(x[i]) for i in range(4)]:
            f.result(timeout=60)
        assert calls["n"] == 2  # first attempt + one retry
        assert srv.metrics.counters.get("serving.batch_failures", 0) == 0
        assert srv.health()["state"] == "ready"


def test_stalled_batch_times_out_and_later_batches_proceed(setup,
                                                           monkeypatch):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=2, max_wait_ms=20,
                bucket_sizes=[2], dispatch_timeout_ms=50,
                max_inflight_batches=1, cache=False) as srv:
        calls = {"n": 0}

        def stall(batch):
            if not np.asarray(batch).any():
                return  # the untimed first call of the bucket (zeros)
            calls["n"] += 1
            if calls["n"] == 1:
                time.sleep(0.2)  # well past the 50 ms watchdog

        real = srv._engine_for
        monkeypatch.setattr(srv, "_engine_for",
                            lambda b: _Wrap(real(b), stall))
        for f in [srv.submit(x[i]) for i in range(2)]:
            with pytest.raises(DispatchTimeoutError):
                f.result(timeout=60)
        for f in [srv.submit(x[i]) for i in range(2)]:
            f.result(timeout=60)
        assert srv.metrics.counters["serving.dispatch_timeouts"] == 1


def test_open_breaker_sheds_at_submit(setup):
    """An engine fault that opens the bucket's breaker makes admission
    shed with ``ServiceUnavailableError`` and ``retry_after_s``; health
    reports the open breaker."""
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=2, max_wait_ms=5,
                bucket_sizes=[2], breaker_threshold=1,
                breaker_cooldown_s=30, cache=False) as srv:
        srv.warmup(x[0])
        with pfaults.active(pfaults.FaultPlan.parse(
                "engine.dispatch:error:exc=transient,times=1")):
            with pytest.raises(pfaults.InjectedTransientError):
                srv.predict(x[0])
        with pytest.raises(ServiceUnavailableError) as ei:
            srv.submit(x[1])
        assert 0 < ei.value.retry_after_s <= 30
        h = srv.health()
        assert h["state"] == "degraded"
        assert h["breaker"][2]["state"] == "open"
        assert srv.metrics.counters["serving.rejected_breaker_open"] == 1


# -- lifecycle -----------------------------------------------------------------

def test_graceful_drain_serves_queue_then_rejects(setup):
    _, module, x = setup
    srv = Server(_pfn, module, max_batch_size=64, max_wait_ms=10_000,
                 bucket_sizes=[64], cache=False)
    futs = [srv.submit(x[i]) for i in range(5)]  # parked: never fills
    srv.close(drain=True)
    for f in futs:
        f.result(timeout=60)  # drained, not dropped
    with pytest.raises(ServerClosedError):
        srv.submit(x[0])
    assert srv.health()["state"] == "closed"


def test_hard_close_fails_queued_futures(setup):
    _, module, x = setup
    srv = Server(_pfn, module, max_batch_size=64, max_wait_ms=10_000,
                 bucket_sizes=[64], cache=False)
    futs = [srv.submit(x[i]) for i in range(3)]
    srv.close(drain=False)
    for f in futs:
        with pytest.raises(ServerClosedError):
            f.result(timeout=60)


def test_abandoned_close_settles_undispatched_futures(setup, monkeypatch):
    """A wedged model call with no watchdog: close() settles everything
    outside the wedged batch with ``ServerClosedError``; the wedged batch
    settles when its call returns."""
    _, module, x = setup
    srv = Server(_pfn, module, max_batch_size=2, max_wait_ms=5,
                 bucket_sizes=[2], max_inflight_batches=1, cache=False)
    try:
        calls = {"n": 0}
        entered = threading.Event()

        def wedge(batch):
            calls["n"] += 1
            if calls["n"] == 1:
                entered.set()
                time.sleep(0.2)  # wedged past close(timeout_s=0.05)

        real = srv._engine_for
        monkeypatch.setattr(srv, "_engine_for",
                            lambda b: _Wrap(real(b), wedge))
        wedged = [srv.submit(x[i]) for i in range(2)]
        assert entered.wait(5)
        parked = [srv.submit(x[i]) for i in range(2)]
        time.sleep(0.02)  # the dispatcher holds them, waiting for a slot
        srv.close(drain=True, timeout_s=0.05)
        for f in parked:
            with pytest.raises(ServerClosedError):
                f.result(timeout=10)
        for f in wedged:
            f.result(timeout=10)
    finally:
        srv.close()


def test_predict_and_predict_async(setup):
    _, module, x = setup
    ref = InferenceEngine(_pfn, module, device_batch_size=8)(x[:4])
    with Server(_pfn, module, max_batch_size=8, max_wait_ms=5,
                bucket_sizes=[8], cache=False) as srv:
        np.testing.assert_array_equal(srv.predict(x[0]), ref[0])

        async def handler():
            rows = await asyncio.gather(
                *[srv.predict_async(x[i]) for i in range(4)])
            return np.stack(rows)

        np.testing.assert_array_equal(asyncio.run(handler()), ref)


def test_client_cancel_never_kills_the_dispatcher(setup):
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=30,
                bucket_sizes=[4], cache=False) as srv:
        doomed = srv.submit(x[0], timeout_ms=0)
        assert doomed.cancel()  # pending future: cancel wins the race
        srv.submit(x[1]).result(timeout=60)
        srv.predict(x[2])  # the dispatcher survived


def test_result_rows_do_not_pin_batch_output(setup):
    """Each row owns its memory: not a view of the [bucket, ...] output
    (which a later dispatch may reuse)."""
    _, module, x = setup
    with Server(_pfn, module, max_batch_size=8, max_wait_ms=5,
                bucket_sizes=[8], cache=False) as srv:
        rows = [srv.submit(x[i]) for i in range(8)]
        rows = [f.result(timeout=60) for f in rows]
    assert all(r.base is None and r.flags.owndata for r in rows)


# -- adapters and the UDF --------------------------------------------------------

def test_from_transformer_model_transformer_parity(setup):
    from sparkdl_tpu.graph.function import ModelFunction as JMF
    from sparkdl_tpu.transformers.tensor import ModelTransformer as JMT
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.transformers.tensor import ModelTransformer

    variables, module, x = setup
    stage = ModelTransformer(inputCol="features", outputCol="out",
                             modelFunction=ModelFunction(fn=_pfn,
                                                         module=module),
                             batchSize=16)
    offline = stage.transform(DataFrame(
        {"features": [r for r in x]})).column_to_numpy("out")
    with from_transformer(stage, max_wait_ms=5, bucket_sizes=[16],
                          cache=False) as srv:
        assert srv.max_batch_size == 16  # the stage's batchSize
        online = np.stack([srv.predict(list(r)) for r in x])
    np.testing.assert_array_equal(online, offline)
    jstage = JMT(inputCol="features", outputCol="out",
                 modelFunction=JMF(fn=_jfn, variables=variables),
                 batchSize=16)
    with jserving.from_transformer(jstage, max_wait_ms=5,
                                   bucket_sizes=[16], cache=False) as jsrv:
        jonline = np.stack([np.asarray(jsrv.predict(list(r))) for r in x])
    np.testing.assert_allclose(online, jonline, **TOL)


def test_from_transformer_image_stage_accepts_structs_and_arrays():
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.schema import imageArrayToStruct
    from sparkdl_tpu_torch.transformers.named_image import \
        TFImageTransformer

    rng = np.random.default_rng(5)
    stage = TFImageTransformer(
        inputCol="image", outputCol="vec",
        modelFunction=ModelFunction.from_callable(
            lambda x: x.float().mean(dim=(1, 2))),
        inputSize=[8, 8], batchSize=8)
    rgb = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    with from_transformer(stage, max_wait_ms=5, cache=False) as srv:
        via_array = srv.predict(rgb)
        # structs hold BGR; the adapter hands the model RGB
        via_struct = srv.predict(imageArrayToStruct(
            np.ascontiguousarray(rgb[:, :, ::-1]), origin="r0"))
        big = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        resized = srv.predict(big)  # resized on the submitter's thread
        with pytest.raises(ValueError, match="RGB"):
            srv.predict(np.zeros((8, 8), np.uint8))
    np.testing.assert_array_equal(via_array, via_struct)
    assert resized.shape == via_array.shape == (3,)
    np.testing.assert_allclose(via_array, rgb.mean(axis=(0, 1)), atol=0.5)


def test_from_transformer_zoo_stage_serves_transform_rows(zoo):
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(9)
    structs = [imageArrayToStruct(im) for im in rng.integers(
        0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)]
    feat = port_ni.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                       modelName="Xception", batchSize=4)
    want = feat.transform(DataFrame(structsToArrow(structs))
                          ).column_to_numpy("f")
    with from_transformer(feat, max_wait_ms=200, cache=False) as srv:
        assert srv.bucket_sizes == [1, 2, 4]
        futs = [srv.submit(s) for s in structs]
        got = np.stack([f.result(timeout=60) for f in futs])
        assert srv.metrics.counters["serving.batches"] == 1
    np.testing.assert_array_equal(got, want)


def test_from_transformer_rejects_unknown_stage():
    from sparkdl_tpu_torch.transformers.base import Transformer

    with pytest.raises(TypeError, match="from_transformer"):
        from_transformer(Transformer())


def test_register_serving_udf_matches_jax_and_keeps_nulls(setup):
    from sparkdl_tpu.frame import DataFrame as JFrame
    from sparkdl_tpu.udf.registry import UDFRegistry as JReg
    from sparkdl_tpu.udf.registry import register_serving_udf as jregister
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.udf import UDFRegistry, register_serving_udf

    variables, module, x = setup
    rows = [list(r) for r in x[:9]] + [None]
    kw = dict(max_batch_size=8, max_wait_ms=5, bucket_sizes=[8],
              cache=False,
              host_preprocess=lambda v: np.asarray(v, np.float32))
    reg, jreg = UDFRegistry(), JReg()
    with Server(_pfn, module, **kw) as srv:
        register_serving_udf("srv", srv, registry=reg)
        got = reg.apply("srv", DataFrame({"f": rows}), "f",
                        "s").table.column("s").to_pylist()
    with jserving.Server(_jfn, variables, **kw) as jsrv:
        jregister("srv", jsrv, registry=jreg)
        want = jreg.apply("srv", JFrame({"f": rows}), "f",
                          "s").table.column("s").to_pylist()
    assert got[-1] is None and want[-1] is None
    np.testing.assert_array_equal(
        np.asarray(got[:9], np.float32),
        InferenceEngine(_pfn, module, device_batch_size=8)(x[:9]))
    np.testing.assert_allclose(np.asarray(got[:9]), np.asarray(want[:9]),
                               **TOL)


def test_register_serving_udf_retries_under_backpressure(setup):
    """A queue of 2 rejects most of a 24-row column at first; the UDF
    sleeps each ``retry_after_s`` and resubmits, and every row serves."""
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.udf import UDFRegistry, register_serving_udf

    _, module, x = setup
    reg = UDFRegistry()
    with Server(_pfn, module, max_batch_size=2, max_wait_ms=2,
                bucket_sizes=[2], max_queue=2, cache=False,
                host_preprocess=lambda v: np.asarray(v, np.float32)) as srv:
        register_serving_udf("bp", srv, registry=reg)
        out = reg.apply("bp", DataFrame({"f": [list(r) for r in x[:24]]}),
                        "f", "s").table.column("s").to_pylist()
        rejected = srv.metrics.counters.get("serving.rejected_queue_full", 0)
    assert rejected > 0
    np.testing.assert_array_equal(
        np.asarray(out, np.float32),
        InferenceEngine(_pfn, module, device_batch_size=2)(x[:24]))


def test_register_serving_udf_overrides_online_deadline(setup):
    """Bulk offline rows do not inherit the online ``default_timeout_ms``:
    the queue's tail would be shed and fail the whole apply."""
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.udf import UDFRegistry, register_serving_udf

    _, module, x = setup
    reg = UDFRegistry()
    with Server(_pfn, module, max_batch_size=8, max_wait_ms=5,
                bucket_sizes=[8], default_timeout_ms=1, cache=False) as srv:
        register_serving_udf("bulk", srv, registry=reg)
        out = reg.apply("bulk", DataFrame({"f": [list(r) for r in x]}),
                        "f", "s").table.column("s").to_pylist()
    assert all(r is not None for r in out)
    assert srv.metrics.counters.get("serving.shed_deadline", 0) == 0


# -- construction ------------------------------------------------------------------

def test_server_rejects_bad_buckets(setup):
    _, module, _ = setup
    with pytest.raises(ValueError, match="cover"):
        Server(_pfn, module, max_batch_size=16, bucket_sizes=[4, 8])
    with pytest.raises(ValueError, match="positive"):
        Server(_pfn, module, bucket_sizes=[0])


def test_server_rejects_unknown_model_form():
    with pytest.raises(TypeError, match="Cannot serve"):
        Server(12345)


# The mesh's arguments work on the port's one-device mesh: each serves the
# plain server's rows bit for bit and ``sharding_info()`` reads the policy
# (all-replicated on one card); a mesh that is not this process's one
# device raises the documented deviation.  ``slos=`` and ``cost=`` are
# tested in tests/test_torch_obs.py; a malformed value of either is
# refused as the JAX server refuses it.
@pytest.mark.parametrize("kwargs, item", [
    pytest.param(dict(mesh="get_mesh"), dict(sharded=False),
                 id="kwargs2-mesh"),
    pytest.param(dict(partition_rules=[(r".*", mesh_lib.P())]),
                 dict(sharded=False), id="kwargs3-partition_rules"),
    pytest.param(dict(param_shardings={"b": mesh_lib.P(None),
                                       "w": mesh_lib.P(None, "model")}),
                 dict(sharded=True), id="kwargs4-param_shardings"),
    pytest.param(dict(donate_batch=True), dict(donate_batch=True),
                 id="kwargs5-donate_batch"),
])
def test_arguments_of_unported_modules_raise(setup, kwargs, item):
    """The name is the one these cases had while the mesh was not
    ported; they now hold each knob to the plain server."""
    _, module, x = setup
    if kwargs.get("mesh") == "get_mesh":
        kwargs = dict(mesh=mesh_lib.get_mesh())
    kw = dict(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
              cache=False)
    with Server(_pfn, module, **kw) as plain:
        want = np.stack([plain.predict(r) for r in x[:5]])
    with Server(_pfn, module, **kw, **kwargs) as srv:
        got = np.stack([srv.predict(r) for r in x[:5]])
        info = srv.varz()["sharding"]
    np.testing.assert_array_equal(got, want)
    assert info["mesh_shape"] == {"data": 1, "model": 1}
    assert info["param_bytes_total"] == info["param_bytes_per_chip"] == 260
    assert info["sharded_leaves"] == 0
    for k, v in item.items():
        assert info[k] == v
    if not info["sharded"]:
        assert info["sharding_digest"] == "replicated"
    # a mesh of two devices in one process is the documented deviation
    with pytest.raises(NotImplementedError, match="one card per process"):
        Server(_pfn, module, mesh=mesh_lib.get_mesh(devices=["cpu", "cpu"]))


@pytest.mark.parametrize("kwargs, match", [
    (dict(slos=["p99"]), "SLO instances"),
    (dict(cost=object()), "CostLedger"),
])
def test_malformed_slos_and_cost_refused_like_jax(setup, kwargs, match):
    variables, module, _ = setup
    with pytest.raises(TypeError, match=match):
        jserving.Server(_jfn, variables, cache=False, **kwargs)
    with pytest.raises(TypeError, match=match):
        Server(_pfn, module, cache=False, **kwargs)


# -- the hooks the fleet reads ----------------------------------------------

def test_fleet_hooks_match_jax_at_the_same_queue_states(setup):
    """``max_queue``, ``queue_pressure()`` and ``breaker_retry_after()``
    read the same on both servers at every queue depth from empty to full
    (nothing flushes: the batch never fills and the wait is 10 s); a drain
    then empties both queues."""
    variables, module, x = setup
    kw = dict(max_batch_size=64, max_wait_ms=10_000, max_queue=8,
              bucket_sizes=[64], cache=False)
    readings = []
    for make, fn, m in ((jserving.Server, _jfn, variables),
                        (Server, _pfn, module)):
        srv = make(fn, m, **kw)
        try:
            seen = [(srv.max_queue, srv.queue_pressure(),
                     srv.breaker_retry_after())]
            for i in range(8):
                srv.submit(x[i])
                seen.append((srv.max_queue, srv.queue_pressure(),
                             srv.breaker_retry_after()))
            srv.close(drain=True)
            seen.append((srv.max_queue, srv.queue_pressure(),
                         srv.breaker_retry_after()))
        finally:
            srv.close()
        readings.append(seen)
    assert readings[0] == readings[1]
    assert [p for _, p, _ in readings[1]] == [i / 8 for i in range(9)] + [0.0]


def test_breaker_retry_after_matches_jax_while_open(setup):
    """One injected dispatch failure opens a threshold-1 breaker on both
    servers: ``breaker_retry_after()`` is the remaining cool-down (the
    private query's value), and None again on a fresh server."""
    variables, module, x = setup
    kw = dict(max_batch_size=2, max_wait_ms=5, bucket_sizes=[2],
              breaker_threshold=1, breaker_cooldown_s=30, cache=False)
    for make, fn, m, fmod in ((jserving.Server, _jfn, variables, jfaults),
                              (Server, _pfn, module, pfaults)):
        with make(fn, m, **kw) as srv:
            srv.warmup(x[0])
            assert srv.breaker_retry_after() is None
            with fmod.active(fmod.FaultPlan.parse(
                    "engine.dispatch:error:exc=transient,times=1")):
                with pytest.raises(fmod.InjectedTransientError):
                    srv.predict(x[0])
            r = srv.breaker_retry_after()
            assert 25 < r <= 30
            assert abs(srv._breaker_retry_after() - r) < 1.0


def test_wake_flushes_a_wait_window_on_an_injected_clock(setup):
    """A lone request under a virtual clock waits out its 10 s window on
    the real clock in both servers; moving the clock past it and calling
    ``wake()`` flushes it at once (``DynamicBatcher.wake``)."""
    variables, module, x = setup
    rows = []
    for make, fn, m in ((jserving.Server, _jfn, variables),
                        (Server, _pfn, module)):
        now = [10.0]
        with make(fn, m, max_batch_size=8, max_wait_ms=10_000,
                  bucket_sizes=[8], cache=False,
                  clock=lambda: now[0]) as srv:
            f = srv.submit(x[0])
            time.sleep(0.1)
            assert not f.done()
            now[0] += 11.0
            srv.wake()
            rows.append(np.asarray(f.result(timeout=2)))
    np.testing.assert_allclose(rows[1], rows[0], **TOL)


def test_head_fanout_server_delegates_the_fleet_hooks():
    """``HeadFanoutServer``'s ``queue_depth``, ``queue_pressure``,
    ``breaker_retry_after`` and ``wake`` are its backbone's."""
    from sparkdl_tpu_torch.parallel.engine import (head_fanout_backbone_fn,
                                                   head_fanout_module)
    from sparkdl_tpu_torch.serving import HeadFanoutServer

    rng = np.random.default_rng(0)
    module = head_fanout_module(
        {"backbone": rng.normal(size=(12, 16)).astype(np.float32)})
    srv = HeadFanoutServer(head_fanout_backbone_fn, module,
                           max_batch_size=64, max_wait_ms=10_000,
                           max_queue=4, bucket_sizes=[64], cache=False)
    try:
        srv.add_head("a", {"kernel": np.ones((16, 3), np.float32),
                           "bias": np.zeros(3, np.float32)})
        fut = srv.submit(rng.normal(size=(12,)).astype(np.float32), "a")
        assert srv.queue_depth() == srv.backbone.queue_depth() == 1
        assert srv.queue_pressure() == srv.backbone.queue_pressure() == 0.25
        assert srv.breaker_retry_after() is None
        srv.wake()
        assert not fut.done()
    finally:
        srv.close(drain=True)
    assert fut.result(timeout=10).shape == (3,)
