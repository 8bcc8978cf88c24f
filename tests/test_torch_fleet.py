"""The port's serving fleet (``Fleet``, ``ModelRegistry``, ``Rollout``,
``AdmissionController``) held against the JAX package's, on the CPU.

Held to JAX on the same seeded numpy inputs and weights: a dense model
(written as a broadcast multiply and a sum, as in
``tests/test_torch_serving.py``) through both fleets within 1e-6, and bit
for bit against the port's own per-version engine; a 96x96 zoo Xception,
v1 and a perturbed v2 (weights through ``state_dict_from_jax``), within
the zoo tests' 1e-3, with v2's rows apart from v1's (a version module that
kept v1's fold cache would serve v1's rows); the admission controller's
admit / shed sequence on one injected clock, decision by decision; the
rollout, shed and health events and payloads.  Then the contracts of the
JAX package's ``tests/test_fleet.py`` on the port's side (registry
monotonicity and the pinned fn, zero-downtime promote and the port's
``no_recompile``, canary fractions 0 and 1, rollback completing in-flight
requests, the first capture of a new bucket allowed, refunds, quotas, the
in-flight cap, priority shedding, a failed deploy leaving no thread, varz
JSON, the chaos rollout under mixed-tenant load with ``fleet.swap`` /
``fleet.canary`` / ``fleet.admit`` faults) and the fleet cases of its
``test_flight.py``, ``test_cache.py``, ``test_ragged.py`` and
``test_headfanout.py``.  Every port object runs under
``default_device("cpu")``; sleeps stay at or under 0.2 s.
"""

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
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.serving import errors as jerrors
from sparkdl_tpu.serving.fleet import admission as jadmission
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.models import get_model_spec as port_spec
from sparkdl_tpu_torch.models.convert import state_dict_from_jax
from sparkdl_tpu_torch.models.xception import Xception
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs.flight import FlightRecorder
from sparkdl_tpu_torch.parallel.engine import (InferenceEngine,
                                               head_fanout_backbone_fn,
                                               head_fanout_module,
                                               head_fanout_oracle_fn)
from sparkdl_tpu_torch.serving import errors as perrors
from sparkdl_tpu_torch.serving import (Fleet, InferenceCache,
                                       QueueFullError, QuotaExceededError,
                                       Server, ServiceUnavailableError,
                                       TenantQuota)
from sparkdl_tpu_torch.serving.fleet import (PRIORITY_HIGH, PRIORITY_LOW,
                                             AdmissionController,
                                             ModelRegistry)
from sparkdl_tpu_torch.serving.fleet import admission as padmission
from sparkdl_tpu_torch.serving.fleet.rollout import Rollout

TOL = dict(rtol=1e-6, atol=1e-6)     # the dense model, JAX vs port
ZOO_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_torch_serving.py's
SIZE = 96                             # Xception narrowed as there


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No fault plan leaks between tests, and both packages' recorders
    come back as they were."""
    for mod in (pflight, jflight):
        monkeypatch.setattr(mod, "_recorder", mod._recorder)
    pfaults.clear()
    jfaults.clear()
    yield
    pfaults.clear()
    jfaults.clear()


def _jfn(v, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ v["w"])


def _jfn2(v, x):
    import jax.numpy as jnp

    return jnp.sin(x @ v["w"] + v["b"])


class Dense(torch.nn.Module):
    def __init__(self, w, b=None):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.array(w)))
        if b is not None:
            self.register_buffer("b", torch.from_numpy(np.array(b)))


def _pfn(m, x):
    # x @ w as a broadcast multiply and a reduction: a row's arithmetic is
    # then the same wherever it sits in a batch
    return torch.tanh((x[..., :, None] * m.w).sum(-2))


def _pfn2(m, x):
    return torch.sin((x[..., :, None] * m.w).sum(-2) + m.b)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    w1 = {"w": rng.normal(size=(6, 4)).astype(np.float32)}
    w2 = {"w": rng.normal(size=(6, 4)).astype(np.float32)}
    wb = {"w": rng.normal(size=(6, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    x = rng.normal(size=(48, 6)).astype(np.float32)
    return w1, w2, wb, x


def _sd(v):
    """A version's weights as the port takes them: a state_dict."""
    return {k: torch.from_numpy(np.array(a)) for k, a in v.items()}


def _oracle(fn, module, x):
    """The port's per-version oracle: a bare engine at the bucket shape."""
    return InferenceEngine(fn, module, device_batch_size=8)(x)


def _no_serving_threads(timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("sparkdl-serving")]
        if not left:
            return
        time.sleep(0.02)
    raise AssertionError(f"wedged serving threads: {left}")


# -- the registry ------------------------------------------------------------

def test_registry_versions_monotonic_and_fn_pinned(setup):
    w1, w2, _, x = setup
    reg = ModelRegistry()
    m1 = Dense(w1["w"])
    sd2 = _sd(w2)
    v1 = reg.register("clf", _pfn, m1)
    v2 = reg.register("clf", variables=sd2)
    v3 = reg.register("clf")  # the entry's resolved weights
    assert [v1.version, v2.version, v3.version] == [1, 2, 3]
    assert reg.versions("clf") == [1, 2, 3]
    assert reg.get("clf").version == 3          # latest
    assert reg.get("clf", 2).variables is sd2
    assert v3.variables is v1.variables         # the entry default
    # ONE fn object and the v1 module, pinned on the entry
    entry = reg.entry("clf")
    assert entry.fn is _pfn and entry.module is m1
    assert entry.version_module(v1) is m1
    mod2 = entry.version_module(v2)
    assert mod2 is not m1
    np.testing.assert_array_equal(mod2.w.numpy(), w2["w"])
    np.testing.assert_array_equal(m1.w.numpy(), w1["w"])  # never written
    reg.register("clf", variables=Dense(w2["w"]).state_dict())
    assert reg.versions("clf") == [1, 2, 3, 4]
    with pytest.raises(TypeError, match="state_dict"):
        reg.register("clf", variables=Dense(w2["w"]))  # weights only
    with pytest.raises(ValueError, match="WEIGHTS only"):
        reg.register("clf", _pfn2)
    with pytest.raises(ValueError, match="first register"):
        reg.register("brand-new")
    with pytest.raises(KeyError, match="no version 9"):
        reg.get("clf", 9)
    with pytest.raises(KeyError, match="unknown model entry"):
        reg.entry("nope")
    reg.discard("clf", 9)  # no such version: nothing happens
    assert reg.versions("clf") == [1, 2, 3, 4]
    assert json.loads(json.dumps(reg.as_dict()))["clf"]["versions"] == [
        1, 2, 3, 4]


def test_version_module_clears_the_copied_fold_caches():
    """A later version's module is a deep copy of v1's with every
    ``_folds`` cache emptied: the copy folds its own weights afresh, and
    v1's cache (and module) stay as they were."""
    from sparkdl_tpu_torch.models.layers import cached_fold

    class Folding(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("w", torch.ones(3))
            self._folds = {}

        def folded(self):
            return cached_fold(self._folds, "w2", [self.w],
                               lambda: self.w * 2)

    reg = ModelRegistry()
    reg.register("f", lambda m, x: x * m.folded(), Folding())
    entry = reg.entry("f")
    entry.module.folded()
    assert list(entry.module._folds) == ["w2"]
    v2 = reg.register("f", variables={"w": torch.full((3,), 5.0)})
    m2 = entry.version_module(v2)
    assert m2._folds == {}
    np.testing.assert_array_equal(m2.folded().numpy(), [10.0] * 3)
    np.testing.assert_array_equal(entry.module.folded().numpy(), [2.0] * 3)


# -- the front door, held to JAX's -------------------------------------------

def test_fleet_matches_jax_fleet_and_per_version_engines(setup):
    """Two entries through both fleets: rows within 1e-6 of JAX's, and bit
    for bit the port's per-model engine rows; futures carry the tags."""
    w1, _, wb, x = setup
    kw = dict(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8])
    with jserving.Fleet(**kw) as jf:
        jf.add_model("a", _jfn, w1)
        jf.add_model("b", _jfn2, wb)
        want_a = np.stack([np.asarray(jf.predict("a", x[i], tenant="t1"))
                           for i in range(8)])
        want_b = np.stack([np.asarray(jf.predict("b", x[i], tenant="t2"))
                           for i in range(8)])
    ma, mb = Dense(w1["w"]), Dense(wb["w"], wb["b"])
    with Fleet(**kw) as fleet:
        fleet.add_model("a", _pfn, ma)
        fleet.add_model("b", _pfn2, mb)
        futs_a = [fleet.submit("a", x[i], tenant="t1") for i in range(8)]
        futs_b = [fleet.submit("b", x[i], tenant="t2") for i in range(8)]
        got_a = np.stack([f.result(timeout=60) for f in futs_a])
        got_b = np.stack([f.result(timeout=60) for f in futs_b])
        assert all(f.fleet_model == "a" and f.fleet_version == 1
                   and f.fleet_tenant == "t1" and not f.fleet_canary
                   for f in futs_a)
        with pytest.raises(KeyError, match="not deployed"):
            fleet.submit("nope", x[0])
        with pytest.raises(ValueError, match="already deployed"):
            fleet.add_model("a", _pfn, ma)
        assert fleet.models() == ["a", "b"]
    np.testing.assert_array_equal(got_a, _oracle(_pfn, ma, x[:8]))
    np.testing.assert_array_equal(got_b, _oracle(_pfn2, mb, x[:8]))
    np.testing.assert_allclose(got_a, want_a, **TOL)
    np.testing.assert_allclose(got_b, want_b, **TOL)
    _no_serving_threads()


def test_hot_swap_zero_downtime_and_no_recompile(setup):
    w1, w2, _, x = setup
    m1, m2 = Dense(w1["w"]), Dense(w2["w"])
    ref_v1, ref_v2 = _oracle(_pfn, m1, x), _oracle(_pfn, m2, x)
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8]) as fleet:
        fleet.add_model("m", _pfn, m1, warm_example=x[0])
        for i in range(4):  # stable traffic
            np.testing.assert_array_equal(fleet.predict("m", x[i]),
                                          ref_v1[i])
        fleet.add_version("m", _sd(w2), label="retrained")
        ro = fleet.start_rollout("m", canary_fraction=0.5,
                                 warm_example=x[0])
        assert ro.canary_server is not ro.stable_server
        futs = [fleet.submit("m", x[i]) for i in range(8)]
        rows = [f.result(timeout=60) for f in futs]
        # deterministic fraction: every 2nd request rode the canary
        assert [f.fleet_canary for f in futs] == [False, True] * 4
        for f, row, i in zip(futs, rows, range(8)):
            np.testing.assert_array_equal(
                row, ref_v2[i] if f.fleet_version == 2 else ref_v1[i])
        report = fleet.promote("m")
        assert report["phase"] == "promoted"
        assert report["no_recompile"] is True
        assert all(b["shared_jit"] and not b["recaptured"]
                   for b in report["buckets"].values())
        assert fleet.deployed_version("m") == 2
        assert fleet.swap_report("m") == report
        assert ro.stable_server.closed  # drained
        f = fleet.submit("m", x[9])
        np.testing.assert_array_equal(f.result(timeout=60), ref_v2[9])
        assert f.fleet_version == 2 and not f.fleet_canary
        with pytest.raises(RuntimeError, match="no rollout"):
            fleet.promote("m")
        assert ro.phase == "promoted"
    # the function the JAX fleet serves (tanh(x @ w)), within 1e-6
    np.testing.assert_allclose(ref_v1, np.tanh(x @ w1["w"]), **TOL)
    np.testing.assert_allclose(ref_v2, np.tanh(x @ w2["w"]), **TOL)
    _no_serving_threads()


def test_canary_fraction_zero_and_one(setup):
    w1, w2, _, x = setup
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8]) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        fleet.add_version("m", _sd(w2))
        with pytest.raises(ValueError, match="fraction"):
            fleet.start_rollout("m", canary_fraction=1.5)
        ro = fleet.start_rollout("m", canary_fraction=0.0)
        futs = [fleet.submit("m", x[i]) for i in range(6)]
        for f in futs:
            f.result(timeout=60)
        assert all(not f.fleet_canary for f in futs)
        assert ro.status()["canary_requests"] == 0
        ro.set_fraction(1.0)  # dark launch: everything rides the canary
        futs = [fleet.submit("m", x[i]) for i in range(6)]
        for f in futs:
            f.result(timeout=60)
        assert all(f.fleet_canary and f.fleet_version == 2 for f in futs)
        with pytest.raises(RuntimeError, match="already in progress"):
            fleet.start_rollout("m")
        fleet.rollback("m")
        assert fleet.deployed_version("m") == 1
        # a second rollout of the SAME registered version still works
        ro2 = fleet.start_rollout("m", canary_fraction=1.0)
        assert ro2.canary_version == 2
        fleet.promote("m")
        assert fleet.deployed_version("m") == 2
    _no_serving_threads()


def test_rollback_completes_inflight_on_canary_version(setup):
    w1, w2, _, x = setup
    m1, m2 = Dense(w1["w"]), Dense(w2["w"])
    ref_v1, ref_v2 = _oracle(_pfn, m1, x), _oracle(_pfn, m2, x)
    # a wait window much longer than the test: in-flight requests are
    # still QUEUED on the canary when rollback fires; its drain serves
    # them on the version that admitted them
    with Fleet(max_batch_size=8, max_wait_ms=2_000,
               bucket_sizes=[8]) as fleet:
        fleet.add_model("m", _pfn, m1)
        fleet.add_version("m", _sd(w2))
        fleet.start_rollout("m", canary_fraction=1.0, warm_example=x[0])
        inflight = [fleet.submit("m", x[i]) for i in range(4)]
        assert all(f.fleet_version == 2 for f in inflight)
        report = fleet.rollback("m")  # drains the canary server
        assert report["phase"] == "rolled_back"
        for i, f in enumerate(inflight):
            np.testing.assert_array_equal(f.result(timeout=60), ref_v2[i])
        f = fleet.submit("m", x[5])
        assert f.fleet_version == 1
        with pytest.raises(ValueError, match="already serving"):
            fleet.start_rollout("m", version=1)
    np.testing.assert_array_equal(f.result(timeout=60), ref_v1[5])
    _no_serving_threads()


def test_submit_reroutes_once_when_the_routed_server_closed(setup):
    """The swap window: a request routed to a server that closed under it
    is refunded (slot and token) and routed once more; a second closed
    server rejects it with ``ServerClosedError``, charged nothing."""
    from sparkdl_tpu_torch.serving import ServerClosedError

    w1, w2, _, x = setup
    m2 = Dense(w2["w"])
    with Fleet(max_batch_size=8, max_wait_ms=1, bucket_sizes=[8],
               quotas={"t": TenantQuota(rate_per_s=1e-6, burst=1)}
               ) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        fleet.add_version("m", _sd(w2))
        ro = fleet.start_rollout("m", canary_fraction=0.5)

        def closed(*a, **k):
            raise ServerClosedError("server is closed")

        ro.stable_server.submit = closed  # request 1 routes to stable
        f = fleet.submit("m", x[0], tenant="t")  # re-routed: the canary
        assert f.fleet_version == 2 and f.fleet_canary
        np.testing.assert_array_equal(f.result(timeout=60),
                                      _oracle(_pfn, m2, x[:1])[0])
        snap = fleet.admission.snapshot()["tenants"]["t"]
        assert snap["admitted"] == 1 and snap["tokens"] == 0.0
        ro.set_fraction(0.0)
        with pytest.raises(ServerClosedError):
            fleet.submit("m", x[1], tenant="other")
        assert fleet.admission.snapshot()["tenants"]["other"][
            "admitted"] == 0
        assert fleet.stats()["fleet.rejected"] == 1.0
        assert fleet.varz()["tenants"]["other"] == {"rejected": 1}
        del ro.stable_server.submit
    _no_serving_threads()


class _Srv:
    def __init__(self, state):
        self.state = state

    def program_state(self):
        return {b: dict(v) for b, v in self.state.items()}


def _prog(captures, fn_id=0xBEEF, sig=(((8, 6), "float32"),),
          precision=(False, False, "highest", True, True)):
    return {"fn_id": fn_id, "signature": [list(map(list, s)) for s in sig],
            "precision": list(precision), "captures": captures}


def test_swap_report_allows_first_capture_of_new_bucket():
    """A bucket captured for the first time mid-rollout (on either
    server) keeps ``no_recompile``; a bucket captured again does not; nor
    does another fn object, another input signature or other precision
    flags (``shared_jit`` False)."""
    stable = _Srv({8: _prog(1)})
    canary = _Srv({8: _prog(1)})
    ro = Rollout("m", 1, stable, 2, canary, 0.5,
                 exec_before=stable.program_state())
    canary.state[16] = _prog(1)
    stable.state[4] = _prog(1)
    rep = ro.report()
    assert rep["no_recompile"] is True
    assert rep["buckets"][8] == {"shared_jit": True, "executables_before": 1,
                                 "executables_now": 1, "recaptured": False}
    assert rep["buckets"][16]["shared_jit"] is False  # not compared
    canary.state[8] = _prog(2)  # a same-shape recapture on the canary
    assert ro.report()["no_recompile"] is False
    canary.state[8] = _prog(1)
    stable.state[8] = _prog(2)  # ... or on the stable server
    assert ro.report()["no_recompile"] is False
    stable.state[8] = _prog(1)
    stable.state[4] = _prog(2)  # a new bucket captured twice
    assert ro.report()["no_recompile"] is False
    stable.state[4] = _prog(1)
    assert ro.report()["no_recompile"] is True
    for change in (dict(fn_id=0xF00D), dict(sig=(((8, 7), "float32"),)),
                   dict(precision=(True, False, "highest", True, True))):
        canary.state[8] = _prog(1, **change)
        rep = ro.report()
        assert rep["buckets"][8]["shared_jit"] is False
        assert rep["no_recompile"] is False


# -- admission ---------------------------------------------------------------

def _decision(ac, err_types, tenant, pressure, breaker):
    try:
        q = ac.admit(tenant, pressure=pressure,
                     unavailable_retry_after=breaker)
    except err_types as e:
        return (type(e).__name__, str(e), round(e.retry_after_s, 9))
    return ("ok", q.priority)


def test_admission_sequence_equals_jax_on_an_injected_clock():
    """One seeded schedule of admits (pressure, an open breaker), settles
    and refunds on one virtual clock through both controllers: the same
    decision at every step (exception type, message, retry_after) and the
    same snapshot at the end."""
    def quotas(mod):
        return {"gold": mod.TenantQuota(priority=mod.PRIORITY_HIGH),
                "silver": mod.TenantQuota(rate_per_s=50.0, burst=3,
                                          max_inflight=4),
                "scraper": mod.TenantQuota(rate_per_s=10.0,
                                           priority=mod.PRIORITY_LOW),
                "capped": mod.TenantQuota(max_inflight=2),
                "banned": mod.TenantQuota(rate_per_s=0.0, burst=9)}

    rng = np.random.default_rng(5)
    tenants = ["gold", "silver", "scraper", "capped", "banned", "anon"]
    steps = []
    for _ in range(400):
        steps.append((float(rng.exponential(0.02)),
                      tenants[int(rng.integers(len(tenants)))],
                      str(rng.choice(["admit"] * 6 + ["release", "refund"])),
                      float(rng.choice([0.0, 0.3, 0.6, 0.9, 1.0])),
                      (float(rng.uniform(0.1, 2.0))
                       if rng.random() < 0.1 else None)))
    runs = []
    for mod, errors in ((jadmission, jerrors), (padmission, perrors)):
        now = [1000.0]
        ac = mod.AdmissionController(
            quotas=quotas(mod),
            default_quota=mod.TenantQuota(rate_per_s=20.0, burst=2),
            shed_pressure={mod.PRIORITY_NORMAL: 0.85},
            clock=lambda: now[0])
        err_types = (errors.QueueFullError, errors.ServiceUnavailableError)
        out = []
        for dt, tenant, op, pressure, breaker in steps:
            now[0] += dt
            if op == "admit":
                out.append(_decision(ac, err_types, tenant, pressure,
                                     breaker))
            elif op == "release":
                ac.release(tenant)
                out.append(("release", ac.inflight(tenant)))
            else:
                ac.refund(tenant)
                out.append(("refund", ac.inflight(tenant)))
        runs.append((out, ac.snapshot()))
    (jout, jsnap), (pout, psnap) = runs
    assert pout == jout
    assert psnap == jsnap
    kinds = {d[0] for d in pout}
    assert {"ok", "QuotaExceededError", "ServiceUnavailableError"} <= kinds


def test_admission_refund_returns_token_and_slot():
    ac = AdmissionController(
        quotas={"t": TenantQuota(rate_per_s=1e-6, burst=1, max_inflight=4)})
    ac.admit("t")
    with pytest.raises(QuotaExceededError):  # bucket empty, no refill
        ac.admit("t")
    ac.refund("t")
    ac.admit("t")  # the refunded token admits the retry
    snap = ac.snapshot()["tenants"]["t"]
    assert snap["admitted"] == 1  # the refunded admit was backed out
    assert snap["inflight"] == 1
    assert snap["shed"] == 1


def test_cap_rejection_costs_no_token_and_zero_quota_burst():
    ac = AdmissionController(
        quotas={"t": TenantQuota(rate_per_s=1e-6, burst=2, max_inflight=1)})
    ac.admit("t")  # one token spent, slot 1/1
    with pytest.raises(QuotaExceededError, match="in-flight cap"):
        ac.admit("t")
    ac.release("t")
    ac.admit("t")  # the cap rejection burned no token: one remained
    assert TenantQuota(rate_per_s=0.0, burst=100).effective_burst() == 0.0


def test_add_model_failure_leaves_no_thread_and_name_reusable(setup):
    w1, _, _, x = setup
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8]) as fleet:
        with pytest.raises(Exception):
            fleet.add_model("m", _pfn, Dense(w1["w"]),
                            warm_example=np.zeros((3, 3), np.float32))
        _no_serving_threads()
        assert "m" not in fleet.registry
        fleet.add_model("m", _pfn, Dense(w1["w"]), warm_example=x[0])
        fleet.predict("m", x[0])
    _no_serving_threads()


@pytest.mark.parametrize("kwargs, item", [
    (dict(mesh="get_mesh"), "mesh"),
    (dict(partition_rules=[("w", mesh_lib.P()), (".*", mesh_lib.P())]),
     "rules"),
])
def test_unported_server_knobs_raise_through_the_version_server(
        setup, kwargs, item):
    """(The name is the one these cases had while the mesh was not
    ported.)  The mesh and the partition knobs reach each version's
    Server, which serves on this process's one device with the policy
    collapsed to replicated; a mesh of two slots reaches the version server
    too and serves the one-device rows."""
    w1, _, _, x = setup
    if item == "mesh":
        kwargs = dict(mesh=mesh_lib.get_mesh())
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
               **kwargs) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]), warm_example=x[0])
        fleet.predict("m", x[0])
        info = fleet._state("m").server.sharding_info()
        assert info["mesh_shape"] == {"data": 1, "model": 1}
        assert info["sharding_digest"] == "replicated"
        assert not info["sharded"]
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8]) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]), warm_example=x[0])
        want = [fleet.predict("m", r) for r in x[:4]]
    # a mesh of two slots in one process reaches the version server and
    # serves the one-device rows bit for bit
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
               **dict(kwargs, mesh=mesh_lib.get_mesh(
                   devices=["cpu", "cpu"]))) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]), warm_example=x[0])
        got = [fleet.predict("m", r) for r in x[:4]]
        info = fleet._state("m").server.sharding_info()
        assert info["mesh_shape"] == {"data": 2, "model": 1}
        assert "m" in fleet.registry
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _no_serving_threads()


def test_zero_quota_tenant_always_shed(setup):
    w1, _, _, x = setup
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
               quotas={"banned": TenantQuota(rate_per_s=0.0)}) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        for _ in range(3):
            with pytest.raises(QuotaExceededError, match="zero quota") as ei:
                fleet.submit("m", x[0], tenant="banned")
            assert ei.value.retry_after_s > 0
            assert ei.value.tenant == "banned"
        fleet.predict("m", x[0], tenant="ok")  # other tenants untouched
        snap = fleet.admission.snapshot()
        assert snap["tenants"]["banned"]["shed"] == 3
        assert snap["tenants"]["banned"]["admitted"] == 0


def test_rate_quota_token_bucket(setup):
    w1, _, _, x = setup
    with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
               quotas={"m1": TenantQuota(rate_per_s=200.0, burst=2)}
               ) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        a = fleet.submit("m", x[0], tenant="m1")
        b = fleet.submit("m", x[1], tenant="m1")
        with pytest.raises(QuotaExceededError, match="rate quota") as ei:
            fleet.submit("m", x[2], tenant="m1")
        assert 0 < ei.value.retry_after_s <= 60.0
        a.result(timeout=60), b.result(timeout=60)
        time.sleep(0.1)  # 200/s refills a token in 5 ms
        fleet.submit("m", x[3], tenant="m1").result(timeout=60)


def test_inflight_cap_released_on_settle(setup):
    w1, _, _, x = setup
    fleet = Fleet(max_batch_size=64, max_wait_ms=10_000, bucket_sizes=[64],
                  quotas={"cap": TenantQuota(max_inflight=2)})
    try:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        futs = [fleet.submit("m", x[i], tenant="cap") for i in range(2)]
        with pytest.raises(QuotaExceededError, match="in-flight cap"):
            fleet.submit("m", x[2], tenant="cap")
        assert fleet.admission.inflight("cap") == 2
        fleet.close(drain=True)  # settles the queued requests
        for f in futs:
            f.result(timeout=60)
        assert fleet.admission.inflight("cap") == 0
    finally:
        fleet.close()
    _no_serving_threads()


def test_priority_shed_lowest_first_under_queue_pressure(setup):
    """Nothing flushes (the batch never fills, the wait is 10 s): the
    queue IS the pressure.  max_queue=10: low sheds at depth >= 5, normal
    at >= 8, high boards until the server itself is full."""
    w1, _, _, x = setup
    fleet = Fleet(max_batch_size=64, max_wait_ms=10_000, bucket_sizes=[64],
                  max_queue=10,
                  quotas={"gold": TenantQuota(priority=PRIORITY_HIGH),
                          "scraper": TenantQuota(priority=PRIORITY_LOW)})
    try:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        srv = fleet._state("m").server
        assert srv.max_queue == 10
        futs = [fleet.submit("m", x[i], tenant="gold") for i in range(5)]
        assert srv.queue_pressure() == 0.5
        with pytest.raises(ServiceUnavailableError, match="queue pressure"):
            fleet.submit("m", x[0], tenant="scraper")
        futs += [fleet.submit("m", x[5 + i], tenant="norm")
                 for i in range(3)]
        with pytest.raises(ServiceUnavailableError, match="queue pressure"):
            fleet.submit("m", x[0], tenant="norm")  # depth 8/10
        futs += [fleet.submit("m", x[8 + i], tenant="gold")
                 for i in range(2)]
        with pytest.raises(QueueFullError) as ei:
            fleet.submit("m", x[0], tenant="gold")
        assert not isinstance(ei.value, QuotaExceededError)
        assert ei.value.retry_after_s > 0
        fleet.close(drain=True)  # everyone admitted gets served
        for f in futs:
            f.result(timeout=60)
    finally:
        fleet.close()
    _no_serving_threads()


# -- varz, health, events ----------------------------------------------------

def test_fleet_varz_json_with_numpy_scalars_and_jax_keys(setup):
    w1, w2, _, x = setup
    kw = dict(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8])
    with jserving.Fleet(**kw) as jf:
        jf.add_model("m", _jfn, w1)
        jf.predict("m", x[0], tenant="t")
        jv = jf.varz()
    with Fleet(**kw) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        fleet.predict("m", x[0], tenant="t")
        pv = fleet.varz()
        fleet.add_version("m", _sd(w2))
        fleet.start_rollout("m", canary_fraction=1.0)
        fleet.predict("m", x[1])
        fleet.promote("m")
        fleet.metrics.incr("fleet.numpy_counter", np.float32(1.5))
        fleet.metrics.gauge("fleet.numpy_gauge", np.int64(3))
        fleet.metrics.record_time("fleet.numpy_time", np.float64(0.01))
        fleet.metrics.observe("fleet.numpy_obs", np.float32(0.25))
        body = json.loads(json.dumps(fleet.varz()))
    assert sorted(pv) == sorted(jv)
    assert sorted(pv["fleet"]) == sorted(jv["fleet"])
    assert (sorted(pv["fleet"]["models"]["m"])
            == sorted(jv["fleet"]["models"]["m"]))
    assert pv["tenants"] == jv["tenants"]
    assert pv["admission"] == jv["admission"]
    assert sorted(pv["counters"]) == sorted(jv["counters"])
    assert body["fleet"]["models"]["m"]["version"] == 2
    assert body["fleet"]["models"]["m"]["last_swap"]["no_recompile"] is True
    assert body["fleet"]["registry"]["m"]["versions"] == [1, 2]
    assert body["tenants"]["t"]["completed"] == 1
    assert body["admission"]["tenants"]["t"]["admitted"] == 1
    assert body["counters"]["fleet.swaps"] == 1
    assert body["health"]["state"] == "ready"
    assert body["metrics"]["counters"]["fleet.numpy_counter"] == 1.5


def test_health_payload_schema_shared_by_server_and_fleet(setup):
    """The one health schema: the port's Server and Fleet payloads have
    the core keys first, the state vocabulary and JSON; the Fleet's keys
    equal JAX's Fleet's."""
    from sparkdl_tpu_torch.utils.health import HEALTH_STATES

    w1, _, _, _ = setup
    kw = dict(max_batch_size=8, max_wait_ms=1, bucket_sizes=[8])
    with jserving.Fleet(**kw) as jf:
        jf.add_model("m", _jfn, w1)
        jh = jf.health()
    payloads = {}
    with Server(_pfn, Dense(w1["w"]), **kw) as srv:
        payloads["server"] = srv.health()
    with Fleet(**kw) as fl:
        fl.add_model("m", _pfn, Dense(w1["w"]))
        payloads["fleet"] = fl.health()
    assert fl.health()["state"] == "closed"
    for surface, h in payloads.items():
        assert list(h)[:4] == ["live", "state", "last_error",
                               "transitions"], surface
        assert h["state"] in HEALTH_STATES, surface
        assert isinstance(h["live"], bool) and h["transitions"], surface
        for tr in h["transitions"]:
            assert set(tr) == {"state", "t_monotonic"}, surface
        json.dumps(h)
    assert "breaker" in payloads["server"]
    assert list(payloads["fleet"]) == list(jh)
    assert sorted(payloads["fleet"]["models"]["m"]) == sorted(
        jh["models"]["m"])


def _incident(mod, faults_mod, fn, variables, x, cooldown_s=0.1):
    """A breaker trip mid-rollout, then recovery and the promote: the
    request routed to the broken (stable) leg is shed at the fleet
    door."""
    v1, v2 = variables
    plan = faults_mod.FaultPlan.parse(
        "seed=9;engine.dispatch:error:exc=dead,every=1,times=2")
    shed = 0
    with mod.Fleet(max_batch_size=8, max_wait_ms=1, bucket_sizes=[8],
                   dispatch_retries=1, breaker_threshold=2,
                   breaker_cooldown_s=cooldown_s) as fleet:
        fleet.add_model("m", fn, v1, warm_example=x)
        fleet.add_version("m", v2)
        fleet.start_rollout("m", canary_fraction=0.5, warm_example=x)
        # one request down each leg first (routing is deterministic: the
        # first goes to the stable leg, the second to the canary), so the
        # incident's requests meet a served path, not a first one: the
        # JAX package compiles its row slice (``jit(dynamic_slice)``) at
        # the first served request, process-wide, and run alone that
        # first request outlasts the breaker's cooldown
        for _ in range(2):
            fleet.predict("m", x)
        with faults_mod.active(plan):
            assert fleet.submit("m", x).exception(timeout=30) is not None
            for _ in range(2):
                try:
                    fleet.submit("m", x).result(timeout=30)
                except mod.ServiceUnavailableError:
                    shed += 1
            time.sleep(cooldown_s + 0.05)
            for _ in range(2):
                fleet.submit("m", x).result(timeout=30)
            fleet.promote("m")
        state = fleet.health()["state"]
    return shed, state


def test_fleet_shed_and_rollout_events_match_jax_and_reach_the_dump(
        setup, tmp_path, monkeypatch):
    """The same incident through both fleets gives the same ``rollout.*``
    and ``fleet.shed`` events (reason, priority); the port's recorder
    dumps them to its black-box file."""
    w1, w2, _, x = setup
    jrec = jflight.configure(enabled=True)
    rec = FlightRecorder(out_dir=str(tmp_path))
    monkeypatch.setattr(pflight, "_recorder", rec)
    jshed, jstate = _incident(jserving, jfaults, _jfn, (w1, w2), x[0])
    pshed, pstate = _incident(sparkdl_tpu_torch.serving, pfaults, _pfn,
                              (Dense(w1["w"]), _sd(w2)), x[0])
    assert jshed == pshed == 1 and jstate == pstate == "ready"

    def fleet_events(events):
        out = []
        for e in events:
            if e["event"].startswith(("rollout.", "fleet.")):
                attrs = dict(e.get("attrs") or {})
                attrs.pop("retry_after_s", None)  # a wall-clock remainder
                out.append((e["event"], attrs))
        return out

    got = fleet_events(rec.snapshot())
    assert got == fleet_events(jrec.snapshot())
    assert [n for n, _ in got] == ["rollout.start", "fleet.shed",
                                   "rollout.promote"]
    assert got[1][1] == {"tenant": "default", "reason": "breaker_open",
                         "priority": 1}
    path = rec.dump()
    dumped = [e["event"] for e in pflight.load_flight(path)]
    assert dumped.count("fleet.shed") == 1
    assert dumped.index("rollout.start") < dumped.index("breaker.open") \
        < dumped.index("fleet.shed") < dumped.index("rollout.promote")
    rec.close()
    _no_serving_threads()


def test_fleet_request_span_parents_the_server_request_span(setup,
                                                            monkeypatch):
    from sparkdl_tpu_torch.obs import trace as ptrace

    w1, _, _, x = setup
    monkeypatch.setattr(ptrace, "_tracer", ptrace._tracer)
    tracer = ptrace.configure(enabled=True)
    with Fleet(max_batch_size=8, max_wait_ms=1, bucket_sizes=[8]) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        for i in range(3):
            fleet.predict("m", x[i], tenant="t")
    spans = tracer.snapshot()
    fleet_spans = [s for s in spans if s["name"] == "fleet.request"]
    reqs = [s for s in spans if s["name"] == "serving.request"]
    assert len(fleet_spans) == len(reqs) == 3
    by_id = {s["span_id"]: s for s in fleet_spans}
    assert all(by_id[r["parent_id"]]["trace_id"] == r["trace_id"]
               for r in reqs)
    assert fleet_spans[0]["attrs"] == {"model": "m", "version": 1,
                                       "tenant": "t", "canary": False,
                                       "priority": 1}


def test_fleet_wake_flushes_a_wait_window_on_an_injected_clock(setup):
    """Under a virtual clock a lone request waits out its 10 s window on
    the real clock; moving the clock past the window and calling
    ``Fleet.wake`` flushes it at once."""
    w1, _, _, x = setup
    now = [50.0]
    with Fleet(max_batch_size=8, max_wait_ms=10_000, bucket_sizes=[8],
               clock=lambda: now[0]) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        f = fleet.submit("m", x[0])
        time.sleep(0.1)
        assert not f.done()
        now[0] += 11.0
        fleet.wake()
        np.testing.assert_array_equal(
            f.result(timeout=2), _oracle(_pfn, Dense(w1["w"]), x[:1])[0])


# -- the cache across a promote (test_cache.py's fleet cases) ----------------

def _cache_fleet(cache, fingerprints, m1, v2):
    fleet = Fleet(max_batch_size=8, max_wait_ms=1.0, cache=cache,
                  program_fingerprints=fingerprints)
    fleet.add_model("m", _pfn, m1)
    fleet.add_version("m", v2)
    return fleet


def _count_dispatches(srv):
    calls = [0]
    for b in srv.bucket_sizes:
        eng = srv._engine_for(b)
        real = eng.run_padded

        def counted(batch, _real=real):
            calls[0] += 1
            return _real(batch)

        eng.run_padded = counted
    return calls


def test_unchanged_fingerprint_promote_keeps_entries():
    cache = InferenceCache()
    m = Dense(np.random.default_rng(0).normal(size=(8, 4)).astype(
        np.float32))
    fleet = _cache_fleet(cache, {"m": "fp-stable"}, m, m.state_dict())
    x = np.ones(8, np.float32)
    y1 = fleet.predict("m", x)
    fleet.start_rollout("m", canary_fraction=0.0)
    report = fleet.promote("m")
    assert report["cache"] == {"survived": True, "entries": 1,
                               "fingerprint_unchanged": True,
                               "weights_unchanged": True}
    calls = _count_dispatches(fleet._state("m").server)
    y2 = fleet.predict("m", x)  # the v1-warmed entry serves v2
    fleet.close()
    assert calls[0] == 0
    assert np.array_equal(y1, y2)
    assert cache.metrics.snapshot_raw()["counters"]["cache.hits"] == 1.0
    assert len(cache) == 0  # the fleet's namespaces die with it


def test_changed_fingerprint_or_none_invalidates_on_promote(
        tmp_path, monkeypatch):
    cache = InferenceCache()
    fps = {"m": "fp-v1"}
    m = Dense(np.random.default_rng(0).normal(size=(8, 4)).astype(
        np.float32))
    fleet = _cache_fleet(cache, lambda name, entry: fps[name], m,
                         m.state_dict())
    x = np.ones(8, np.float32)
    y1 = fleet.predict("m", x)
    fps["m"] = "fp-v2"  # the program moved between deploys
    fleet.start_rollout("m", canary_fraction=0.0)
    report = fleet.promote("m")
    assert report["cache"]["survived"] is False
    assert report["cache"]["fingerprint_unchanged"] is False
    assert report["cache"]["weights_unchanged"] is True
    assert len(cache) == 0
    calls = _count_dispatches(fleet._state("m").server)
    y2 = fleet.predict("m", x)  # miss -> a fresh dispatch
    fleet.close()
    assert calls[0] == 1 and np.array_equal(y1, y2)
    assert cache.metrics.snapshot_raw()["counters"][
        "cache.invalidations"] >= 1.0
    # the default resolves the entry's fingerprint from the program
    # lockfile (both packages pointed at one explicit file): with no
    # record of the entry's model there is no fingerprint, so a promote of
    # the very same weights still invalidates; with one it survives, as
    # JAX's fleet does
    from sparkdl_tpu.analysis.program import lockfile as jlock
    from sparkdl_tpu.serving import cache as jcache
    from sparkdl_tpu_torch.analysis.program import lockfile as plock
    from sparkdl_tpu_torch.serving.cache import lockfile_model_fingerprint

    path = str(tmp_path / "lock.json")
    for mod in (plock, jlock):
        monkeypatch.setattr(mod, "DEFAULT_LOCKFILE", path)
    for models in ((), ("function",)):
        plock.write_lockfile([{"name": f"zoo/{md}/b8", "kind": "dispatch",
                               "model": md, "fingerprint": "fp-" + md}
                              for md in models], path)
        fleet = _cache_fleet(cache, None, m, m.state_dict())
        entry = fleet.registry.entry("m")
        fp = fleet._resolve_fingerprint(entry)
        assert entry.model_desc == "function"
        assert fp == lockfile_model_fingerprint("function") == \
            jcache.lockfile_model_fingerprint("function")
        assert (fp is None) == (not models)
        fleet.predict("m", x)
        fleet.start_rollout("m", canary_fraction=0.0)
        assert fleet.promote("m")["cache"]["survived"] is bool(models)
        fleet.close()


def test_new_weights_promote_invalidates_despite_fingerprint():
    cache = InferenceCache()
    rng = np.random.default_rng(1)
    m1 = Dense(rng.normal(size=(8, 4)).astype(np.float32))
    m2 = Dense(rng.normal(size=(8, 4)).astype(np.float32))
    fleet = _cache_fleet(cache, {"m": "fp-stable"}, m1, m2.state_dict())
    x = np.ones(8, np.float32)
    y1 = fleet.predict("m", x)
    fleet.start_rollout("m", canary_fraction=0.0)
    report = fleet.promote("m")
    assert report["cache"]["survived"] is False
    assert report["cache"]["fingerprint_unchanged"] is True
    assert report["cache"]["weights_unchanged"] is False
    y2 = fleet.predict("m", x)
    fleet.close()
    assert not np.array_equal(y1, y2)


# -- cross-tenant coalescing (test_ragged.py's fleet case) -------------------

def test_cross_tenant_coalescing_respects_admission_charges():
    """Sub-bucket remainders of DIFFERENT tenants coalesce into one ragged
    dispatch on the version's server, while admission charges each tenant
    on its own, and a zero-quota tenant is shed, never coalesced."""
    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("s", torch.tensor(2.0))

    def fn(m, x):
        return torch.tanh(x * m.s + 0.25)

    rng = np.random.default_rng(0)
    rows = [rng.normal(size=(6,)).astype(np.float32) for _ in range(8)]
    with Fleet(quotas={"a": TenantQuota(rate_per_s=100.0, burst=8),
                       "b": TenantQuota(rate_per_s=100.0, burst=8),
                       "nobody": TenantQuota(rate_per_s=0.0)},
               max_batch_size=8, max_wait_ms=40, bucket_sizes=[8],
               cache=False) as fleet:
        fleet.add_model("m", fn, Scale(), warm_example=rows[0])
        futs = [fleet.submit("m", rows[i], tenant="a") for i in range(5)]
        futs += [fleet.submit("m", rows[i], tenant="b")
                 for i in range(5, 8)]
        with pytest.raises(QuotaExceededError):
            fleet.submit("m", rows[0], tenant="nobody")
        outs = [f.result(timeout=60) for f in futs]
        s = fleet._state("m").server.metrics.summary()
        tenants = fleet.varz()["tenants"]
    assert s["serving.batches"] == 1
    assert s.get("engine.pad_rows", 0) == 0
    assert tenants["a"]["completed"] == 5
    assert tenants["b"]["completed"] == 3
    assert "nobody" not in tenants
    for got, r in zip(outs, rows):
        np.testing.assert_allclose(got, np.tanh(r * 2.0 + 0.25), **TOL)


# -- the head fan-out entry (test_headfanout.py's fleet case) ----------------

D_IN, D_FEAT, CLASSES = 12, 16, 4


def _fan_variables(seed=0):
    rng = np.random.default_rng(seed)
    return {"backbone": rng.normal(size=(D_IN, D_FEAT)).astype(np.float32)}


def _head(seed):
    rng = np.random.default_rng(100 + seed)
    return {"kernel": (rng.normal(size=(D_FEAT, CLASSES))
                       / np.sqrt(D_FEAT)).astype(np.float32),
            "bias": rng.normal(size=(CLASSES,)).astype(np.float32)}


def _payload(seed):
    return np.random.default_rng(200 + seed).normal(
        size=(D_IN,)).astype(np.float32)


def _fan_oracle(variables, head, x):
    """ONE unbatched row through the fused weights, never the fan-out."""
    fused = head_fanout_module({**variables, **head})
    with torch.inference_mode():
        return head_fanout_oracle_fn(fused, torch.from_numpy(x)).numpy()


def test_fleet_fanout_deploy_swap_and_guards():
    variables = _fan_variables()
    with Fleet(max_batch_size=8, max_wait_ms=0.5) as fleet:
        fleet.add_fanout_model("multi", head_fanout_backbone_fn,
                               head_fanout_module(variables),
                               model_desc="headfanout")
        r1 = fleet.add_head("multi", "a", _head(1))
        assert r1["head_version"] == 1
        srv = fleet._state("multi").server
        srv.warmup(_payload(0))
        srv.warm_head(np.zeros(D_FEAT, np.float32))
        x = _payload(0)
        got = fleet.predict("multi", x, tenant="a")
        assert got.tobytes() == _fan_oracle(variables, _head(1), x).tobytes()
        rep = fleet.swap_head("multi", "a", _head(5))
        assert rep["no_backbone_recompile"] is True
        assert rep["head_version"] == 2
        assert fleet.registry.head_versions("multi", "a") == [1, 2]
        got = fleet.predict("multi", x, tenant="a")
        assert got.tobytes() == _fan_oracle(variables, _head(5), x).tobytes()
        # the backbone never versions on a fan-out entry
        fleet.add_version("multi",
                          head_fanout_module(variables).state_dict())
        with pytest.raises(RuntimeError, match="fan-out"):
            fleet.start_rollout("multi")
        fleet.add_model("plain", head_fanout_backbone_fn,
                        head_fanout_module(variables))
        with pytest.raises(TypeError, match="not a head fan-out"):
            fleet.add_head("plain", "t", _head(1))
        rep = fleet.remove_head("multi", "a")
        assert "head_version" not in rep
        fleet.add_head("multi", "a", _head(1))
        v = fleet.varz()
        section = v["fleet"]["models"]["multi"]["headfanout"]
        assert section["tenants"] == ["a"]
        assert section["bank"]["mode"] == "stacked"
        json.dumps(v, default=str)
        assert v["fleet"]["registry"]["multi"]["heads"] == {"a": 3}
        assert v["fleet"]["models"]["multi"]["model"] == "function"
    _no_serving_threads()


# -- the narrowed zoo Xception, v1 and v2, held to JAX -----------------------

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
    return model


def test_zoo_xception_versions_match_jax_and_differ(zoo, xc_variables):
    """v1 (the zoo weights) and v2 (each float perturbed by 1 + 0.05 N(0,1),
    seeded) through both fleets: the canary at fraction 1 serves v2, the
    promoted fleet v2; rows within 1e-3 of JAX's, v2's far from v1's, and
    the zoo's shared module untouched."""
    rng = np.random.default_rng(9)
    v2 = jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.05 * rng.normal(size=a.shape))).astype(
            a.dtype) if np.issubdtype(a.dtype, np.floating) else a,
        xc_variables)
    imgs = np.random.default_rng(7).integers(0, 256, (4, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    kw = dict(max_batch_size=4, bucket_sizes=[4], max_wait_ms=100)
    results = {}
    before = {k: t.clone() for k, t in zoo.state_dict().items()}
    for side, mod, weights in (
            ("jax", jserving, v2),
            ("port", sparkdl_tpu_torch.serving,
             state_dict_from_jax("Xception", v2))):
        with mod.Fleet(**kw) as fleet:
            fleet.add_model("xc", "Xception", featurize=True)
            rows1 = [fleet.submit("xc", im) for im in imgs]
            rows1 = np.stack([np.asarray(f.result(120)) for f in rows1])
            fleet.add_version("xc", weights)
            fleet.start_rollout("xc", canary_fraction=1.0)
            futs = [fleet.submit("xc", im) for im in imgs]
            rows2 = np.stack([np.asarray(f.result(120)) for f in futs])
            assert all(f.fleet_version == 2 for f in futs)
            assert fleet.promote("xc")["no_recompile"] is True
        results[side] = (rows1, rows2)
    (j1, j2), (p1, p2) = results["jax"], results["port"]
    assert p1.shape == (4, 2048) and np.isfinite(p2).all()
    np.testing.assert_allclose(p1, j1, **ZOO_TOL)
    np.testing.assert_allclose(p2, j2, **ZOO_TOL)
    # the rows are small (random weights): v2 must sit far from v1 on
    # their own scale, and much nearer JAX's v2 than to v1
    moved = np.abs(p2 - p1).max()
    assert moved > 0.05 * np.abs(p1).max()
    assert np.abs(p2 - j2).max() < 0.1 * moved
    assert all(torch.equal(before[k], t) for k, t in zoo.state_dict().items())
    _no_serving_threads()


# -- the headline chaos test -------------------------------------------------

def test_chaos_rollout_under_mixed_tenant_load(setup):
    """A version rollout under sustained mixed-tenant load with injected
    swap-time faults: every admitted future resolves, every row is its
    version's oracle row bit for bit, quotas are enforced exactly, and the
    first promote dying on the injected ``fleet.swap`` fault leaves v1
    deployed (the retry wins)."""
    w1, w2, _, x = setup
    m1, m2 = Dense(w1["w"]), Dense(w2["w"])
    ref = {1: _oracle(_pfn, m1, x), 2: _oracle(_pfn, m2, x)}
    plan = pfaults.FaultPlan.parse(
        "seed=11;"
        "fleet.swap:error:exc=transient,at=1,times=1;"
        "fleet.canary:sleep:ms=1,every=7;"
        "fleet.admit:error:exc=queue_full,at=40,times=1,retry_after=0.02")
    settled = []          # (future, row index) of every ADMITTED request
    sheds = {"quota": 0, "storm": 0}
    shed_lock = threading.Lock()
    with pfaults.active(plan):
        with Fleet(max_batch_size=8, max_wait_ms=2, bucket_sizes=[8],
                   quotas={"metered": TenantQuota(rate_per_s=1e-4,
                                                  burst=5)}) as fleet:
            fleet.add_model("m", _pfn, m1, warm_example=x[0])
            fleet.add_version("m", _sd(w2))

            def client(tenant, n_requests):
                for k in range(n_requests):
                    i = k % len(x)
                    try:
                        fut = fleet.submit("m", x[i], tenant=tenant)
                    except QuotaExceededError:
                        with shed_lock:
                            sheds["quota"] += 1
                    except QueueFullError as e:  # the injected storm
                        assert e.retry_after_s > 0
                        with shed_lock:
                            sheds["storm"] += 1
                    else:
                        with shed_lock:
                            settled.append((fut, i))
                    time.sleep(0.002)

            threads = [threading.Thread(target=client, args=(t, 30))
                       for t in ("gold", "silver", "metered")]
            for t in threads:
                t.start()
            time.sleep(0.03)  # load is flowing; start the rollout
            fleet.start_rollout("m", canary_fraction=0.5,
                                warm_example=x[0])
            time.sleep(0.03)
            with pytest.raises(pfaults.InjectedTransientError):
                fleet.promote("m")
            assert fleet.deployed_version("m") == 1
            time.sleep(0.02)
            report = fleet.promote("m")  # the retry wins mid-load
            assert report["no_recompile"] is True
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert settled, "no requests were admitted"
            for fut, i in settled:
                np.testing.assert_array_equal(fut.result(timeout=60),
                                              ref[fut.fleet_version][i])
            assert {fut.fleet_version for fut, _ in settled} == {1, 2}
            snap = fleet.admission.snapshot()
            assert snap["tenants"]["metered"]["admitted"] <= 5
            assert (snap["tenants"]["metered"]["admitted"]
                    + snap["tenants"]["metered"]["shed"]
                    + (1 if sheds["storm"] else 0) >= 30)
            assert sheds["quota"] >= 24
            assert sheds["storm"] == 1
            assert fleet.deployed_version("m") == 2
            assert fleet.health()["state"] == "ready"
            json.dumps(fleet.varz())
    stats = plan.stats()
    assert stats["fleet.swap"]["fired"] == 1
    assert stats["fleet.admit"]["fired"] == 1
    assert stats["fleet.canary"]["fired"] >= 1
    _no_serving_threads()


def test_fleet_sites_registered():
    from sparkdl_tpu_torch.faults.sites import SITES, validate_site

    for site in ("fleet.admit", "fleet.canary", "fleet.swap"):
        assert validate_site(site) == site
        assert site in SITES
