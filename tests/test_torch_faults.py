"""The port's fault-injection harness (sparkdl_tpu_torch/faults) and retry
helpers (sparkdl_tpu_torch/utils/retry.py) held against the JAX package's:
the same spec strings parsed or refused alike, the same canonical forms,
the same firing sequences for the same seed, the same backoff draws."""

import random

import pytest

from sparkdl_tpu import faults as jfaults
from sparkdl_tpu.utils import retry as jretry
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.utils import retry as pretry


@pytest.fixture(autouse=True)
def _isolated_plans():
    from sparkdl_tpu.faults import plan as jplan
    from sparkdl_tpu_torch.faults import plan as pplan

    prev = jplan._PLAN, pplan._PLAN
    yield
    jplan._PLAN, pplan._PLAN = prev


# Every spec string of tests/test_faults.py's grammar and schedule tests.
GOOD_SPECS = [
    "seed=7;engine.dispatch:error:exc=transient,at=2;"
    "serving.admit:error:exc=queue_full,times=3;"
    "pipeline.gather:sleep:every=2,ms=1",
    "seed=9;engine.dispatch:error:p=0.5",
    "engine.dispatch:error:at=2",
    "seed=3;engine.dispatch:error:p=0.4",
    "seed=4;engine.dispatch:error:p=0.4",
    "engine.dispatch:dead:at=2",
    "seed=5;io.decode:error:at=1",
    "io.decode:error:at=1",
    "engine.dispatch:error:at=1",
    "engine.dispatch:error:exc=transient,at=2",
    "engine.dispatch:error:exc=fatal,at=1",
    "engine.dispatch:dead:at=1",
    "engine.dispatch:error:exc=fatal",
    "engine.gather:dead:at=1",
    "pipeline.gather:error:exc=transient,at=2,times=1",
    "pipeline.dispatch:error:exc=transient,at=1,times=1",
    "pipeline.gather:error:exc=fatal,at=1",
    "",
    " ; seed=2 ;; engine.gather:sleep ",
]
BAD_SPECS = [
    "nope.site:error", "engine.dispatch:boom", "engine.dispatch:error:zz=1",
    "seed=x", "engine.dispatch:error:exc=nonsense", "justasite",
    "io.decode:error:exc=queue_full", "engine.dispatch:error:exc=queue_full",
    "engine.dispatch:error:at=two", "engine.dispatch:error:at",
]


def test_site_table_is_the_jax_table():
    assert pfaults.SITE_HELP == jfaults.SITE_HELP
    assert pfaults.SITES == jfaults.SITES
    assert pfaults.ACTIONS == jfaults.ACTIONS


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_good_specs_parse_alike(spec):
    js, jrules = jfaults.parse_spec(spec)
    ps, prules = pfaults.parse_spec(spec)
    assert ps == js
    assert [r.clause for r in prules] == [r.clause for r in jrules]
    assert pfaults.FaultPlan.parse(spec).spec == \
        jfaults.FaultPlan.parse(spec).spec
    plan = pfaults.FaultPlan.parse(spec)
    assert pfaults.FaultPlan.parse(plan.spec).spec == plan.spec


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_are_refused_alike(spec):
    with pytest.raises(ValueError) as jerr:
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError) as perr:
        pfaults.parse_spec(spec)
    assert str(perr.value) == str(jerr.value)


def test_embedded_seed_means_what_it_means_in_parse():
    p = pfaults.FaultPlan(["seed=9;engine.dispatch:error:p=0.5"])
    assert p.seed == 9 and p.spec.startswith("seed=9;")
    with pytest.raises(ValueError):
        pfaults.FaultPlan([pfaults.FaultRule("engine.dispatch", "error",
                                             {"exc": "nope"})])


def _sequence(pkg, spec, site, calls=40):
    """What each of ``calls`` calls at ``site`` did under ``spec``:
    0 pass, else the raised type's name."""
    plan = pkg.FaultPlan.parse(spec)
    out = []
    for _ in range(calls):
        try:
            plan.fire(site, {})
            out.append(0)
        except pkg.InjectedFault as e:
            out.append(type(e).__name__)
    return out, plan.stats()


@pytest.mark.parametrize("spec,site", [
    ("seed=3;engine.dispatch:error:p=0.4", "engine.dispatch"),
    ("seed=4;engine.dispatch:error:p=0.4", "engine.dispatch"),
    ("seed=11;engine.gather:error:exc=fatal,p=0.3,times=5",
     "engine.gather"),
    ("seed=2;pipeline.gather:error:every=3;pipeline.gather:dead:at=20",
     "pipeline.gather"),
    ("engine.dispatch:error:at=2", "engine.dispatch"),
    ("seed=8;io.decode:error:exc=decode,p=0.25,every=2", "io.decode"),
])
def test_firing_sequences_match_jax(spec, site):
    got, pstats = _sequence(pfaults, spec, site)
    want, jstats = _sequence(jfaults, spec, site)
    assert got == want
    assert pstats == jstats
    assert any(got)


def test_different_seeds_differ():
    a, _ = _sequence(pfaults, "seed=3;engine.dispatch:error:p=0.4",
                     "engine.dispatch")
    b, _ = _sequence(pfaults, "seed=4;engine.dispatch:error:p=0.4",
                     "engine.dispatch")
    assert a != b and 0 < sum(1 for v in a if v) < len(a)


def test_dead_rule_is_sticky_and_clear_heals():
    pfaults.configure(pfaults.FaultPlan.parse("engine.dispatch:dead:at=2"))
    pfaults.inject("engine.dispatch")
    for _ in range(3):
        with pytest.raises(pfaults.InjectedDeadDeviceError):
            pfaults.inject("engine.dispatch")
    pfaults.clear()
    pfaults.inject("engine.dispatch")


def test_env_gate_and_active_restore(monkeypatch):
    pfaults.clear()
    assert pfaults.inject("engine.dispatch") is None
    assert pfaults.get_plan() is None and pfaults.current_spec() is None
    monkeypatch.setenv("SPARKDL_FAULTS", "seed=5;io.decode:error:at=1")
    plan = pfaults.configure_from_env()
    assert plan.seed == 5 and pfaults.current_spec() == plan.spec
    with pytest.raises(pfaults.InjectedTransientError):
        pfaults.inject("io.decode")
    outer = pfaults.configure(pfaults.FaultPlan.parse("io.decode:error:at=1"))
    with pfaults.active(pfaults.FaultPlan.parse(
            "engine.dispatch:error:at=1")) as p:
        with pytest.raises(pfaults.InjectedFault):
            pfaults.inject("engine.dispatch")
        assert p.fired() == 1
    assert pfaults.get_plan() is outer


def test_queue_full_parses_but_is_not_served_yet():
    """``exc=queue_full`` raises the serving layer's ``QueueFullError``
    with the rule's ``retry_after`` (0.05 s by default), as the JAX
    injector does, and a port ``Server`` rejects at admission with it as
    the JAX server does.  (The name is kept from when the port refused the
    rule.)"""
    import numpy as np
    import torch

    import sparkdl_tpu.serving as jserving
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.serving import QueueFullError, Server

    spec = "serving.admit:error:exc=queue_full"
    plan = pfaults.FaultPlan.parse(spec)
    assert plan.spec == jfaults.FaultPlan.parse(spec).spec
    with pytest.raises(QueueFullError) as pe:
        plan.fire("serving.admit", {})
    with pytest.raises(jserving.QueueFullError) as je:
        jfaults.FaultPlan.parse(spec).fire("serving.admit", {})
    assert pe.value.retry_after_s == je.value.retry_after_s == 0.05
    assert (pe.value.site, pe.value.rule) == (je.value.site, je.value.rule)
    assert str(pe.value) == str(je.value)

    x = np.ones(3, np.float32)
    got = []
    with sparkdl_tpu_torch.default_device("cpu"), \
            Server(lambda m, b: torch.tanh(b), max_batch_size=2,
                   cache=False) as srv, \
            pfaults.active(pfaults.FaultPlan.parse(spec + ",times=1")):
        with pytest.raises(QueueFullError) as ei:
            srv.submit(x)
        got.append(ei.value.retry_after_s)
        np.testing.assert_allclose(srv.predict(x), np.tanh(x))
    with jserving.Server(lambda v, b: b * 1.0, {}, max_batch_size=8,
                         cache=False) as jsrv, \
            jfaults.active(jfaults.FaultPlan.parse(spec + ",times=1")):
        with pytest.raises(jserving.QueueFullError) as ei:
            jsrv.submit(x)
        got.append(ei.value.retry_after_s)
    assert got == [0.05, 0.05]


def test_error_taxonomy_routes_like_jax():
    for name in ("InjectedTransientError", "InjectedDeadDeviceError",
                 "InjectedFatalError", "InjectedDecodeError"):
        p, j = getattr(pfaults, name), getattr(jfaults, name)
        assert ([b.__name__ for b in p.__mro__]
                == [b.__name__ for b in j.__mro__])
        assert (issubclass(p, pretry.NON_RETRYABLE)
                == issubclass(j, jretry.NON_RETRYABLE))


# -- retry -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_backoff_delay_matches_jax(seed):
    jr, pr = random.Random(seed), random.Random(seed)
    for attempt in range(12):
        for cap, jitter in ((None, 0.0), (0.75, 0.5), (2.0, 0.25)):
            assert pretry.backoff_delay(attempt, 0.1, cap, jitter, pr) == \
                jretry.backoff_delay(attempt, 0.1, cap, jitter, jr)
    assert pretry.backoff_delay(3, 0.1) == pytest.approx(0.8)
    assert pretry.backoff_delay(10, 0.1, max_backoff_seconds=2.0) == 2.0


@pytest.mark.parametrize("seed", [0, 3])
def test_with_retries_sleeps_match_jax(monkeypatch, seed):
    """The same budget gives the same sleeps: JAX's draws come from the
    global ``random``, seeded here; the port's from an explicit
    ``random.Random`` with that seed."""
    sleeps = []  # both modules sleep through the one ``time`` module
    monkeypatch.setattr(pretry.time, "sleep", sleeps.append)
    retried = {"jax": [], "port": []}

    def flaky():
        raise RuntimeError("flaky")

    kw = dict(max_retries=6, backoff_seconds=0.5, max_backoff_seconds=1.25,
              jitter=0.3)
    state = random.getstate()
    try:
        random.seed(seed)
        with pytest.raises(RuntimeError):
            jretry.with_retries(flaky, on_retry=lambda a, e: retried[
                "jax"].append(a), **kw)
    finally:
        random.setstate(state)
    jax_sleeps = list(sleeps)
    sleeps.clear()
    with pytest.raises(RuntimeError):
        pretry.with_retries(flaky, rng=random.Random(seed),
                            on_retry=lambda a, e: retried["port"].append(a),
                            **kw)
    sleeps = {"jax": jax_sleeps, "port": sleeps}
    assert sleeps["port"] == sleeps["jax"] and len(sleeps["port"]) == 6
    assert all(0.0 <= s <= 1.25 for s in sleeps["port"])
    assert retried["port"] == retried["jax"] == list(range(6))


@pytest.mark.parametrize("exc", [ValueError, TypeError, FloatingPointError])
def test_non_retryable_fail_at_once(exc):
    calls = []

    def bad():
        calls.append(1)
        raise exc("deterministic")

    with pytest.raises(exc):
        pretry.with_retries(bad, max_retries=5)
    assert calls == [1]
    assert pretry.NON_RETRYABLE == jretry.NON_RETRYABLE


def test_with_retries_returns_after_transient_failures():
    calls = []

    def twice_then_ok():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert pretry.with_retries(twice_then_ok, max_retries=2) == "ok"
    assert len(calls) == 3
