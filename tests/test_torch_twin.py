"""The port's traffic twin (``sparkdl_tpu_torch/twin``) held against the JAX
package's (``sparkdl_tpu/twin``), on the CPU.

Every tier-1 contract of ``tests/test_twin.py`` on the port's side: the
virtual clock, clock injection into admission, ``Server`` and
``SLOEngine``, the seeded scenario (flash crowd, retry feedback, the clip),
two days byte-identical, the autoscaler's decisions and its win over the
static baseline, the placement planner's budget (re-verified through the
port's ``param_sharding_stats``) and its refusals, ``MeshSlice``, the
registries, the ``twin.arrival`` / ``twin.tick`` chaos, and a day's flight
dump folded by ``tools/blackbox.build_timeline``.

Across the packages, byte for byte: the scenario's arrival arrays and
payloads, ``plan_placement``'s ``as_dict()`` and digest (and its
refusals' messages), and a small day's ``event_lines``,
``event_digest``, ``scores`` and placement under ``StaticPolicy`` and
under ``QuotaAutoscaler(TIGHT_QUOTA)``: event lines carry counts, virtual
times, SLO burns, cost rows and decisions, never model outputs, so every
field is compared exactly.  The slow test runs the canonical day in both
packages and against the digest ``chip_smoke.py`` holds the card's day
to.  Every port day runs under ``default_device("cpu")``.
"""

import json

import numpy as np
import pytest
import torch

import sparkdl_tpu.twin as jtwin
import sparkdl_tpu_torch
import sparkdl_tpu_torch.twin as ptwin
from sparkdl_tpu import faults as jfaults
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.serving import TenantQuota as JQuota
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.faults.sites import SITE_HELP, validate_site
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs.flight import FlightRecorder
from sparkdl_tpu_torch.obs.slo import SLO, SLOEngine
from sparkdl_tpu_torch.parallel.mesh import param_sharding_stats
from sparkdl_tpu_torch.serving import Server, TenantQuota
from sparkdl_tpu_torch.serving.errors import QuotaExceededError
from sparkdl_tpu_torch.serving.fleet.admission import AdmissionController
from sparkdl_tpu_torch.twin import (MeshSlice, PlacementError,
                                    QuotaAutoscaler, Scenario,
                                    ScenarioConfig, StaticPolicy,
                                    VirtualClock, plan_placement, run_day)
from sparkdl_tpu_torch.utils.metrics import Metrics

#: tight quota (refill 45 tokens a 300 s tick): the small flash crowd
#: sheds hard, which is the whole policy story (tests/test_twin.py's)
TIGHT_QUOTA = TenantQuota(rate_per_s=0.15, burst=60)
JAX_TIGHT_QUOTA = JQuota(rate_per_s=0.15, burst=60)

SMALL = dict(seed=5, ticks=12, tenants=16, mean_arrivals_per_tick=60.0,
             flash_start=4, flash_end=8, flash_tenants=4, canary_tick=2,
             stream_every=5, digest_universe=64)


def _small_cfg(**kw):
    return ScenarioConfig(**dict(SMALL, **kw))


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


class _Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(w))


def _fn(m, x):
    return torch.tanh(x @ m.w)


# -- virtual clock and clock injection ----------------------------------------

def test_virtual_clock_contract():
    clock = VirtualClock()
    assert clock() == 0.0 and clock.now == 0.0
    assert clock.advance(2.5) == 2.5
    assert clock() == 2.5
    clock.advance(0.0)  # a zero advance is legal (a no-op tick)
    with pytest.raises(ValueError, match="backward"):
        clock.advance(-0.1)
    assert clock.now == 2.5


def test_admission_bucket_refills_on_virtual_time_only():
    clock = VirtualClock()
    ctrl = AdmissionController(
        default_quota=TenantQuota(rate_per_s=1.0, burst=2), clock=clock)
    for _ in range(2):
        ctrl.admit("t")
        ctrl.release("t")
    # bucket empty and the clock frozen: no amount of wall time refills
    with pytest.raises(QuotaExceededError):
        ctrl.admit("t")
    clock.advance(1.0)  # one virtual second = one token
    ctrl.admit("t")
    ctrl.release("t")
    with pytest.raises(QuotaExceededError):
        ctrl.admit("t")


def test_server_flush_waits_for_virtual_time():
    rng = np.random.default_rng(0)
    clock = VirtualClock()
    module = _Dense(rng.normal(size=(6, 6)).astype(np.float32))
    x = rng.normal(size=(6,)).astype(np.float32)
    with Server(_fn, module, max_batch_size=8, max_wait_ms=5_000.0,
                bucket_sizes=[8], clock=clock) as srv:
        fut = srv.submit(x)
        # under a frozen clock the 5-virtual-second wait window never
        # elapses, however much wall time passes
        with pytest.raises(Exception):
            fut.result(timeout=0.2)
        clock.advance(10.0)
        srv.wake()
        y = fut.result(timeout=30)
        assert np.asarray(y).shape == (6,)


def test_slo_engine_windows_ride_virtual_time():
    clock = VirtualClock()
    m = Metrics()
    eng = SLOEngine(
        m, [SLO("avail", "availability", good="g", total="t",
                objective=0.999)], clock=clock)
    m.incr("g", 100)
    m.incr("t", 100)
    eng.evaluate()
    clock.advance(300.0)
    m.incr("g", 50)
    m.incr("t", 100)  # 50% bad over the last virtual window
    snap = eng.evaluate()
    st = snap["objectives"][0]
    assert snap["state"] == "breach"
    assert st["burn_short"] > st["burn_threshold"]
    clock.advance(300.0)
    m.incr("g", 100)
    m.incr("t", 100)
    assert eng.evaluate()["state"] == "ok"


# -- scenario ---------------------------------------------------------------

def test_scenario_seeded_and_shaped():
    cfg = _small_cfg()
    a, b = Scenario(cfg), Scenario(cfg)
    total = 0
    for tick in range(cfg.ticks):
        arr_a = a.arrivals(tick)
        arr_b = b.arrivals(tick)
        for f in ("tenant", "model", "digest", "retry"):
            np.testing.assert_array_equal(getattr(arr_a, f),
                                          getattr(arr_b, f))
        assert len(arr_a) <= cfg.max_arrivals_per_tick
        assert arr_a.tenant.max(initial=0) < cfg.tenants
        assert arr_a.digest.max(initial=0) < cfg.digest_universe
        total += len(arr_a)
    assert total > 0
    np.testing.assert_array_equal(a.payloads, b.payloads)
    steady = len(a.arrivals(1))
    flash = len(a.arrivals(cfg.flash_start))
    assert flash > 2 * steady
    assert a.phase(cfg.flash_start) == "flash_crowd"
    with_retries = a.arrivals(1, retry_counts={0: 40})
    assert with_retries.retry.sum() > 0
    assert len(with_retries) > steady


def test_scenario_clip_is_deterministic():
    cfg = _small_cfg(max_arrivals_per_tick=50, mean_arrivals_per_tick=200.0)
    arr = Scenario(cfg).arrivals(1)
    assert len(arr) == 50 and arr.clipped > 0
    arr2 = Scenario(cfg).arrivals(1)
    np.testing.assert_array_equal(arr.tenant, arr2.tenant)
    assert arr.clipped == arr2.clipped


SCENARIO_CASES = [
    ("small", SMALL, None),
    ("small_retries", SMALL, {0: 40, 3: 7, 11: 300}),
    ("clipped", dict(SMALL, max_arrivals_per_tick=50,
                     mean_arrivals_per_tick=200.0), {2: 5}),
    ("canonical", {}, {1: 12, 5: 900, 40: 3}),
]


@pytest.mark.parametrize("name,kw,retries", SCENARIO_CASES,
                         ids=[c[0] for c in SCENARIO_CASES])
def test_scenario_arrays_equal_jax_byte_for_byte(name, kw, retries):
    pcfg, jcfg = ScenarioConfig(**kw), jtwin.ScenarioConfig(**kw)
    ps, js = Scenario(pcfg), jtwin.Scenario(jcfg)
    assert ps.payloads.tobytes() == js.payloads.tobytes()
    ticks = sorted({0, 1, pcfg.flash_start, pcfg.ticks - 1,
                    pcfg.flash_end - 1})
    for tick in ticks:
        pa, ja = ps.arrivals(tick, retries), js.arrivals(tick, retries)
        for f in ("tenant", "model", "digest", "retry"):
            p, j = getattr(pa, f), getattr(ja, f)
            assert p.dtype == j.dtype and p.tobytes() == j.tobytes(), (
                tick, f)
        assert pa.clipped == ja.clipped
        assert ps.phase(tick) == js.phase(tick)
        assert ps.diurnal(tick) == js.diurnal(tick)
        p_chunk, j_chunk = ps.stream_payload(tick), js.stream_payload(tick)
        assert (p_chunk is None) == (j_chunk is None)
        if p_chunk is not None:
            assert p_chunk.tobytes() == j_chunk.tobytes()


# -- the headline bar: byte-identical days ----------------------------------

def test_two_runs_byte_identical_events_decisions_scores():
    cfg = _small_cfg()
    r1 = run_day(cfg, policy=StaticPolicy(), default_quota=TIGHT_QUOTA)
    r2 = run_day(cfg, policy=StaticPolicy(), default_quota=TIGHT_QUOTA)
    assert r1.event_lines == r2.event_lines
    assert r1.event_digest == r2.event_digest
    assert r1.scores == r2.scores
    assert len(r1.event_lines) == cfg.ticks
    assert r1.scores["offered"] > 500
    assert r1.scores["stream_commits"] > 0
    assert r1.scores["cache_hit_rate"] > 0.1
    assert r1.scores["tenants_active"] == cfg.tenants
    doc = json.loads(r1.event_lines[-1])
    for key in ("tick", "vt", "phase", "slo", "decision",
                "cache_hits_coalesced_total"):
        assert key in doc
    assert json.loads(r1.event_lines[0])["vt"] == cfg.tick_s
    assert doc["vt"] == cfg.ticks * cfg.tick_s
    # every server of the day ran where the day ran, and served
    assert r1.device == "cpu"
    assert {s["device"] for s in r1.servers} == {"cpu"}
    assert {(s["model"], s["version"]) for s in r1.servers} == {
        ("ranker", 1), ("ranker", 2), ("detector", 1), ("scorer", 1)}
    assert all(s["dispatches"] > 0 for s in r1.servers)


def test_adaptive_run_deterministic_with_decisions():
    cfg = _small_cfg()
    mk = lambda: QuotaAutoscaler(TIGHT_QUOTA)  # noqa: E731
    r1 = run_day(cfg, policy=mk(), default_quota=TIGHT_QUOTA)
    r2 = run_day(cfg, policy=mk(), default_quota=TIGHT_QUOTA)
    assert r1.event_lines == r2.event_lines
    assert r1.scores == r2.scores
    levers = [a["lever"] for line in r1.event_lines
              for a in json.loads(line)["decision"]]
    assert "quota" in levers
    assert "canary" in levers


@pytest.mark.parametrize("policy", ["static", "autoscaler"])
def test_small_day_equals_jax_byte_for_byte(policy):
    if policy == "static":
        pp, jp = StaticPolicy(), jtwin.StaticPolicy()
    else:
        pp = QuotaAutoscaler(TIGHT_QUOTA)
        jp = jtwin.QuotaAutoscaler(JAX_TIGHT_QUOTA)
    rp = run_day(_small_cfg(), policy=pp, default_quota=TIGHT_QUOTA)
    rj = jtwin.run_day(jtwin.ScenarioConfig(**SMALL), policy=jp,
                       default_quota=JAX_TIGHT_QUOTA)
    assert rp.policy == rj.policy
    assert rp.event_lines == rj.event_lines
    assert rp.event_digest == rj.event_digest
    assert rp.scores == rj.scores
    assert rp.placement == rj.placement


# -- closed loop (a): policy beats static -----------------------------------

def test_policy_beats_static_through_flash_crowd():
    cfg = _small_cfg(ticks=16)
    rs = run_day(cfg, policy=StaticPolicy(), default_quota=TIGHT_QUOTA)
    ra = run_day(cfg, policy=QuotaAutoscaler(TIGHT_QUOTA),
                 default_quota=TIGHT_QUOTA)
    assert rs.scores["slo_minutes"] > 0
    assert rs.scores["shed"] > 0
    assert ra.scores["slo_minutes"] < rs.scores["slo_minutes"]
    assert ra.scores["goodput"] > rs.scores["goodput"]
    assert ra.scores["fairness"] >= rs.scores["fairness"]


# -- closed loop (b): placement ---------------------------------------------

def _entries(leaf_shapes):
    """name -> param dict; keys matter: the default partition rules only
    split leaves named ``kernel`` / ``embedding`` (and a module's
    ``weight``)."""
    rng = np.random.default_rng(0)
    return {name: {leaf: rng.normal(size=s).astype(np.float32)
                   for leaf, s in shapes.items()}
            for name, shapes in leaf_shapes.items()}


def test_placement_respects_hbm_budget_via_stats():
    entries = _entries({
        "big": {"kernel": (256, 256), "bias": (256,)},
        "small": {"kernel": (32, 32)},
    })
    chip = 200 * 1024
    plan = plan_placement(entries, chip_hbm_bytes=chip, total_chip_budget=16)
    usable = plan.usable_hbm_bytes
    assert usable == int(chip * 0.75)
    for p in plan.placements:
        mesh = MeshSlice(data=1, model=p.model_parallel)
        stats = param_sharding_stats(mesh, entries[p.model])
        assert p.stats["param_bytes_per_chip"] <= usable
        assert p.stats["param_bytes_total"] == stats["param_bytes_total"]
    by_name = {p.model: p for p in plan.placements}
    assert by_name["big"].model_parallel > 1
    assert not by_name["big"].replicated
    assert by_name["big"].partition_digest != "replicated"
    assert by_name["small"].model_parallel == 1
    assert by_name["small"].replicated
    assert plan.chips_used <= plan.total_chip_budget
    plan2 = plan_placement(entries, chip_hbm_bytes=chip, total_chip_budget=16)
    assert plan.digest() == plan2.digest()
    json.dumps(plan.as_dict())


def test_placement_infeasible_raises():
    entries = _entries({"huge": {"kernel": (512, 513)}})
    with pytest.raises(PlacementError, match="fits no allowed slice"):
        plan_placement(entries, chip_hbm_bytes=64 * 1024,
                       total_chip_budget=64)
    many = _entries({f"m{i}": {"kernel": (256, 256)} for i in range(4)})
    with pytest.raises(PlacementError, match="budget"):
        plan_placement(many, chip_hbm_bytes=200 * 1024,
                       total_chip_budget=2, slice_chips=(2, 4))
    with pytest.raises(ValueError):
        plan_placement({}, chip_hbm_bytes=1, total_chip_budget=1)
    with pytest.raises(ValueError):
        plan_placement(entries, chip_hbm_bytes=1, total_chip_budget=1,
                       reserve_fraction=1.5)


def test_mesh_slice_matches_helper_surface():
    s = MeshSlice(data=2, model=4)
    assert s.chips == 8
    assert s.shape["model"] == 4 and s.axis_names == ("data", "model")
    with pytest.raises(ValueError):
        MeshSlice(data=0)


PLACEMENT_CASES = [
    ("budget", {"big": {"kernel": (256, 256), "bias": (256,)},
                "small": {"kernel": (32, 32)}}, 200 * 1024, 16, (1, 2, 4, 8)),
    ("deep", {"a": {"kernel": (512, 512)}, "b": {"kernel": (64, 128)},
              "c": {"embedding": (1000, 64), "scale": (64,)}},
     300 * 1024, 32, (1, 2, 4, 8)),
    ("packed", {f"m{i}": {"kernel": (128, 64 * (i + 1))} for i in range(5)},
     96 * 1024, 32, (1, 2, 4)),
    ("twin", {m: {"w": (8, 8)} for m in ("ranker", "detector", "scorer")},
     64 * 1024, 16, (1, 2, 4, 8)),
]


@pytest.mark.parametrize("name,shapes,chip,budget,slices", PLACEMENT_CASES,
                         ids=[c[0] for c in PLACEMENT_CASES])
def test_placement_equals_jax(name, shapes, chip, budget, slices):
    entries = _entries(shapes)
    kw = dict(chip_hbm_bytes=chip, total_chip_budget=budget,
              slice_chips=slices)
    pplan = plan_placement(entries, **kw)
    jplan = jtwin.plan_placement(entries, **kw)
    assert pplan.as_dict() == jplan.as_dict()
    assert pplan.digest() == jplan.digest()
    assert [p.stats for p in pplan.placements] == [
        p.stats for p in jplan.placements]


def test_placement_of_modules_equals_jax_of_arrays():
    """The twin plans over its modules (a module's tree is its
    ``state_dict``): the plan is the JAX twin's over the same arrays."""
    entries = _entries({"ranker": {"w": (8, 8)}, "x": {"kernel": (64, 64)}})
    modules = {"ranker": _Dense(entries["ranker"]["w"]),
               "x": torch.nn.Module()}
    modules["x"].register_buffer(
        "kernel", torch.from_numpy(entries["x"]["kernel"]))
    kw = dict(chip_hbm_bytes=16 * 1024, total_chip_budget=16)
    assert (plan_placement(modules, **kw).as_dict()
            == jtwin.plan_placement(entries, **kw).as_dict())


@pytest.mark.parametrize("case", ["no_slice", "over_budget"])
def test_placement_refusals_equal_jax(case):
    if case == "no_slice":
        entries = _entries({"huge": {"kernel": (512, 513)}})
        kw = dict(chip_hbm_bytes=64 * 1024, total_chip_budget=64)
    else:
        entries = _entries({f"m{i}": {"kernel": (256, 256)}
                            for i in range(4)})
        kw = dict(chip_hbm_bytes=200 * 1024, total_chip_budget=2,
                  slice_chips=(2, 4))
    with pytest.raises(PlacementError) as pe:
        plan_placement(entries, **kw)
    with pytest.raises(jtwin.PlacementError) as je:
        jtwin.plan_placement(entries, **kw)
    assert str(pe.value) == str(je.value)


# -- registries ---------------------------------------------------------------

def test_twin_sites_and_events_registered():
    assert validate_site("twin.tick") == "twin.tick"
    assert validate_site("twin.arrival") == "twin.arrival"
    for site in ("twin.tick", "twin.arrival"):
        assert SITE_HELP[site]
    for ev in ("twin.scenario", "policy.adjust", "placement.plan"):
        assert pflight.validate_event(ev) == ev
    assert ptwin.__all__ == jtwin.__all__


# -- chaos ------------------------------------------------------------------

def test_twin_arrival_fault_drops_are_scored():
    cfg = _small_cfg(ticks=6, canary_tick=None, stream_every=0)
    plan = pfaults.FaultPlan.parse("seed=1;twin.arrival:error:"
                                   "exc=transient,every=25")
    with pfaults.active(plan):
        r = run_day(cfg, policy=StaticPolicy())
    assert r.scores["fault_drops"] > 0
    assert r.scores["offered"] == r.scores["submitted"] + r.scores["shed"]
    assert r.scores["shed"] >= r.scores["fault_drops"]
    # the JAX twin under the same plan drops the same arrivals
    jplan = jfaults.FaultPlan.parse("seed=1;twin.arrival:error:"
                                    "exc=transient,every=25")
    with jfaults.active(jplan):
        rj = jtwin.run_day(jtwin.ScenarioConfig(**dict(
            SMALL, ticks=6, canary_tick=None, stream_every=0)),
            policy=jtwin.StaticPolicy())
    assert r.event_lines == rj.event_lines and r.scores == rj.scores


def test_twin_tick_sleep_rule_does_not_move_an_event_byte():
    cfg = _small_cfg(ticks=6, canary_tick=None, stream_every=0)
    r_clean = run_day(cfg, policy=StaticPolicy(), default_quota=TIGHT_QUOTA)
    plan = pfaults.FaultPlan.parse("seed=7;twin.tick:sleep:ms=1,times=3")
    with pfaults.active(plan):
        r_chaos = run_day(cfg, policy=StaticPolicy(),
                          default_quota=TIGHT_QUOTA)
    assert r_clean.event_lines == r_chaos.event_lines
    assert r_clean.event_digest == r_chaos.event_digest


# -- blackbox ---------------------------------------------------------------

def test_blackbox_timeline_folds_twin_incident(tmp_path, monkeypatch):
    """The day's SLO incident folds into a clean timeline.  The fleet's
    cost sentinel is held shut here: it compares wall-measured seconds a
    row against its own first batches, which a test machine loaded by
    other workers moves by 2x, and an open ``cost.regression`` degrades
    the fleet tracker the SLO recovery must clear (no twin event depends
    on it: event lines carry cost rows only)."""
    from sparkdl_tpu_torch.obs import cost as pcost
    from tools.blackbox import build_timeline

    class ShutSentinel(pcost.CostLedger):
        def __init__(self, **kw):
            super().__init__(regress_factor=float("inf"), **kw)

    monkeypatch.setattr(pcost, "CostLedger", ShutSentinel)
    rec = FlightRecorder(out_dir=str(tmp_path))
    monkeypatch.setattr(pflight, "_recorder", rec)
    r = run_day(_small_cfg(ticks=10), policy=QuotaAutoscaler(TIGHT_QUOTA),
                default_quota=TIGHT_QUOTA)
    dump = str(tmp_path / "flight_twin.jsonl")
    rec.dump(dump)
    doc = build_timeline(dump)
    chain = doc["chain"]
    for ev in ("twin.scenario", "policy.adjust", "placement.plan",
               "slo.breach", "slo.recovered"):
        assert ev in chain
    assert doc["verdict"]["clean"] is True, doc["verdict"]
    json.dumps(doc)
    assert r.scores["slo_minutes"] >= 0


def test_port_blackbox_folds_twin_incident(tmp_path, monkeypatch):
    """The twin of the test above through ``tools/port_blackbox.py``, which
    imports no JAX: the day's dump folds into the same timeline document
    as ``tools/blackbox.py`` gives, with the incident in it and a clean
    verdict (exit 0 from both CLIs)."""
    from sparkdl_tpu_torch.obs import cost as pcost
    from tools import blackbox, port_blackbox

    class ShutSentinel(pcost.CostLedger):
        def __init__(self, **kw):
            super().__init__(regress_factor=float("inf"), **kw)

    monkeypatch.setattr(pcost, "CostLedger", ShutSentinel)
    rec = FlightRecorder(out_dir=str(tmp_path))
    monkeypatch.setattr(pflight, "_recorder", rec)
    run_day(_small_cfg(ticks=10), policy=QuotaAutoscaler(TIGHT_QUOTA),
            default_quota=TIGHT_QUOTA)
    dump = str(tmp_path / "flight_twin.jsonl")
    rec.dump(dump)
    doc = port_blackbox.build_timeline(dump)
    assert doc == blackbox.build_timeline(dump)
    for ev in ("twin.scenario", "policy.adjust", "placement.plan",
               "slo.breach", "slo.recovered"):
        assert ev in doc["chain"]
    assert doc["verdict"]["clean"] is True, doc["verdict"]
    assert port_blackbox.main([dump]) == blackbox.main([dump]) == 0


# -- the device -----------------------------------------------------------------

def test_day_without_cuda_raises(monkeypatch):
    """The day runs on the card unless the CPU was asked for: with no card
    and no CPU asked for it raises before building a fleet."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with sparkdl_tpu_torch.default_device(None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_day(_small_cfg(ticks=1))
    r = run_day(_small_cfg(ticks=1, canary_tick=None, stream_every=0),
                device="cpu")
    assert r.device == "cpu" and len(r.event_lines) == 1


def test_small_day_digest_in_chip_smoke_is_jax():
    """``chip_smoke.py`` holds the card's small day to a JAX digest: it is
    the JAX package's small day (StaticPolicy, tight quota)."""
    import chip_smoke

    rj = jtwin.run_day(jtwin.ScenarioConfig(**chip_smoke.TWIN_SMALL),
                       policy=jtwin.StaticPolicy(),
                       default_quota=JQuota(**chip_smoke.TWIN_SMALL_QUOTA))
    assert rj.event_digest == chip_smoke.TWIN_SMALL_DIGEST
    assert rj.scores == chip_smoke.TWIN_SMALL_SCORES


# -- the canonical day ------------------------------------------------------

@pytest.mark.slow
def test_canonical_day_equals_jax_and_the_smoke_constant():
    import chip_smoke

    mk = lambda: QuotaAutoscaler(ptwin.DEFAULT_TENANT_QUOTA)  # noqa: E731
    r1 = run_day(ScenarioConfig(), policy=mk())
    r2 = run_day(ScenarioConfig(), policy=mk())
    assert r1.event_digest == r2.event_digest
    assert r1.scores == r2.scores
    assert r1.scores["offered"] >= 100_000
    assert r1.scores["tenants_active"] >= 50
    rj = jtwin.run_day(jtwin.ScenarioConfig(), policy=jtwin.QuotaAutoscaler(
        jtwin.DEFAULT_TENANT_QUOTA))
    assert r1.event_lines == rj.event_lines
    assert r1.event_digest == rj.event_digest == chip_smoke.TWIN_DAY_DIGEST
    assert r1.scores == rj.scores == chip_smoke.TWIN_DAY_SCORES
