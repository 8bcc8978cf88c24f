"""The port's cost ledger (``sparkdl_tpu_torch.obs.cost``) held against the
JAX package's, on the CPU.

The same ``record_batch`` / ``record_hit`` sequences go into both
packages' ``CostLedger(lockfile_path=<a path that does not exist>)`` (no
lockfile: rows only): ``snapshot()`` and ``prometheus_text()`` must be
equal, exactly.  Covered: per-batch
conservation (tenant shares plus the ``__pad__`` residual equal the
metered seconds), the ``__overflow__`` fold past ``max_tenants``, the
sentinel's ``cost.regression`` and ``cost.recovered`` events and health
transitions, one small lockfile JSON given to both ledgers, each
package's default ledger over its own committed lockfile, the
``SPARKDL_COST`` grammar, ``resolve_cost`` and ``cost_rider``; then the
port's ``Server`` end to end (the ledger's device seconds are the
engine's metered seconds) and the ``cost.attr`` fault site degrading to
an error counter.  Every server runs under ``default_device("cpu")``.
"""

import json

import numpy as np
import pytest
import torch

from sparkdl_tpu.obs import cost as jcost
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.obs import trace as jtrace
from sparkdl_tpu.utils.health import HealthTracker as JHealth
import sparkdl_tpu_torch
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.obs import cost as pcost
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs import trace as ptrace
from sparkdl_tpu_torch.obs.cost import (OVERFLOW_TENANT, PAD_TENANT,
                                        CostLedger, CostRegression)
from sparkdl_tpu_torch.serving import Server
from sparkdl_tpu_torch.utils.health import HealthTracker

MISSING = "/nonexistent/lock.json"


@pytest.fixture(autouse=True)
def _restore_obs(monkeypatch):
    """Each test leaves both packages' tracer, recorder and default ledger
    as it found them."""
    for mod, name in ((ptrace, "_tracer"), (jtrace, "_tracer"),
                      (pflight, "_recorder"), (jflight, "_recorder"),
                      (pcost, "_default"), (jcost, "_default")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    pfaults.clear()
    yield
    pfaults.clear()


def _ledgers(**kw):
    return (CostLedger(lockfile_path=MISSING, **kw),
            jcost.CostLedger(lockfile_path=MISSING, **kw))


def _replay(ledgers, seed, n_batches=60, n_tenants=12, hits=True):
    """A seeded mixed-tenant replay into every ledger: batches with pad
    rows, queue wait and hbm bytes, and cache hits of three kinds.
    Returns the metered total."""
    rng = np.random.default_rng(seed)
    total = 0.0
    for _ in range(n_batches):
        k = int(rng.integers(1, 4))
        tenants = rng.choice(n_tenants, size=k, replace=False)
        rows = {f"t{int(t)}": int(rng.integers(1, 5)) for t in tenants}
        pad = int(rng.integers(0, 4))
        device_s = float(rng.uniform(1e-4, 5e-3))
        queue = {t: float(rng.uniform(0, 1e-3)) for t in rows}
        bucket = int(rng.choice([8, 16]))
        total += device_s
        for led in ledgers:
            led.record_batch(model="m", bucket=bucket, tenant_rows=rows,
                             device_s=device_s, queue_s_by_tenant=queue,
                             pad_rows=pad, hbm_bytes=1024.0)
        if hits and rng.uniform() < 0.4:
            kind = str(rng.choice(["hit", "coalesced", "feature_hit"]))
            for led in ledgers:
                led.record_hit(tenant=f"t{int(tenants[0])}", model="m",
                               kind=kind)
    return total


@pytest.mark.parametrize("seed, max_tenants, window", [
    (0, 32, 16), (7, 8, 6), (11, 4, 3), (19, 1, 1)])
def test_snapshot_and_prometheus_equal_jax(seed, max_tenants, window):
    port, jax_ = _ledgers(max_tenants=max_tenants, window=window)
    total = _replay((port, jax_), seed)
    snap = port.snapshot()
    assert snap == jax_.snapshot()
    assert port.prometheus_text() == jax_.prometheus_text()
    assert pcost.cost_rider(port) == jcost.cost_rider(jax_)
    assert port.tenant_costs() == jax_.tenant_costs()
    json.dumps(snap)
    tot = snap["totals"]
    assert tot["device_s"] == pytest.approx(total, rel=1e-12)
    # conservation: tenant shares + the pad residual == metered seconds
    assert abs(tot["attributed_device_s"] - tot["device_s"]) <= \
        1e-9 * tot["device_s"]
    assert PAD_TENANT not in snap["tenants"]
    assert snap["pad"]["rows"] == tot["pad_rows"] > 0
    if max_tenants < 12:
        assert snap["overflow"] and OVERFLOW_TENANT in snap["tenants"]
        assert snap["tracked_tenants"] <= max_tenants


def test_conservation_holds_per_batch():
    """Each batch alone: the tenants' shares plus the pad line are the
    batch's device seconds (the residual is exact by construction)."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        led = CostLedger()
        rows = {f"t{i}": int(rng.integers(1, 9)) for i in range(
            int(rng.integers(1, 6)))}
        d = float(rng.uniform(1e-5, 1.0))
        led.record_batch(model="m", bucket=64, tenant_rows=rows,
                         device_s=d, pad_rows=int(rng.integers(0, 30)))
        snap = led.snapshot()
        assert sum(v["device_s"] for v in snap["tenants"].values()) + \
            snap["pad"]["device_s"] == pytest.approx(d, rel=1e-15,
                                                     abs=1e-18)
        assert snap["totals"]["attributed_device_s"] == pytest.approx(
            d, rel=1e-15)


def test_overflow_fold_past_max_tenants_matches_jax():
    """A tenant-id storm folds into ``__overflow__``; late big spenders
    keep their own lines; both ledgers fold alike."""
    port, jax_ = _ledgers(max_tenants=4)
    for i in range(200):
        for led in (port, jax_):
            led.record_batch(model="m", bucket=8,
                             tenant_rows={f"storm-{i}": 1},
                             device_s=1e-5 * (1 + i % 7), pad_rows=7)
    for i in range(3):
        for led in (port, jax_):
            led.record_batch(model="m", bucket=8,
                             tenant_rows={f"whale-{i}": 8}, device_s=0.01)
    snap = port.snapshot()
    assert snap == jax_.snapshot()
    assert snap["overflow"] and snap["tracked_tenants"] == 4
    assert set(snap["tenants"]) >= {OVERFLOW_TENANT, "whale-0", "whale-1",
                                    "whale-2"}
    assert len(snap["tenants"]) == 5
    assert snap["totals"]["rows"] == 224


def _events(recorder):
    return [(e["event"], e.get("attrs")) for e in recorder.snapshot()]


def test_sentinel_regression_and_recovery_match_jax():
    """A sustained slowdown past ``regress_factor`` opens
    ``cost.regression`` and degrades the bound health tracker with a
    ``CostRegression``; back under ``recover_factor`` emits
    ``cost.recovered`` and clears it: the same events, attrs and health
    states on both sides."""
    precorder = pflight.configure(enabled=True)
    jrecorder = jflight.configure(enabled=True)
    ptrack, jtrack = HealthTracker("cost.t"), JHealth("cost.t")
    port = CostLedger(window=4, min_batches=4, regress_factor=2.0,
                      recover_factor=1.5, health=ptrack,
                      lockfile_path=MISSING)
    jax_ = jcost.CostLedger(window=4, min_batches=4, regress_factor=2.0,
                            recover_factor=1.5, health=jtrack,
                            lockfile_path=MISSING)
    states = []
    for d in [1e-3] * 4 + [5e-3] * 4 + [1e-3] * 4:
        for led in (port, jax_):
            led.record_batch(model="m", bucket=8, tenant_rows={"a": 8},
                             device_s=d)
        states.append((ptrack.snapshot()["state"],
                       jtrack.snapshot()["state"]))
        assert port.regressions() == jax_.regressions()
    assert [p for p, _ in states] == [j for _, j in states]
    assert "degraded" in [p for p, _ in states]
    assert states[-1] == ("ready", "ready")
    pe = [e for e in _events(precorder) if e[0].startswith("cost.")]
    je = [e for e in _events(jrecorder) if e[0].startswith("cost.")]
    assert pe == je
    assert [e[0] for e in pe] == ["cost.regression", "cost.recovered"]
    assert pe[0][1]["program"] == "m/b8" and pe[0][1]["reason"] == \
        "baseline"
    health = [e for e in _events(precorder) if e[0].startswith("health.")]
    assert health == [e for e in _events(jrecorder)
                      if e[0].startswith("health.")]
    assert [e[0] for e in health] == ["health.degraded", "health.ready"]
    assert ptrack.snapshot()["last_error"]["type"] == "CostRegression"
    assert CostRegression.__name__ == jcost.CostRegression.__name__


def test_recovery_guard_keeps_a_foreign_degradation():
    """The sentinel clears only the degradation it caused."""
    track = HealthTracker("cost.guard")
    led = CostLedger(window=2, min_batches=2, health=track)
    for d in (1e-3, 1e-3, 9e-3, 9e-3):
        led.record_batch(model="m", bucket=8, tenant_rows={"a": 8},
                         device_s=d)
    assert track.snapshot()["state"] == "degraded"
    track.note_failure(RuntimeError("device fell over"))
    for d in (1e-3, 1e-3):
        led.record_batch(model="m", bucket=8, tenant_rows={"a": 8},
                         device_s=d)
    assert led.regressions() == {}
    assert track.snapshot()["state"] == "degraded"
    assert track.snapshot()["last_error"]["type"] == "RuntimeError"


def test_pin_baseline_matches_jax():
    port, jax_ = _ledgers(window=4)
    _replay((port, jax_), 5, n_batches=10, hits=False)
    assert port.pin_baseline() == jax_.pin_baseline()
    assert port.pin_baseline("m/b8", 2e-4) == jax_.pin_baseline("m/b8", 2e-4)
    with pytest.raises(ValueError, match="no batches"):
        port.pin_baseline("never")
    assert port.snapshot()["programs"] == jax_.snapshot()["programs"]


def test_same_lockfile_given_to_both_ledgers(tmp_path):
    """A small lockfile JSON (the JAX package's schema) given to both: the
    covered (model, bucket) charges rows x ``flops_per_row`` under its
    program name, an uncovered one rows only; equal snapshots and text,
    and the analytic sentinel check agrees."""
    doc = {"schema_version": 1, "programs": {
        "m/fused/b8": {"kind": "dispatch", "model": "m", "rows": 8,
                       "fingerprint": "abc123", "flops_per_row": 100.0,
                       "bytes_accessed": 64.0},
        "m/fused/b16": {"kind": "dispatch", "model": "m", "rows": 16,
                        "fingerprint": "def456", "flops_per_row": 100.0,
                        "bytes_accessed": 64.0},
        "m/eval": {"kind": "eval", "model": "m", "rows": 4},
        "anon/b8": {"kind": "dispatch", "rows": 8},
    }}
    path = tmp_path / "lock.json"
    path.write_text(json.dumps(doc))
    port = CostLedger(lockfile_path=str(path), window=4, min_batches=4)
    jax_ = jcost.CostLedger(lockfile_path=str(path), window=4,
                            min_batches=4)
    _replay((port, jax_), 13, n_batches=40)
    for led in (port, jax_):
        led.record_batch(model="m", bucket=4, tenant_rows={"x": 2},
                         device_s=1e-3, pad_rows=2)
    snap = port.snapshot()
    assert snap == jax_.snapshot()
    assert port.prometheus_text() == jax_.prometheus_text()
    assert {"m/fused/b8", "m/fused/b16", "m/b4"} <= set(snap["programs"])
    assert snap["tenants"]["x"]["flops"] == 0.0
    assert snap["pad"]["flops"] > 0.0
    # a lockfile of another schema is not usable: rows only, like JAX
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(doc, schema_version=2)))
    port, jax_ = (CostLedger(lockfile_path=str(bad)),
                  jcost.CostLedger(lockfile_path=str(bad)))
    for led in (port, jax_):
        led.record_batch(model="m", bucket=8, tenant_rows={"a": 8},
                         device_s=1e-3)
    assert port.snapshot() == jax_.snapshot()
    assert "m/b8" in port.snapshot()["programs"]


def test_no_lockfile_charges_rows_only():
    led = CostLedger(lockfile_path=MISSING)
    led.record_batch(model="Xception", bucket=32, tenant_rows={"a": 30},
                     device_s=0.02, pad_rows=2, hbm_bytes=8e7)
    snap = led.snapshot()
    assert list(snap["programs"]) == ["Xception/b32"]
    assert snap["tenants"]["a"]["flops"] == 0.0
    assert snap["tenants"]["a"]["rows"] == 30
    assert snap["tenants"]["a"]["hbm_bytes_s"] == pytest.approx(
        8e7 * 0.02 * 30 / 32)


def test_default_ledger_charges_the_committed_lockfile():
    """``CostLedger()`` reads each package's own committed lockfile by
    default (the port's ``PROGRAMS_TORCH.lock.json``): a served Xception
    row at bucket 32 is charged its program's ``flops_per_row`` under the
    program name JAX's ledger gives it, and the port's figure is within
    1% of JAX's."""
    from sparkdl_tpu_torch.analysis.program.lockfile import (
        DEFAULT_LOCKFILE, read_lockfile)

    name = "zoo/Xception/featurize/bfloat16/b32"
    fpr = read_lockfile(DEFAULT_LOCKFILE)["programs"][name]["flops_per_row"]
    port, jax_ = CostLedger(), jcost.CostLedger()
    for led in (port, jax_):
        led.record_batch(model="Xception", bucket=32, tenant_rows={"a": 30},
                         device_s=0.02, pad_rows=2)
    psnap, jsnap = port.snapshot(), jax_.snapshot()
    assert list(psnap["programs"]) == list(jsnap["programs"]) == [name]
    assert psnap["tenants"]["a"]["flops"] == pytest.approx(30 * fpr)
    assert psnap["tenants"]["a"]["flops"] == pytest.approx(
        jsnap["tenants"]["a"]["flops"], rel=1e-2)


@pytest.mark.parametrize("spec", ["", "0", "off", "1", "on",
                                  "tenants=3,window=5,factor=1.5",
                                  "tenants=x", "bogus=1", "tenants"])
def test_sparkdl_cost_env_grammar_matches_jax(monkeypatch, spec):
    monkeypatch.setenv("SPARKDL_COST", spec)
    try:
        want = jcost.cost_from_env()
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pcost.cost_from_env()
        assert str(err.value) == str(e)
        return
    got = pcost.cost_from_env()
    if want is None:
        assert got is None
        return
    assert (got.max_tenants, got.window, got.regress_factor) == \
        (want.max_tenants, want.window, want.regress_factor)


def test_resolve_cost_and_process_default(monkeypatch):
    led = CostLedger()
    assert pcost.resolve_cost(led) is led
    assert pcost.resolve_cost(False) is None
    with pytest.raises(TypeError, match="CostLedger"):
        pcost.resolve_cost(jcost.CostLedger(lockfile_path=MISSING))
    monkeypatch.setattr(pcost, "_default", pcost._UNSET)
    monkeypatch.setenv("SPARKDL_COST", "tenants=5")
    default = pcost.resolve_cost(None)
    assert default is pcost.get_default() and default.max_tenants == 5
    assert pcost.configure(None) is None and pcost.resolve_cost(None) is None
    disabled = CostLedger(enabled=False)
    with pfaults.active(pfaults.FaultPlan.parse("cost.attr:error")):
        disabled.record_batch(model="m", bucket=8, tenant_rows={"a": 1},
                              device_s=1.0)
        disabled.record_hit(tenant="a", model="m")
    assert disabled.snapshot()["totals"]["batches"] == 0
    with pytest.raises(ValueError, match="unknown cost hit kind"):
        led.record_hit(tenant="a", model="m", kind="nope")


# -- the port's Server ------------------------------------------------------

class Dense(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.array(w)))
        self.register_buffer("b", torch.from_numpy(np.array(b)))


def _pfn(m, x):
    return torch.tanh((x[..., :, None] * m.w).sum(-2) + m.b)


@pytest.fixture
def dense():
    rng = np.random.default_rng(11)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    return Dense(w, b), rng.normal(size=(64, 12)).astype(np.float32)


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def test_server_conserves_the_engine_metered_seconds(dense):
    """Through the real batcher and engine: the ledger's device seconds
    are the engine's ``engine.device_time_s``, conserved across tenants
    and pad, with queue seconds and the bucket engine's parameter bytes;
    ``varz()["cost"]`` carries the snapshot, JSON-clean."""
    module, x = dense
    ledger = CostLedger(max_tenants=16)
    with Server(_pfn, module, max_batch_size=8, max_wait_ms=5,
                bucket_sizes=[8], max_queue=256, cache=False, cost=ledger,
                model_desc="m") as srv:
        futs = [srv.submit(x[i], tenant=f"t{i % 5}") for i in range(43)]
        for f in futs:
            f.result(timeout=60)
        metered = srv.metrics.counters["engine.device_time_s"]
        doc = srv.varz()
    json.dumps(doc)
    snap = ledger.snapshot()
    assert doc["cost"] == snap
    tot = snap["totals"]
    assert metered > 0 and tot["device_s"] == pytest.approx(metered,
                                                            rel=1e-9)
    assert abs(tot["attributed_device_s"] - tot["device_s"]) <= \
        1e-6 * tot["device_s"]
    assert set(snap["tenants"]) == {f"t{i}" for i in range(5)}
    assert tot["rows"] == 43 and tot["pad_rows"] > 0
    assert tot["queue_s"] > 0
    assert list(snap["programs"]) == ["m/b8"]
    param_bytes = (5 * 12 + 5) * 4
    t0 = snap["tenants"]["t0"]
    assert t0["hbm_bytes_s"] == pytest.approx(param_bytes * t0["device_s"])


def test_server_cache_hits_and_followers_charged(dense):
    module, x = dense
    ledger = CostLedger()
    from sparkdl_tpu_torch.serving import InferenceCache

    with Server(_pfn, module, max_batch_size=4, max_wait_ms=5,
                bucket_sizes=[4], cache=InferenceCache(), cost=ledger,
                model_desc="m") as srv:
        srv.submit(x[0], tenant="a").result(timeout=30)
        srv.submit(x[0], tenant="b").result(timeout=30)
        srv.submit(x[0]).result(timeout=30)
    snap = ledger.snapshot()
    assert snap["tenants"]["b"]["hits"] == 1
    assert snap["tenants"]["default"]["hits"] == 1
    assert snap["tenants"]["a"]["rows"] == 1
    assert snap["totals"]["hits"] == 2


def test_cost_attr_fault_never_fails_a_request(dense):
    """``cost.attr`` errors on every charge: every request still serves,
    and each failed attribution is a ``serving.cost_attr_errors`` count
    and a ledger error."""
    module, x = dense
    ledger = CostLedger()
    with pfaults.active(pfaults.FaultPlan.parse("cost.attr:error")):
        with Server(_pfn, module, max_batch_size=4, max_wait_ms=5,
                    bucket_sizes=[4], cache=False, cost=ledger) as srv:
            rows = [srv.submit(x[i], tenant="a").result(timeout=30)
                    for i in range(6)]
            errors = srv.metrics.counters.get("serving.cost_attr_errors")
    assert len(rows) == 6 and all(np.isfinite(r).all() for r in rows)
    assert errors == srv.metrics.counters["serving.batches"] >= 1
    snap = ledger.snapshot()
    assert snap["totals"]["attr_errors"] == errors
    assert snap["totals"]["batches"] == 0
