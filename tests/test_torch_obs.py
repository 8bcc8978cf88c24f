"""The port's spans, exporters, exemplars, SLOs and the rest of its
metrics module held against the JAX package's, and the serving stack run
under full observability, on the CPU.

Held to JAX: the ``SPARKDL_TRACE`` grammar; ``to_chrome_trace`` of the same
span dicts, ``prometheus_text`` / ``metrics_snapshot`` /
``write_metrics_jsonl`` of registries fed the same calls and
``load_spans`` of the same artifacts (equal); the exemplar reservoir over
the same offers; the SLO engine's ``evaluate()`` dicts over the same
counter, timing and gauge sequences at the same explicit ``now`` values,
at the exact breach and recovery crossings, with health flipping through
``SLOViolation`` and the same ``slo.*`` events; ``StepTimer`` and
``throughput_counter``.  On the port's side: span nesting, cross-thread
parenting, a finish raced by many threads recorded once, the disabled
path handing out ``NULL_SPAN`` and recording nothing, the trace-id log
filter, the ``torch.profiler`` hook.

Serving: a dense model through the port's ``Server`` with tracing, the
flight recorder, ``slos=`` and ``cost=`` all on gives rows equal bit for
bit to the same server with all of them off; every request's trace reaches
``serving.request`` -> ``serving.microbatch`` -> ``engine.call`` ->
``engine.dispatch``; ``varz()`` (with ``cost`` and ``exemplars``) passes
through ``json.dumps``.  The same under a 96x96 zoo Xception, whose rows
are held to the JAX server's within 1e-3.  The pipelined runner's spans,
the ``batch.topoff`` and ``serving.drain`` events and the head fan-out's
``cache.feature_hit`` and ``head.swap`` events and per-tenant cost lines
too.  Every port object runs under ``default_device("cpu")``.
"""

import dataclasses
import glob
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu.serving as jserving
import sparkdl_tpu.transformers.named_image as jax_ni
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.obs import cost as jcost
from sparkdl_tpu.obs import exemplar as jexemplar
from sparkdl_tpu.obs import export as jexport
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.obs import slo as jslo
from sparkdl_tpu.obs import trace as jtrace
from sparkdl_tpu.utils import health as jhealth
from sparkdl_tpu.utils import metrics as jmetrics
import sparkdl_tpu_torch
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu_torch import obs
from sparkdl_tpu_torch.models import get_model_spec as port_spec
from sparkdl_tpu_torch.models.convert import state_dict_from_jax
from sparkdl_tpu_torch.models.xception import Xception
from sparkdl_tpu_torch.obs import cost as pcost
from sparkdl_tpu_torch.obs import export as pexport
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs import slo as pslo
from sparkdl_tpu_torch.obs import trace as ptrace
from sparkdl_tpu_torch.obs.cost import CostLedger
from sparkdl_tpu_torch.obs.exemplar import ExemplarReservoir
from sparkdl_tpu_torch.obs.slo import SLO
from sparkdl_tpu_torch.obs.trace import NULL_SPAN
from sparkdl_tpu_torch.parallel.engine import (InferenceEngine,
                                               head_fanout_backbone_fn,
                                               head_fanout_module)
from sparkdl_tpu_torch.serving import (HeadFanoutServer, InferenceCache,
                                       Server)
from sparkdl_tpu_torch.serving.batcher import Request
from sparkdl_tpu_torch.utils import health as phealth
from sparkdl_tpu_torch.utils import metrics as pmetrics

ZOO_TOL = dict(rtol=1e-3, atol=1e-3)   # tests/test_torch_serving.py's
SIZE = 96                              # Xception narrowed as there


@pytest.fixture(autouse=True)
def _restore_obs(monkeypatch):
    """Each test leaves both packages' tracer, recorder and default ledger
    as it found them."""
    for mod, name in ((ptrace, "_tracer"), (jtrace, "_tracer"),
                      (pflight, "_recorder"), (jflight, "_recorder"),
                      (pcost, "_default"), (jcost, "_default")):
        monkeypatch.setattr(mod, name, getattr(mod, name))


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


# -- spans -------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["", "0", "false", "OFF", "no", "1", "true",
                                 "ON", "yes", "/tmp/some/dir", " 1 "])
def test_trace_env_gate_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("SPARKDL_TRACE", raw)
    assert ptrace.tracing_from_env() == jtrace.tracing_from_env()


def test_disabled_path_is_null_and_writes_nothing(tmp_path):
    tracer = obs.configure(enabled=False, out_dir=str(tmp_path))
    sp = tracer.span("anything", rows=3)
    assert sp is NULL_SPAN and tracer.start_span("x") is NULL_SPAN
    assert tracer.use(sp) is NULL_SPAN
    with sp as inner:
        inner.annotate(k=1)
        marker = object()
        assert inner.block_until_ready(marker) is marker  # never waits
    sp.finish("error")
    assert len(tracer) == 0 and tracer.snapshot() == []
    assert obs.current_trace_id() is None
    assert tracer.flush() == [] and list(tmp_path.iterdir()) == []
    t0 = time.perf_counter()
    for _ in range(50_000):
        with tracer.span("hot"):
            pass
    assert time.perf_counter() - t0 < 1.0


def _assert_child_within_parent(spans):
    by_id = {s["span_id"]: s for s in spans}
    checked = 0
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is None:
            continue
        assert p["trace_id"] == s["trace_id"]
        assert p["ts_us"] <= s["ts_us"] + 1.0
        assert s["ts_us"] + s["dur_us"] <= p["ts_us"] + p["dur_us"] + 1.0
        checked += 1
    return checked


def test_span_nesting_ring_and_clear():
    tracer = obs.configure(enabled=True, capacity=8)
    with tracer.span("outer", a=1) as outer:
        assert tracer.current() is outer
        assert obs.current_trace_id() == outer.trace_id
        with tracer.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
    spans = tracer.snapshot()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    assert spans[1]["attrs"] == {"a": 1}
    assert _assert_child_within_parent(spans) == 1
    with pytest.raises(RuntimeError):
        with tracer.span("boom"):
            raise RuntimeError("x")
    assert tracer.snapshot()[-1]["status"] == "error"
    for i in range(30):
        with tracer.span("s", i=i):
            pass
    assert [s["attrs"]["i"] for s in tracer.snapshot()] == list(
        range(22, 30))
    tracer.clear()
    assert tracer.snapshot() == []


def test_cross_thread_parenting_and_racing_finishers():
    """``start_span`` on one thread, ``use`` on others (the serving edges:
    caller, batcher, two dispatch workers); eight threads finishing the
    same span record it once, with the first status."""
    tracer = obs.configure(enabled=True)
    root = tracer.start_span("serving.request")
    batch = tracer.start_span("serving.microbatch", parent=root)
    seen = []

    def worker(k):
        with tracer.use(batch):
            with tracer.span("engine.call", k=k) as c:
                seen.append((c.trace_id, c.parent_id))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == [(root.trace_id, batch.span_id)] * 2
    go = threading.Barrier(8)

    def finisher(k):
        go.wait()
        batch.finish("ok" if k % 2 else "error")

    threads = [threading.Thread(target=finisher, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    root.finish()
    root.finish("error")  # idempotent
    spans = tracer.snapshot()
    assert [s["name"] for s in spans].count("serving.microbatch") == 1
    assert spans[-1]["name"] == "serving.request" and \
        spans[-1]["status"] == "ok"
    assert tracer.current() is None


def test_block_until_ready_on_the_cpu_passes_through():
    tracer = obs.configure(enabled=True)
    x = {"a": torch.ones(3), "b": [torch.zeros(2), np.ones(1)]}
    with tracer.span("gather") as sp:
        assert sp.block_until_ready(x) is x
    assert sp.device_s >= 0.0


# -- exporters -----------------------------------------------------------------

def _spans_from_both():
    """The same operations on both packages' tracers; spans differ only in
    clocks and thread ids, so one list feeds both exporters."""
    ptr = ptrace.configure(enabled=True)
    with ptr.span("serving.request", timeout_ms=5.0) as r:
        with ptr.span("engine.call", rows=3) as c:
            c.annotate(device_ms=1.25)
            c.device_s = 0.002
    r.attrs["bucket"] = 8
    return ptr.snapshot()


def test_chrome_trace_equals_jax_and_load_spans_round_trips(tmp_path):
    spans = _spans_from_both()
    assert pexport.to_chrome_trace(spans) == jexport.to_chrome_trace(spans)
    chrome = pexport.write_chrome_trace(str(tmp_path / "trace_1.json"),
                                        spans)
    jsonl = pexport.write_spans_jsonl(str(tmp_path / "spans_1.jsonl"), spans)
    jtwin = jexport.write_spans_jsonl(str(tmp_path / "j.jsonl"), spans)
    assert open(jsonl).read() == open(jtwin).read()
    assert pexport.load_spans(jsonl) == spans == jexport.load_spans(jsonl)
    back = pexport.load_spans(chrome)
    assert back == jexport.load_spans(chrome)
    assert [(s["name"], s["span_id"], s["parent_id"], s["status"])
            for s in back] == [(s["name"], s["span_id"], s["parent_id"],
                                s["status"]) for s in spans]
    assert back[0]["device_us"] == pytest.approx(1250.0)
    assert pexport.load_spans(str(tmp_path)) == jexport.load_spans(
        str(tmp_path))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert pexport.load_spans(str(empty)) == []


def _feed(metrics):
    for i in range(40):
        metrics.incr("serving.requests")
        metrics.record_time("serving.request_latency", 1e-3 * (1 + i % 7))
        metrics.observe("serving.batch_fill_ratio", (i % 4) / 4)
    metrics.incr("engine.call_host_s", 0.125)
    metrics.incr("weird name/with:chars", 3)
    metrics.gauge("serving.queue_depth", 7)
    metrics.gauge("9lives", -1.5)
    metrics.record_time("empty.after", 1.0)
    metrics.timings_s["empty.after"].clear()


def test_prometheus_snapshot_and_jsonl_equal_jax(tmp_path):
    pm, jm = pmetrics.Metrics(), jmetrics.Metrics()
    _feed(pm)
    _feed(jm)
    assert pexport.prometheus_text(pm) == jexport.prometheus_text(jm)
    assert pexport.prometheus_text(pm, prefix="x") == \
        jexport.prometheus_text(jm, prefix="x")
    assert pexport.prometheus_text(pmetrics.Metrics()) == ""
    assert pexport.metrics_snapshot(pm) == jexport.metrics_snapshot(jm)
    pp, jp = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    for _ in range(2):
        pexport.write_metrics_jsonl(pp, pm, extra={"run": 1})
        jexport.write_metrics_jsonl(jp, jm, extra={"run": 1})
    got = [json.loads(line) for line in open(pp)]
    want = [json.loads(line) for line in open(jp)]
    assert len(got) == 2
    for g, w in zip(got, want):
        g.pop("ts"), w.pop("ts")
        assert g == w


def test_exemplar_reservoir_keeps_the_same_top_k_as_jax():
    ptr = ptrace.configure(enabled=True)
    jtr = jtrace.configure(enabled=True)
    pres, jres = ExemplarReservoir(k=3), jexemplar.ExemplarReservoir(k=3)
    durations = [0.3, 0.1, 0.5, 0.2, 0.9, 0.05, 0.5, 0.7]
    admitted = {"p": [], "j": []}
    for d in durations:
        for side, tr, res in (("p", ptr, pres), ("j", jtr, jres)):
            with tr.span("serving.request") as sp:
                with tr.span("engine.call"):
                    pass
            admitted[side].append(res.offer(d, sp.trace_id, tr))
    assert admitted["p"] == admitted["j"]
    got, want = pres.snapshot(), jres.snapshot()
    assert [(e["trace_id"], e["duration_ms"]) for e in got] == \
        [(e["trace_id"], e["duration_ms"]) for e in want]
    assert [e["duration_ms"] for e in got] == [900.0, 700.0, 500.0]
    assert [len(e["spans"]) for e in got] == [2, 2, 2]
    assert not pres.offer(1.0, "t1", ptrace.Tracer(enabled=False))
    pres.clear()
    assert pres.snapshot() == []


# -- SLOs --------------------------------------------------------------------

def _slo_pair(objectives, ops, **engine_kw):
    """Run ``ops`` against a port engine and a JAX engine side by side:
    ("incr"|"time"|"gauge", name, value), ("eval", now) or ("fail",).
    Returns per side the evaluate() dicts with the health state and
    last_error type after each, and the slo.* events."""
    out = []
    for S, E, M, H, F in ((SLO, pslo.SLOEngine, pmetrics.Metrics,
                           phealth.HealthTracker, pflight),
                          (jslo.SLO, jslo.SLOEngine, jmetrics.Metrics,
                           jhealth.HealthTracker, jflight)):
        rec = F.configure(enabled=True)
        m = M()
        h = H("slo.health", name="owner")
        eng = E(m, [S(**o) for o in objectives], health=h, **engine_kw)
        results = []
        for op in ops:
            if op[0] == "incr":
                m.incr(op[1], op[2])
            elif op[0] == "time":
                m.record_time(op[1], op[2])
            elif op[0] == "gauge":
                m.gauge(op[1], op[2])
            elif op[0] == "fail":
                h.note_failure(RuntimeError("device died"))
            else:
                res = eng.evaluate(now=op[1])
                snap = h.snapshot()
                results.append((res, snap["state"],
                                (snap["last_error"] or {}).get("type")))
        events = [(e["event"], e.get("attrs")) for e in rec.snapshot()
                  if e["event"].startswith("slo.")]
        out.append((results, events))
    return out


AVAIL = dict(name="avail", kind="availability", good="ok", total="all",
             objective=0.9, burn_threshold=2.0)
SLO_CASES = {
    # 19% bad holds at burn 1.9; 20% cumulative crosses the long window at
    # EXACTLY 2.0; clean traffic in the short window recovers
    "exact_crossing_and_recovery": ([AVAIL], [
        ("eval", 0.0), ("incr", "all", 100.0), ("incr", "ok", 81.0),
        ("eval", 10.0), ("incr", "all", 100.0), ("incr", "ok", 79.0),
        ("eval", 20.0), ("incr", "all", 100.0), ("incr", "ok", 100.0),
        ("eval", 26.0), ("eval", 27.0)],
        dict(short_window_s=5.0, long_window_s=300.0)),
    # a blip burns the short window while the long one refuses the page
    "two_window_guard": ([AVAIL], [
        ("eval", 0.0), ("incr", "all", 1000.0), ("incr", "ok", 1000.0),
        ("eval", 100.0), ("incr", "all", 10.0), ("incr", "ok", 5.0),
        ("eval", 304.0)], dict(short_window_s=5.0, long_window_s=300.0)),
    # a foreign failure during the breach survives the recovery
    "recovery_guard": ([dict(AVAIL, burn_threshold=1.0)], [
        ("eval", 0.0), ("incr", "all", 10.0), ("eval", 10.0), ("fail",),
        ("incr", "all", 100.0), ("incr", "ok", 100.0), ("eval", 20.0)],
        dict(short_window_s=5.0, long_window_s=5.0)),
    # p99 under, then over, then at exactly the threshold
    "latency": ([dict(name="p99", kind="latency",
                      series="serving.request_latency",
                      threshold_ms=200.0)],
                [("eval", 0.0)]
                + [("time", "serving.request_latency", v)
                   for v in [0.05] * 9 + [0.199]]
                + [("eval", 1.0), ("time", "serving.request_latency", 0.4),
                   ("eval", 2.0)]
                + [("time", "serving.request_latency", 0.01)] * 300
                + [("eval", 3.0)], {}),
    "lag": ([dict(name="lag", kind="lag", gauge="stream.lag_seconds",
                  threshold_s=30.0)],
            [("eval", 1.0), ("gauge", "stream.lag_seconds", 29.9),
             ("eval", 2.0), ("gauge", "stream.lag_seconds", 30.0),
             ("eval", 3.0), ("gauge", "stream.lag_seconds", 1.0),
             ("eval", 4.0)], {}),
    "mixed_kinds": ([AVAIL, dict(name="p99", kind="latency",
                                 series="lat", threshold_ms=5.0)],
                    [("eval", 0.0), ("incr", "all", 50.0),
                     ("incr", "ok", 50.0), ("time", "lat", 0.001),
                     ("eval", 1.0), ("time", "lat", 0.009),
                     ("eval", 2.0)], dict(max_samples=2)),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_evaluate_equals_jax(case):
    objectives, ops, kw = SLO_CASES[case]
    port, jax_ = _slo_pair(objectives, ops, **kw)
    assert port == jax_
    results, events = port
    if case == "exact_crossing_and_recovery":
        states = [(r[0]["state"], r[1], r[2]) for r in results]
        assert states == [("ok", "ready", None), ("ok", "ready", None),
                          ("breach", "degraded", "SLOViolation"),
                          ("ok", "ready", "SLOViolation"),
                          ("ok", "ready", "SLOViolation")]
        assert results[2][0]["objectives"][0]["burn_long"] == 2.0
        assert [e[0] for e in events] == ["slo.breach", "slo.recovered"]
    if case == "recovery_guard":
        assert results[-1][1:] == ("degraded", "RuntimeError")
    if case == "lag":
        assert [r[0]["state"] for r in results] == ["ok", "ok", "breach",
                                                    "ok"]


def test_slo_declarations_and_defaults_match_jax():
    for kw, match in ((dict(kind="throughput"), "kind"),
                      (dict(kind="availability", objective=0.99), "good="),
                      (dict(kind="availability", good="g", total="t",
                            objective=1.5), "objective"),
                      (dict(kind="latency", series="s"), "threshold_ms"),
                      (dict(kind="lag", threshold_s=30.0), "gauge="),
                      (dict(kind="lag", gauge="g", threshold_s=1.0,
                            burn_threshold=0.0), "burn_threshold")):
        with pytest.raises(ValueError, match=match) as perr:
            SLO("x", **kw)
        with pytest.raises(ValueError) as jerr:
            jslo.SLO("x", **kw)
        assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="short_window_s"):
        pslo.SLOEngine(pmetrics.Metrics(), [], short_window_s=10,
                       long_window_s=1)
    slo = SLO("avail", "availability", good="g", total="t",
              objective=0.999)
    assert slo.as_dict() == jslo.SLO("avail", "availability", good="g",
                                     total="t", objective=0.999).as_dict()
    for feed in ([], [("incr", "serving.requests", 10.0),
                      ("incr", "serving.completed", 10.0),
                      ("time", "serving.request_latency", 0.01)],
                 [("incr", "fleet.requests", 5.0),
                  ("incr", "fleet.completed", 4.0),
                  ("incr", "stream.chunks", 3.0),
                  ("incr", "stream.commits", 3.0),
                  ("gauge", "stream.lag_seconds", 0.5)]):
        pm, jm = pmetrics.Metrics(), jmetrics.Metrics()
        for m in (pm, jm):
            for kind, name, v in feed:
                {"incr": m.incr, "time": m.record_time,
                 "gauge": m.gauge}[kind](name, v)
        assert [o.as_dict() for o in pslo.default_objectives(pm)] == \
            [o.as_dict() for o in jslo.default_objectives(jm)]
        got, want = pslo.slo_snapshot(pm), jslo.slo_snapshot(jm)
        if want is None:
            assert got is None
        else:
            got.pop("t_mono"), want.pop("t_mono")
            assert got == want


# -- the rest of utils/metrics.py and the log filter -------------------------

def test_step_timer_and_throughput_counter_match_jax():
    for args in ((128, 2.0), (10, 0.0), (64, 4.0, 4)):
        assert pmetrics.throughput_counter(*args) == \
            jmetrics.throughput_counter(*args)
    m = pmetrics.Metrics()
    timer = pmetrics.StepTimer(m, name="step")
    with timer.time(block_on=torch.ones(2)):
        time.sleep(0.01)
    with timer.time():
        pass
    assert timer.elapsed_s >= 0.0
    assert len(m.timings_s["step"]) == 2 and m.timings_s["step"][0] >= 0.009
    free = pmetrics.StepTimer()
    with free.time():
        pass
    assert free.elapsed_s >= 0.0


def test_profile_hook_writes_a_torch_profiler_trace(tmp_path):
    m = pmetrics.Metrics()
    with m.profile(str(tmp_path), block_on=torch.ones(4)) as prof:
        assert prof is m
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1 and json.load(open(traces[0]))["traceEvents"]
    assert m.timings_s["profile"][0] > 0.0


def test_log_records_carry_the_current_trace_id():
    from sparkdl_tpu_torch.utils.logging import _FORMAT, _TraceContextFilter

    f = _TraceContextFilter()

    def record():
        return logging.LogRecord("sparkdl_tpu_torch.x", logging.INFO, "f",
                                 1, "msg", None, None)

    obs.configure(enabled=False)
    r = record()
    assert f.filter(r) and r.trace == ""
    tracer = obs.configure(enabled=True)
    with tracer.span("op") as sp:
        r = record()
        assert f.filter(r) and r.trace == f" trace={sp.trace_id}"
        assert logging.Formatter(_FORMAT).format(r).endswith(
            f"sparkdl_tpu_torch.x trace={sp.trace_id}: msg")
    r = record()
    assert f.filter(r) and r.trace == ""


# -- the serving stack under observability -------------------------------------

class Dense(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.array(w)))
        self.register_buffer("b", torch.from_numpy(np.array(b)))


def _pfn(m, x):
    # a broadcast multiply and a reduction: a row's arithmetic is the same
    # wherever it sits in a batch
    return torch.tanh((x[..., :, None] * m.w).sum(-2) + m.b)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(11)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    return Dense(w, b), rng.normal(size=(45, 12)).astype(np.float32)


def _obs_on(tmp_path=None):
    """Tracing and the flight recorder on (in memory), a fresh ledger and
    objectives that do not breach."""
    tracer = ptrace.configure(enabled=True)
    recorder = pflight.configure(enabled=True)
    ledger = CostLedger(max_tenants=4, window=4)
    slos = [SLO("avail", "availability", good="serving.completed",
                total="serving.requests", objective=0.999),
            SLO("p99", "latency", series="serving.request_latency",
                threshold_ms=60_000.0)]
    return tracer, recorder, ledger, slos


def _obs_off():
    ptrace.configure(enabled=False)
    pflight.configure(enabled=False)
    pcost.configure(None)


def _serve(srv, x, order, n_clients=3, tenants=6):
    rows = [None] * len(x)

    def client(idxs):
        futs = [(int(i), srv.submit(x[int(i)], tenant=f"t{int(i) % tenants}"))
                for i in idxs]
        for i, f in futs:
            rows[i] = f.result(timeout=60)

    threads = [threading.Thread(target=client, args=(order[k::n_clients],))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return np.stack(rows)


def _request_chains(spans):
    """trace id of every request -> whether a micro-batch span covering it
    (as its trace or a member) has an engine.call child with an
    engine.dispatch child."""
    by_id = {s["span_id"]: s for s in spans}
    children = {}
    for s in spans:
        children.setdefault(s["parent_id"], []).append(s)
    covered = set()
    for b in spans:
        if b["name"] != "serving.microbatch":
            continue
        parent = by_id.get(b["parent_id"])
        assert parent is not None and parent["name"] == "serving.request"
        calls = [c for c in children.get(b["span_id"], [])
                 if c["name"] == "engine.call"]
        dispatches = [d for c in calls for d in children.get(c["span_id"], [])
                      if d["name"] == "engine.dispatch"]
        if dispatches:
            covered.update(b["attrs"]["member_traces"])
    return {s["trace_id"]: s["trace_id"] in covered for s in spans
            if s["name"] == "serving.request"}


def test_served_rows_equal_with_observability_off_and_on(dense):
    module, x = dense
    order = np.random.default_rng(3).permutation(len(x))
    kw = dict(max_batch_size=8, max_wait_ms=5, bucket_sizes=[4, 8],
              max_queue=256, cache=False)
    _obs_off()
    with Server(_pfn, module, **kw) as srv:
        off = _serve(srv, x, order)
        assert srv.varz()["exemplars"] == [] and srv.varz()["cost"] is None
        assert "slo" not in srv.health()
    assert ptrace.get_tracer().snapshot() == []
    tracer, recorder, ledger, slos = _obs_on()
    with Server(_pfn, module, cost=ledger, slos=slos, model_desc="dense",
                **kw) as srv:
        on = _serve(srv, x, order)
        h = srv.health()
        doc = srv.varz()
        metered = srv.metrics.counters["engine.call_host_s"]
    np.testing.assert_array_equal(on, off)
    ref = InferenceEngine(_pfn, module, device_batch_size=8)(x)
    np.testing.assert_array_equal(on, ref)
    # the span tree: request -> microbatch -> engine.call -> dispatch
    spans = tracer.snapshot()
    chains = _request_chains(spans)
    assert len(chains) == len(x) and all(chains.values())
    assert _assert_child_within_parent(spans) >= 3 * len(x) // 8
    # varz: cost and exemplars, JSON-clean
    json.dumps(doc)
    assert doc["cost"]["totals"]["rows"] == len(x)
    assert doc["cost"]["totals"]["device_s"] == pytest.approx(metered,
                                                              rel=1e-9)
    tot = doc["cost"]["totals"]
    assert abs(tot["attributed_device_s"] - tot["device_s"]) <= \
        1e-6 * tot["device_s"]
    assert doc["cost"]["overflow"] is True  # 6 tenants, 4 tracked
    assert 1 <= len(doc["exemplars"]) <= 4
    ex = doc["exemplars"][0]
    assert {s["name"] for s in ex["spans"]} >= {"serving.request"}
    assert h["slo"]["state"] == "ok" and h["state"] == "ready"
    assert doc["health"]["slo"]["objectives"][1]["p99_ms"] > 0
    names = [e["event"] for e in recorder.snapshot()]
    assert names[-1] == "serving.drain"


def test_slo_breach_degrades_health_and_recovers(dense):
    """An injected ``serving.model`` sleep breaches a latency objective:
    ``health()`` degrades naming it and ``slo.breach`` is emitted; once
    the window holds fast requests only, ``slo.recovered``."""
    from sparkdl_tpu_torch import faults

    module, x = dense
    tracer, recorder, ledger, _ = _obs_on()
    slos = [SLO("p99-fast", "latency", series="serving.request_latency",
                threshold_ms=250.0)]
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=1,
                bucket_sizes=[4], cache=False, slos=slos,
                cost=ledger) as srv:
        srv.predict(x[0])
        assert srv.health()["slo"]["state"] == "ok"
        with faults.active(faults.FaultPlan.parse(
                "serving.model:sleep:ms=350,times=1")):
            srv.predict(x[1])
        h = srv.health()
        assert h["slo"]["state"] == "breach" and h["state"] == "degraded"
        assert h["last_error"]["type"] == "SLOViolation"
        assert "p99-fast" in h["last_error"]["error"]
        srv.metrics.reset_series()
        srv.predict(x[2])
        h = srv.health()
        assert h["slo"]["state"] == "ok" and h["state"] == "ready"
    # the fast request's served batch notes ready before the poll that
    # sees the objective recover, as in the JAX server
    events = [e["event"] for e in recorder.snapshot()
              if e["event"].startswith(("slo.", "fault.", "health."))]
    assert events == ["fault.fired", "slo.breach", "health.degraded",
                      "health.ready", "slo.recovered"]


def test_topoff_and_drain_events(dense):
    module, x = dense
    _, recorder, _, _ = _obs_on()
    srv = Server(_pfn, module, max_batch_size=8, max_wait_ms=10_000,
                 bucket_sizes=[8], cache=False, ragged=True)
    try:
        reqs = [Request(x[i]) for i in range(2)]
        for r in reqs:
            srv._batcher.submit(r)
        pulled = srv._top_off(6, 8, 2, x[0])
        assert pulled == reqs
        assert srv.metrics.counters["serving.topoff_rows"] == 2
    finally:
        srv.close(drain=False)
    got = [(e["event"], e.get("attrs")) for e in recorder.snapshot()
           if e["event"] in ("batch.topoff", "serving.drain")]
    assert got == [("batch.topoff", {"rows": 2, "base": 2, "bucket": 8}),
                   ("serving.drain", {"drain": False, "queued": 0})]


def test_topped_off_requests_join_the_batch_span(dense):
    """Late arrivals a ragged batch pulls in at top-off ride its span as
    members, so their traces reach the dispatch too."""
    module, x = dense
    tracer, recorder, _, _ = _obs_on()
    late = []
    # the late three wait on the age flush (100 ms) long after the pull
    with Server(_pfn, module, max_batch_size=8, max_wait_ms=100,
                bucket_sizes=[8], cache=False, ragged=True) as srv:
        real = srv._top_off

        def top_off(gap, bucket, base, like):
            if not late:  # three requests arrive just before the pull
                late.extend(srv.submit(x[i]) for i in (1, 2, 3))
            return real(gap, bucket, base, like)

        srv._top_off = top_off
        first = srv.submit(x[0]).result(timeout=30)
        rows = [f.result(timeout=30) for f in late]
    np.testing.assert_array_equal(np.stack([first] + rows),
                                  InferenceEngine(_pfn, module,
                                                  device_batch_size=8)(x[:4]))
    spans = tracer.snapshot()
    batch = [s for s in spans if s["name"] == "serving.microbatch"]
    assert len(batch) == 1
    assert batch[0]["attrs"]["topped_off"] == 3
    assert batch[0]["attrs"]["batch_size"] == 4
    chains = _request_chains(spans)
    assert len(chains) == 4 and all(chains.values())
    assert [e["attrs"]["rows"] for e in recorder.snapshot()
            if e["event"] == "batch.topoff"] == [3]


def test_cached_server_under_observability(dense):
    """Hits and coalesced followers: cache events, the ledger's per-tenant
    hit lines, and rows equal to the uncached server's."""
    module, x = dense
    _, recorder, ledger, slos = _obs_on()
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=5,
                bucket_sizes=[4], cache=InferenceCache(), cost=ledger,
                slos=slos) as srv:
        first = [srv.submit(x[i % 3], tenant=f"t{i}").result(timeout=30)
                 for i in range(6)]
    _obs_off()
    with Server(_pfn, module, max_batch_size=4, max_wait_ms=5,
                bucket_sizes=[4], cache=False) as srv:
        plain = [srv.predict(x[i % 3]) for i in range(6)]
    np.testing.assert_array_equal(np.stack(first), np.stack(plain))
    snap = ledger.snapshot()
    assert snap["totals"]["hits"] == 3 and snap["totals"]["rows"] == 3
    names = [e["event"] for e in recorder.snapshot()
             if e["event"].startswith("cache.")]
    assert names.count("cache.miss") == 3 and names.count("cache.hit") == 3


def test_pipelined_runner_spans_nest_and_outputs_match(dense):
    module, x = dense
    _obs_off()
    eng = InferenceEngine(_pfn, module, device_batch_size=8)
    off = eng(x, pipeline=True)
    tracer = ptrace.configure(enabled=True)
    on = eng(x, pipeline=True)
    np.testing.assert_array_equal(on, off)
    spans = tracer.snapshot()
    by_id = {s["span_id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("engine.call") == 1 and \
        names.count("pipeline.run") == 1
    run = next(s for s in spans if s["name"] == "pipeline.run")
    assert by_id[run["parent_id"]]["name"] == "engine.call"
    pieces = -(-len(x) // 8)
    for stage in ("pipeline.dispatch", "pipeline.gather"):
        stage_spans = [s for s in spans if s["name"] == stage]
        assert len(stage_spans) == pieces
        assert all(s["parent_id"] == run["span_id"] for s in stage_spans)
    dispatches = [s for s in spans if s["name"] == "engine.dispatch"]
    assert len(dispatches) == pieces and all(
        by_id[d["parent_id"]]["name"] == "pipeline.dispatch"
        for d in dispatches)
    # the CPU makes no timing events: no device_ms anywhere
    assert not any("device_ms" in (s.get("attrs") or {}) for s in spans)
    assert _assert_child_within_parent(spans) >= 3 * pieces


def test_head_fanout_under_observability():
    """``HeadFanoutServer(cost=)`` with the recorder: ``head.swap`` per
    mutation, ``cache.feature_hit`` per warm request, and per-tenant cost
    lines (rows for cold requests, feature hits for warm ones) in
    ``varz()["cost"]``."""
    rng = np.random.default_rng(0)
    module = head_fanout_module(
        {"backbone": rng.normal(size=(12, 16)).astype(np.float32)})
    heads = {f"t{k}": {"kernel": rng.normal(size=(16, 4)).astype(
        np.float32), "bias": rng.normal(size=(4,)).astype(np.float32)}
        for k in range(3)}
    payloads = [rng.normal(size=(12,)).astype(np.float32) for _ in range(4)]
    _, recorder, ledger, _ = _obs_on()
    with HeadFanoutServer(head_fanout_backbone_fn, module,
                          cache=InferenceCache(), cost=ledger,
                          model_desc="standin", max_batch_size=4,
                          max_wait_ms=2, bucket_sizes=[4]) as srv:
        assert srv.cost is ledger
        for t, h in heads.items():
            srv.add_head(t, h)
        cold = [srv.predict(p, "t0") for p in payloads]
        warm = [srv.predict(p, f"t{1 + i % 2}") for i, p in
                enumerate(payloads)]
        srv.swap_head("t0", heads["t1"])
        batch = srv.predict_batch(payloads[:2], ["t0", "t2"])
        doc = srv.varz()
    json.dumps(doc)
    assert all(np.isfinite(r).all() for r in cold + warm + batch)
    swaps = [(e["attrs"]["tenant"], e["attrs"]["op"])
             for e in recorder.snapshot() if e["event"] == "head.swap"]
    assert swaps == [("t0", "add"), ("t1", "add"), ("t2", "add"),
                     ("t0", "swap")]
    hits = [e["attrs"]["tenant"] for e in recorder.snapshot()
            if e["event"] == "cache.feature_hit"]
    assert hits == ["t1", "t2", "t1", "t2", "t0", "t2"]
    cost = doc["cost"]
    assert cost == ledger.snapshot()
    assert cost["tenants"]["t0"]["rows"] == 4
    assert cost["tenants"]["t0"]["feature_hits"] == 1
    assert cost["tenants"]["t1"]["feature_hits"] == 2
    assert cost["tenants"]["t2"]["feature_hits"] == 3
    assert list(cost["programs"]) == ["standin/b4"]


# -- a 96x96 zoo Xception, served under observability ----------------------

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


def test_zoo_xception_served_under_observability_matches_jax(zoo):
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    order = rng.permutation(len(imgs))
    kw = dict(featurize=True, max_batch_size=8, bucket_sizes=[8],
              max_wait_ms=200, cache=False)
    _obs_off()
    with jserving.Server("Xception", **kw) as jsrv:
        futs = {int(i): jsrv.submit(imgs[int(i)]) for i in order}
        want = np.stack([np.asarray(futs[i].result(60))
                         for i in range(len(imgs))])
    with Server("Xception", **kw) as srv:
        futs = {int(i): srv.submit(imgs[int(i)]) for i in order}
        off = np.stack([futs[i].result(60) for i in range(len(imgs))])
    tracer, recorder, ledger, slos = _obs_on()
    with Server("Xception", cost=ledger, slos=slos, **kw) as srv:
        futs = {int(i): srv.submit(imgs[int(i)], tenant=f"t{int(i) % 3}")
                for i in order}
        on = np.stack([futs[i].result(60) for i in range(len(imgs))])
        doc = srv.varz()
    assert on.shape == (8, 2048) and np.isfinite(on).all()
    np.testing.assert_array_equal(on, off)
    np.testing.assert_allclose(on, want, **ZOO_TOL)
    chains = _request_chains(tracer.snapshot())
    assert len(chains) == 8 and all(chains.values())
    json.dumps(doc)
    # the default ledger reads the port's program lockfile, as JAX's reads
    # its own: the zoo program's name and its FLOPs a row
    assert list(doc["cost"]["programs"]) == [
        "zoo/Xception/featurize/bfloat16/b8"]
    assert doc["cost"]["tenants"]["t0"]["flops"] > 0
    assert doc["cost"]["totals"]["rows"] == 8
    assert doc["cost"]["tenants"]["t0"]["hbm_bytes_s"] > 0
    assert doc["exemplars"] and doc["health"]["slo"]["state"] == "ok"
