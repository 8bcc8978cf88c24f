"""The port's flight recorder (``sparkdl_tpu_torch.obs.flight``) and its
instrumentation sites held against the JAX package's, on the CPU.

The event vocabulary equals JAX's key for key; the same ``emit`` sequence
gives equal snapshots apart from the clocks; unknown names are refused as
JAX refuses them; the ``SPARKDL_BLACKBOX`` grammar, the bounded ring, the
incremental dump and the ready->degraded dump behave alike.  The atexit
and SIGTERM dumps (with the previous handler chained, or an ignored
SIGTERM kept ignored) and the ``SPARKDL_TRACE=<dir>`` flush run in
subprocesses, never in the pytest process.  Then the wired sites, each
driven the same way on both sides with both recorders on: the result
cache's events, the circuit breaker's, ``retry.attempt``, ``fault.fired``,
``health.*``, the batcher's ``serving.shed`` (queue full, and a deadline
under an injected clock) and the head bank's ``head.swap``.
"""

import glob
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from sparkdl_tpu import faults as jfaults
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.obs import trace as jtrace
from sparkdl_tpu.obs import export as jexport
from sparkdl_tpu.parallel import engine as jengine
from sparkdl_tpu.serving import batcher as jbatcher
from sparkdl_tpu.serving import cache as jcache
from sparkdl_tpu.utils import health as jhealth
from sparkdl_tpu.utils import retry as jretry
import sparkdl_tpu_torch
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.obs import cost as pcost
from sparkdl_tpu_torch.obs import export as pexport
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs import trace as ptrace
from sparkdl_tpu_torch.obs.flight import FlightRecorder
from sparkdl_tpu_torch.parallel import engine as pengine
from sparkdl_tpu_torch.serving import batcher as pbatcher
from sparkdl_tpu_torch.serving import cache as pcache
from sparkdl_tpu_torch.utils import health as phealth
from sparkdl_tpu_torch.utils import retry as pretry
from sparkdl_tpu_torch.utils.jsonl import read_jsonl, recover_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCKS = ("t_wall", "t_mono", "seq")


@pytest.fixture(autouse=True)
def _restore_obs(monkeypatch):
    """Each test leaves both packages' tracer, recorder and default ledger
    as it found them, and no fault plan behind."""
    from sparkdl_tpu.obs import cost as jcost

    for mod, name in ((ptrace, "_tracer"), (jtrace, "_tracer"),
                      (pflight, "_recorder"), (jflight, "_recorder"),
                      (pcost, "_default"), (jcost, "_default")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    pfaults.clear()
    jfaults.clear()
    yield
    pfaults.clear()
    jfaults.clear()


@pytest.fixture
def recorders():
    """Both recorders on, in memory only (no directory: no atexit or
    signal hook is installed in the pytest process)."""
    return pflight.configure(enabled=True), jflight.configure(enabled=True)


def _strip(events):
    return [{k: v for k, v in e.items() if k not in CLOCKS}
            for e in events]


def _names_attrs(recorder, prefix=""):
    return [(e["event"], e.get("attrs")) for e in recorder.snapshot()
            if e["event"].startswith(prefix)]


# -- the recorder ------------------------------------------------------------

def test_vocabulary_equals_jax_key_for_key():
    assert pflight.EVENT_HELP == jflight.EVENT_HELP
    assert pflight.EVENTS == jflight.EVENTS
    assert set(pflight.__all__) == set(jflight.__all__)


@pytest.mark.parametrize("name", ["breaker.opened", "", "fleet.shed ",
                                  "serving.request"])
def test_unknown_event_names_refused_like_jax(recorders, name):
    prec, jrec = recorders
    with pytest.raises(ValueError) as perr:
        pflight.emit(name, x=1)
    with pytest.raises(ValueError) as jerr:
        jflight.emit(name, x=1)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        prec.record(name)
    assert len(prec) == 0


@pytest.mark.parametrize("raw", ["", "0", "false", "OFF", "no", "1", "true",
                                 "ON", "yes", "/tmp/some/dir", " on "])
def test_blackbox_env_grammar_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("SPARKDL_BLACKBOX", raw)
    assert pflight.blackbox_from_env() == jflight.blackbox_from_env()


def test_same_emits_give_equal_snapshots(recorders):
    """One sequence of emits, with scalars, None, a numpy scalar and an
    exception as attrs: equal snapshots apart from the clocks, trace ids
    included (both tracers on, inside a span on each side)."""
    prec, jrec = recorders
    seq = [("breaker.open", dict(consecutive=3, cooldown_s=0.5,
                                 error="InjectedTransientError")),
           ("serving.shed", dict(reason="queue_full", depth=np.int64(4),
                                 retry_after_s=0.01)),
           ("cache.miss", {}),
           ("slo.breach", dict(slo="p99", burn=None)),
           ("fault.fired", dict(site="serving.model",
                                rule="serving.model:error",
                                action=ValueError("bad"), call=2))]
    ptr = ptrace.configure(enabled=True)
    jtr = jtrace.configure(enabled=True)
    for name, attrs in seq:
        pflight.emit(name, **attrs)
        jflight.emit(name, **attrs)
    with ptr.span("p"), jtr.span("j"):
        pflight.emit("health.degraded", tracker="t", error="E")
        jflight.emit("health.degraded", tracker="t", error="E")
    got, want = prec.snapshot(), jrec.snapshot()
    assert _strip(got) == _strip(want)
    assert [e["seq"] for e in got] == list(range(1, len(seq) + 2))
    assert got[-1]["trace_id"] == want[-1]["trace_id"] is not None
    # anything but a Python scalar is stringified at emit time
    assert got[1]["attrs"]["depth"] == "4"
    assert got[4]["attrs"]["action"] == "bad"
    assert all(e["t_mono"] <= f["t_mono"] for e, f in zip(got, got[1:]))


def test_disabled_path_records_nothing(monkeypatch):
    monkeypatch.delenv("SPARKDL_BLACKBOX", raising=False)
    monkeypatch.setattr(pflight, "_recorder", pflight._UNSET)
    assert pflight.emit("breaker.open") is None
    assert pflight._recorder is None and pflight.get_recorder() is None
    assert pflight.configure(enabled=False) is None
    assert pflight.emit("not.an.event") is None  # never validated when off


def test_ring_bounded_seq_monotonic_and_snapshot_copies():
    rec = FlightRecorder(capacity=4)
    jrec = jflight.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("retry.attempt", {"attempt": i})
        jrec.record("retry.attempt", {"attempt": i})
    snap = rec.snapshot()
    assert len(rec) == 4 and [e["seq"] for e in snap] == [7, 8, 9, 10]
    assert _strip(snap) == _strip(jrec.snapshot())
    snap[0]["event"] = "mutated"
    assert rec.snapshot()[0]["event"] == "retry.attempt"


def test_incremental_dump_each_event_once_and_export(tmp_path):
    rec = FlightRecorder(out_dir=str(tmp_path))
    rec.record("breaker.open", {"consecutive": 3})
    rec.record("serving.shed", {"reason": "queue_full"})
    p = rec.dump()
    assert p and os.path.basename(p) == f"flight_{os.getpid()}.jsonl"
    rec.record("breaker.close")
    assert rec.dump() == p
    events = pflight.load_flight(p)
    assert [e["event"] for e in events] == [
        "breaker.open", "serving.shed", "breaker.close"]
    assert events == jflight.load_flight(p)
    exp = str(tmp_path / "export.jsonl")
    assert rec.dump(exp) == exp
    assert pflight.load_flight(exp) == events
    rec.close()
    assert FlightRecorder().dump() is None  # no directory: nothing to do


def test_degraded_transition_dumps_durably(tmp_path, monkeypatch):
    """ready->degraded dumps synchronously: the recorder is installed
    directly (``configure(out_dir=)`` would hook SIGTERM here)."""
    rec = FlightRecorder(out_dir=str(tmp_path))
    monkeypatch.setattr(pflight, "_recorder", rec)
    t = phealth.HealthTracker("serving.health")
    t.note_failure(RuntimeError("device dead"))
    files = glob.glob(str(tmp_path / "flight_*.jsonl"))
    assert len(files) == 1
    events = pflight.load_flight(files[0])
    assert events[-1]["event"] == "health.degraded"
    assert events[-1]["attrs"] == {"tracker": "serving.health",
                                   "error": "RuntimeError"}
    t.note_success()
    assert [e["event"] for e in rec.snapshot()] == ["health.degraded",
                                                    "health.ready"]
    rec.close()


def _child(code, env_extra, tmp_path, timeout=120):
    env = dict(os.environ, **env_extra)
    env.pop("SPARKDL_FAULTS", None)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, timeout=timeout)


def test_sigterm_dumps_then_chains_the_previous_handler(tmp_path):
    """A process that installed its own SIGTERM handler keeps it: the
    recorder dumps, then hands the signal on to it."""
    code = r"""
import os, signal, sys
def mine(signum, frame):
    print("previous handler ran", flush=True)
    sys.exit(7)
signal.signal(signal.SIGTERM, mine)
from sparkdl_tpu_torch.obs import flight
flight.emit("breaker.open", error="X")
flight.emit("serving.shed", reason="queue_full")
os.kill(os.getpid(), signal.SIGTERM)
"""
    proc = _child(code, {"SPARKDL_BLACKBOX": str(tmp_path)}, tmp_path)
    assert proc.returncode == 7, proc.stderr.decode()
    assert b"previous handler ran" in proc.stdout
    files = glob.glob(str(tmp_path / "flight_*.jsonl"))
    assert len(files) == 1
    assert [e["event"] for e in pflight.load_flight(files[0])] == [
        "breaker.open", "serving.shed"]


def test_sigterm_default_disposition_still_terminates(tmp_path):
    code = r"""
import os, signal
from sparkdl_tpu_torch.obs import flight
flight.emit("serving.drain", drain=True, queued=0)
os.kill(os.getpid(), signal.SIGTERM)
"""
    proc = _child(code, {"SPARKDL_BLACKBOX": str(tmp_path)}, tmp_path)
    assert proc.returncode == -signal.SIGTERM, proc.stderr.decode()
    (path,) = glob.glob(str(tmp_path / "flight_*.jsonl"))
    assert [e["event"] for e in pflight.load_flight(path)] == [
        "serving.drain"]


def test_ignored_sigterm_stays_ignored_and_atexit_dumps(tmp_path):
    """SIG_IGN before the recorder: SIGTERM dumps and is still ignored;
    the process exits normally and the atexit hook appends the events
    emitted after the signal, each event on disk once."""
    code = r"""
import os, signal
signal.signal(signal.SIGTERM, signal.SIG_IGN)
from sparkdl_tpu_torch.obs import flight
flight.emit("breaker.open", error="X")
os.kill(os.getpid(), signal.SIGTERM)
flight.emit("breaker.close")
print("survived", flush=True)
"""
    proc = _child(code, {"SPARKDL_BLACKBOX": str(tmp_path)}, tmp_path)
    assert proc.returncode == 0 and b"survived" in proc.stdout, \
        proc.stderr.decode()
    (path,) = glob.glob(str(tmp_path / "flight_*.jsonl"))
    records, discarded = recover_jsonl(path)
    assert discarded == 0
    assert [e["event"] for e in records] == ["breaker.open",
                                             "breaker.close"]
    assert read_jsonl(path)[0] == records


def test_sigkill_mid_incident_leaves_a_recoverable_dump(tmp_path):
    code = r"""
import os, signal
from sparkdl_tpu_torch.obs import flight
from sparkdl_tpu_torch.utils.health import HealthTracker
flight.emit("breaker.open", consecutive=2, error="InjectedDeadDeviceError")
HealthTracker("serving.health").note_failure(RuntimeError("dead"))
with open(flight.get_recorder().dump(), "ab") as fh:
    fh.write(b'{"seq": 999, "event": "health.re')
    fh.flush(); os.fsync(fh.fileno())
os.kill(os.getpid(), signal.SIGKILL)
"""
    proc = _child(code, {"SPARKDL_BLACKBOX": str(tmp_path)}, tmp_path)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    (path,) = glob.glob(str(tmp_path / "flight_*.jsonl"))
    records, discarded = recover_jsonl(path)
    assert discarded > 0
    assert [r["event"] for r in records] == ["breaker.open",
                                             "health.degraded"]


def test_trace_dir_flushes_both_artifacts_at_exit(tmp_path):
    """``SPARKDL_TRACE=<dir>``: a process serving on the CPU leaves
    ``trace_<pid>.json`` and ``spans_<pid>.jsonl`` at exit, which the
    port's ``load_spans`` reads back (each form, and the directory) as
    the JAX package's reads them."""
    code = r"""
import os
import numpy as np, torch
from sparkdl_tpu_torch.serving import Server
with Server(lambda m, x: torch.tanh(x * 2.0), device="cpu",
            max_batch_size=4, bucket_sizes=[4], cache=False) as srv:
    for i in range(6):
        srv.predict(np.full(3, i, np.float32))
print(os.getpid(), flush=True)
"""
    proc = _child(code, {"SPARKDL_TRACE": str(tmp_path)}, tmp_path)
    assert proc.returncode == 0, proc.stderr.decode()
    pid = int(proc.stdout.split()[-1])
    chrome = tmp_path / f"trace_{pid}.json"
    jsonl = tmp_path / f"spans_{pid}.jsonl"
    assert chrome.exists() and jsonl.exists()
    spans = pexport.load_spans(str(jsonl))
    assert spans == jexport.load_spans(str(jsonl))
    assert pexport.load_spans(str(tmp_path)) == spans
    names = {s["name"] for s in spans}
    assert {"serving.request", "serving.microbatch", "engine.call",
            "engine.dispatch"} <= names
    assert sum(s["name"] == "serving.request" for s in spans) == 6
    from_chrome = pexport.load_spans(str(chrome))
    assert from_chrome == jexport.load_spans(str(chrome))
    assert [(s["name"], s["span_id"], s["parent_id"]) for s in from_chrome] \
        == [(s["name"], s["span_id"], s["parent_id"]) for s in spans]


# -- the wired sites, held to JAX ---------------------------------------------

def test_cache_events_match_jax(recorders):
    """Miss (leader), follower, settle with an eviction, hits, a corrupt
    entry invalidated, a key and a namespace invalidated."""
    prec, jrec = recorders
    value = {"y": np.arange(6, dtype=np.float32)}
    for mod in (pcache, jcache):
        c = mod.InferenceCache(max_entries=2, max_bytes=1 << 20)
        kind, leader = c.lookup(("ns", "a"))
        assert kind == "leader"
        assert c.lookup(("ns", "a"))[0] == "follower"
        assert c.lookup(("ns", "a"))[0] == "follower"
        c.settle(leader, value)
        assert c.lookup(("ns", "a"))[0] == "hit"
        for key in ("b", "c"):
            c.settle(c.lookup(("ns", key))[1], value)   # "a" evicted
        assert c.get(("ns", "b")) is not None
        c.invalidate_key(("ns", "b"))
        c.invalidate(("ns",))
    faults = {"p": pfaults, "j": jfaults}
    for side, mod in (("p", pcache), ("j", jcache)):
        c = mod.InferenceCache()
        c.settle(c.lookup(("k",))[1], value)
        with faults[side].active(faults[side].FaultPlan.parse(
                "cache.hit:error:times=1")):
            assert c.lookup(("k",))[0] == "leader"   # corrupt -> miss
    got = _names_attrs(prec, "cache.")
    assert got == _names_attrs(jrec, "cache.")
    assert [n for n, _ in got] == [
        "cache.miss", "cache.coalesced", "cache.coalesced", "cache.hit",
        "cache.miss", "cache.miss", "cache.evict", "cache.hit",
        "cache.invalidate", "cache.invalidate",
        "cache.miss", "cache.invalidate", "cache.miss"]


def test_breaker_events_match_jax(recorders):
    prec, jrec = recorders
    for mod in (pengine, jengine):
        b = mod.DispatchCircuitBreaker(threshold=2, cooldown_s=0.0)
        b.record_failure(RuntimeError("x"))
        assert b.record_failure(RuntimeError("y"))          # opens
        b.gate()                                            # half-open trial
        b.record_failure(RuntimeError("z"))                 # re-opens
        b.gate()
        b.record_success()                                  # closes
        b.record_failure(ValueError("deterministic"))       # never counts
        b.record_success()                                  # already closed
    got = _names_attrs(prec, "breaker.")
    assert got == _names_attrs(jrec, "breaker.")
    assert [n for n, _ in got] == ["breaker.open", "breaker.half_open",
                                   "breaker.open", "breaker.half_open",
                                   "breaker.close"]


def test_retry_attempt_events_match_jax(recorders):
    prec, jrec = recorders
    for mod in (pretry, jretry):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return "ok"

        assert mod.with_retries(flaky, max_retries=3) == "ok"
        with pytest.raises(RuntimeError):
            mod.with_retries(lambda: (_ for _ in ()).throw(
                RuntimeError("always")), max_retries=1)
    got = _names_attrs(prec, "retry.")
    assert got == _names_attrs(jrec, "retry.")
    assert got == [("retry.attempt", {"attempt": 1, "of": 4,
                                      "error": "RuntimeError"}),
                   ("retry.attempt", {"attempt": 2, "of": 4,
                                      "error": "RuntimeError"}),
                   ("retry.attempt", {"attempt": 1, "of": 2,
                                      "error": "RuntimeError"})]


def test_fault_fired_events_match_jax(recorders):
    prec, jrec = recorders
    spec = ("seed=4;serving.model:error:every=2;"
            "engine.dispatch:sleep:ms=1,times=2")
    for faults in (pfaults, jfaults):
        with faults.active(faults.FaultPlan.parse(spec)):
            for _ in range(4):
                for site in ("serving.model", "engine.dispatch"):
                    try:
                        faults.inject(site)
                    except Exception:  # noqa: BLE001 — the injected error
                        pass
    got = _names_attrs(prec, "fault.")
    assert got == _names_attrs(jrec, "fault.")
    assert len(got) == 4 and {a["site"] for _, a in got} == {
        "serving.model", "engine.dispatch"}


def test_health_events_match_jax(recorders):
    prec, jrec = recorders
    for mod in (phealth, jhealth):
        t = mod.HealthTracker("serving.health", name="owner")
        t.note_success()                       # already ready: no event
        t.note_failure(RuntimeError("a"))
        t.note_failure(KeyError("b"))          # same episode: no event
        t.note_success()
    got = _names_attrs(prec, "health.")
    assert got == _names_attrs(jrec, "health.")
    assert got == [("health.degraded", {"tracker": "owner",
                                        "error": "RuntimeError"}),
                   ("health.ready", {"tracker": "owner"})]
    assert phealth.HealthTracker().name == "health"


def test_batcher_shed_events_match_jax(recorders):
    """Queue full, and deadlines expired at flush under an injected
    clock: the same ``serving.shed`` events; the shed request's root span
    closes with status ``shed``."""
    prec, jrec = recorders
    tracers = {"p": ptrace.configure(enabled=True),
               "j": jtrace.configure(enabled=True)}
    for side, mod in (("p", pbatcher), ("j", jbatcher)):
        now = [100.0]
        b = mod.DynamicBatcher(max_batch_size=4, max_wait_ms=5, max_queue=2,
                               clock=lambda: now[0])
        reqs = [mod.Request(np.zeros(2), deadline=100.001, now=100.0),
                mod.Request(np.ones(2), deadline=None, now=100.0)]
        for r in reqs:
            r.span = tracers[side].start_span("serving.request")
            b.submit(r)
        with pytest.raises(Exception, match="queue full"):
            b.submit(mod.Request(np.ones(2), now=100.0))
        now[0] = 100.5
        live = b.next_batch()
        assert live == [reqs[1]] and reqs[0].future.exception() is not None
        assert live[0].batch_span is not None
        live[0].batch_span.finish()
        b.close(drain=False)
    got = _names_attrs(prec, "serving.")
    assert got == _names_attrs(jrec, "serving.")
    assert [a["reason"] for _, a in got] == ["queue_full", "deadline"]
    spans = tracers["p"].snapshot()
    assert [(s["name"], s["status"]) for s in spans] == [
        ("serving.request", "shed"), ("serving.microbatch", "ok")]
    assert spans[1]["parent_id"] == reqs[1].span.span_id
    assert spans[1]["attrs"]["member_traces"] == [reqs[1].span.trace_id]


def test_head_swap_events_match_jax(recorders):
    prec, jrec = recorders
    rng = np.random.default_rng(0)
    heads = [{"kernel": rng.normal(size=(4, 3)).astype(np.float32),
              "bias": rng.normal(size=(3,)).astype(np.float32)}
             for _ in range(3)]
    with sparkdl_tpu_torch.default_device("cpu"):
        pbank = pengine.HeadBank()
    jbank = jengine.HeadBank()
    for bank in (pbank, jbank):
        bank.add_head("a", heads[0])
        bank.add_head("b", heads[1])
        bank.swap_head("a", heads[2])
        bank.remove_head("b")
        with pytest.raises(KeyError):
            bank.swap_head("zz", heads[0])    # refused: no event
    got = _names_attrs(prec, "head.")
    assert got == _names_attrs(jrec, "head.")
    assert [(a["tenant"], a["op"], a["tenants"]) for _, a in got] == [
        ("a", "add", 1), ("b", "add", 2), ("a", "swap", 2),
        ("b", "remove", 1)]
