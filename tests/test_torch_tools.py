"""The port's artifact tools held against the JAX package's, on the CPU.

``tools/port_trace_summary.py`` and ``tools/port_blackbox.py`` read the
same artifacts as ``tools/trace_summary.py`` and ``tools/blackbox.py``
(the dump, span and journal formats are shared): on span JSONL and Chrome
traces and on flight dumps written by EITHER package, from the same
breaker incident through each package's ``Fleet``, they give the same
``summarize`` dict and ``render`` text, the same ``build_timeline``
document and the same exit codes (0 clean, 1 unresolved, 2 corrupt).
``tools/port_dryrun.py`` writes the JAX dryrun's stage records (keys,
status order, the ``faults`` stamp) with its own stages;
``tools/costreport.py`` (standard library only, shared) reads the
``varz()`` cost sections of the port's ``Server``, ``HeadFanoutServer``
and ``Fleet`` and exits 1 exactly while a ``cost.regression`` is open.
Every port object runs under ``default_device("cpu")``; both packages'
tracer and recorder globals are restored after each test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (the conftest keeps it on the CPU)

import sparkdl_tpu.serving as jserving
import sparkdl_tpu_torch
from sparkdl_tpu import faults as jfaults
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.obs import trace as jtrace
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs import trace as ptrace
from sparkdl_tpu_torch.obs.cost import CostLedger
from tools import blackbox, dryrun, port_blackbox, port_dryrun
from tools import port_trace_summary, trace_summary

from test_torch_fleet import Dense, _incident, _jfn, _pfn, _sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MISSING = "/nonexistent/PROGRAMS.lock.json"


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both packages' tracers and recorders come back as they were, and no
    fault plan leaks between tests."""
    for mod, name in ((pflight, "_recorder"), (jflight, "_recorder"),
                      (ptrace, "_tracer"), (jtrace, "_tracer")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    pfaults.clear()
    jfaults.clear()
    yield
    pfaults.clear()
    jfaults.clear()


def _weights():
    rng = np.random.default_rng(17)
    w1 = {"w": rng.normal(size=(6, 4)).astype(np.float32)}
    w2 = {"w": rng.normal(size=(6, 4)).astype(np.float32)}
    return w1, w2, rng.normal(size=(6,)).astype(np.float32)


@pytest.fixture(scope="module")
def incidents(tmp_path_factory):
    """The breaker incident of ``tests/test_torch_fleet.py`` through each
    package's Fleet, with tracing on: each package's flight dump and its
    flushed trace (``spans_<pid>.jsonl`` and ``trace_<pid>.json``)."""
    base = tmp_path_factory.mktemp("incidents")
    w1, w2, x = _weights()
    saved = (pflight._recorder, jflight._recorder, ptrace._tracer,
             jtrace._tracer)
    out = {}
    try:
        with sparkdl_tpu_torch.default_device("cpu"):
            for pkg, flight_mod, trace_mod, run in (
                    ("jax", jflight, jtrace, lambda: _incident(
                        jserving, jfaults, _jfn, (w1, w2), x)),
                    ("port", pflight, ptrace, lambda: _incident(
                        sparkdl_tpu_torch.serving, pfaults, _pfn,
                        (Dense(w1["w"]), _sd(w2)), x))):
                rec = flight_mod.FlightRecorder(out_dir=str(base / pkg))
                tracer = trace_mod.Tracer(enabled=True)
                flight_mod._recorder, trace_mod._tracer = rec, tracer
                shed, state = run()
                assert (shed, state) == (1, "ready")
                dump = rec.dump()
                rec.close()
                chrome, jsonl = tracer.flush(str(base / pkg / "trace"))
                out[pkg] = dict(flight=dump, chrome=chrome, jsonl=jsonl,
                                trace_dir=str(base / pkg / "trace"))
    finally:
        (pflight._recorder, jflight._recorder, ptrace._tracer,
         jtrace._tracer) = saved
    return out


# -- trace_summary -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["jsonl", "chrome", "trace_dir"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_summary_matches_jax(incidents, writer, kind, capsys):
    """The same per-stage dict and table from either package's span JSONL,
    Chrome trace or trace directory, under every sort and a wall span."""
    from sparkdl_tpu.obs.export import load_spans as jload
    from sparkdl_tpu_torch.obs.export import load_spans as pload

    path = incidents[writer][kind]
    spans = pload(path)
    assert spans == jload(path) and len(spans) > 10
    for wall in (None, "fleet.request"):
        want = trace_summary.summarize(jload(path), wall_span=wall)
        got = port_trace_summary.summarize(spans, wall_span=wall)
        assert got == want
        for sort in ("total", "count", "p99"):
            assert (port_trace_summary.render(got, sort)
                    == trace_summary.render(want, sort))
    for argv in ([path], [path, "--sort", "p99"],
                 [path, "--wall-span", "fleet.request"]):
        assert trace_summary.main(argv) == 0
        want = capsys.readouterr().out
        assert port_trace_summary.main(argv) == 0
        assert capsys.readouterr().out == want


def test_trace_summary_exit_codes_and_cli(tmp_path, incidents, capsys):
    """No spans: both exit 1; an unknown ``--wall-span``: both stop with
    the same message; the script runs on its own from the checkout."""
    empty = tmp_path / "spans_1.jsonl"
    empty.write_text("")
    assert trace_summary.main([str(empty)]) == 1
    assert port_trace_summary.main([str(empty)]) == 1
    path = incidents["port"]["jsonl"]
    with pytest.raises(SystemExit) as want:
        trace_summary.main([path, "--wall-span", "nope"])
    with pytest.raises(SystemExit) as got:
        port_trace_summary.main([path, "--wall-span", "nope"])
    assert str(got.value) == str(want.value)
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "port_trace_summary.py"),
         path, "--sort", "count"], capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert trace_summary.main([path, "--sort", "count"]) == 0
    assert proc.stdout == capsys.readouterr().out


# -- blackbox ----------------------------------------------------------------

def _journal(path, pending):
    """A streaming journal: chunks 0 and 1 committed, and with
    ``pending`` chunk 2's intent and output without their commit."""
    recs = []
    for k in range(2 + pending):
        recs.append({"rec": "intent", "chunk_id": f"c{k}", "offset": k})
        recs.append({"rec": "output", "chunk_id": f"c{k}", "offset": k,
                     "path": f"out/c{k}.npy"})
        if k < 2:
            recs.append({"rec": "commit", "chunk_id": f"c{k}", "offset": k})
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_blackbox_timeline_matches_jax(incidents, writer, tmp_path):
    """The same timeline document from either package's incident dump:
    alone, with its spans, narrowed to a trace id, with a clean and a
    pending journal; the incident's causal chain is in it, in order."""
    art = incidents[writer]
    clean = _journal(tmp_path / "clean.jsonl", 0)
    pending = _journal(tmp_path / "pending.jsonl", 1)
    want = blackbox.build_timeline(art["flight"])
    chain = want["chain"]
    assert [chain.index(n) for n in ("rollout.start", "breaker.open",
                                     "fleet.shed", "rollout.promote")] \
        == sorted(chain.index(n) for n in ("rollout.start", "breaker.open",
                                           "fleet.shed", "rollout.promote"))
    assert want["verdict"]["clean"] is True
    traced = next(e["trace_id"] for e in want["events"] if e["trace_id"])
    for kw in ({}, {"spans_path": art["jsonl"]},
               {"spans_path": art["trace_dir"]},
               {"spans_path": art["chrome"], "trace_id": traced},
               {"journal_path": clean}, {"journal_path": pending}):
        got = port_blackbox.build_timeline(art["flight"], **kw)
        assert got == blackbox.build_timeline(art["flight"], **kw), kw
    assert port_blackbox.build_timeline(
        art["flight"], spans_path=art["jsonl"])["correlated_events"] > 0


def test_blackbox_exit_codes_match_jax(incidents, tmp_path, capsys):
    """0 on the clean incident (a file and a directory of dumps from both
    packages), 1 with a replay pending or a tracker left degraded, 2 on a
    corrupt dump; the same text and ``--json`` document on stdout."""
    both = tmp_path / "dumps"
    both.mkdir()
    for pkg in ("jax", "port"):
        (both / f"flight_{pkg}.jsonl").write_text(
            open(incidents[pkg]["flight"]).read())
    rec = pflight.FlightRecorder()
    rec.record("breaker.open", {"error": "X"})
    rec.record("health.degraded", {"tracker": "serving.health"})
    unresolved = str(tmp_path / "unresolved.jsonl")
    rec.dump(unresolved)
    bad = tmp_path / "corrupt.jsonl"
    bad.write_text('{"seq": 1, "event": "breaker.open"}\n'
                   'not json at all\n'
                   '{"seq": 2, "event": "breaker.close"}\n')
    pending = _journal(tmp_path / "pending.jsonl", 1)
    cases = [([incidents["port"]["flight"]], 0),
             ([incidents["jax"]["flight"], "--spans",
               incidents["jax"]["trace_dir"]], 0),
             ([str(both), "--json"], 0),
             ([incidents["port"]["flight"], "--journal", pending], 1),
             ([unresolved, "--json"], 1),
             ([str(bad)], 2)]
    for argv, rc in cases:
        assert blackbox.main(argv) == rc, argv
        want = capsys.readouterr()
        assert port_blackbox.main(argv) == rc, argv
        got = capsys.readouterr()
        assert got.out == want.out, argv
        assert bool(got.err) == bool(want.err), argv
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "port_blackbox.py"),
         str(both), "--json"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == blackbox.build_timeline(str(both))


# -- dryrun ------------------------------------------------------------------

def test_dryrun_records_have_jax_keys_and_stage_order(tmp_path, capsys):
    """``port_dryrun --device cpu`` writes JAX's records: the same keys in
    each (started: stage, status, ts, faults; ok: seconds and the stage's
    detail; the summary), the same status order over entry, the
    multi-process stage and the summary, every line on stdout too; the
    entry's output is InceptionV3's [4, 2048] features."""
    from sparkdl_tpu.models import get_model_spec as jax_spec
    from sparkdl_tpu_torch.utils.jsonl import read_jsonl

    art = tmp_path / "port.jsonl"
    assert port_dryrun.main(["--device", "cpu", "--artifact",
                             str(art)]) == 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    got, _ = read_jsonl(str(art))
    assert printed == got
    ref = tmp_path / "jax.jsonl"
    log = dryrun.StageLog(str(ref))
    dryrun._run_stage(log, "entry", lambda: {"output_shape": [4, 2048]})
    dryrun._run_stage(log, "dryrun_multichip[2]", lambda: None)
    log.write(stage="summary", status="ok")
    want, _ = read_jsonl(str(ref))
    capsys.readouterr()
    assert [(r["stage"], r["status"]) for r in got] == [
        ("entry", "started"), ("entry", "ok"), ("ranks[2]", "started"),
        ("ranks[2]", "ok"), ("summary", "ok")]
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for g, w in zip(got, want):
        assert set(w) <= set(g), (g, w)
        assert g["faults"] == w["faults"] == "none"
    entry = got[1]
    assert entry["output_shape"] == [
        4, jax_spec("InceptionV3").feature_size]
    ranks = got[3]
    assert ranks["world"] == 2 and ranks["backend"] == "gloo"
    assert ranks["devices"] == ["cpu"]
    assert np.isfinite(ranks["loss"]) and len(ranks["two_step_losses"]) == 1


def test_dryrun_stamps_the_fault_plan_and_records_errors(tmp_path, capsys):
    """A record made under a fault plan carries the plan's spec, as JAX's
    does; a failing stage writes ``error`` with the exception, as JAX's."""
    from sparkdl_tpu_torch.utils.jsonl import read_jsonl

    spec = "seed=3;engine.dispatch:error:exc=dead,at=1"
    stamps = {}
    for mod, faults_mod, name in ((port_dryrun, pfaults, "port"),
                                  (dryrun, jfaults, "jax")):
        path = tmp_path / f"{name}.jsonl"
        log = mod.StageLog(str(path))
        with faults_mod.active(faults_mod.FaultPlan.parse(spec)):
            active = faults_mod.current_spec()
            assert mod._run_stage(log, "entry", lambda: 1 / 0) is False
        recs, _ = read_jsonl(str(path))
        assert [r["status"] for r in recs] == ["started", "error"]
        assert recs[1]["error"].startswith("ZeroDivisionError")
        assert {r["faults"] for r in recs} == {active}
        assert sorted(recs[1]) == ["error", "faults", "seconds", "stage",
                                   "status", "ts"]
        stamps[name] = active
    assert stamps["port"] == stamps["jax"]
    capsys.readouterr()


# -- costreport ----------------------------------------------------------------

def _costreport(path, *args):
    from tools.costreport import main

    return main([str(path), *args])


def test_costreport_reads_the_port_servers_varz(tmp_path, capsys):
    """The cost section of the port's ``Server``, ``HeadFanoutServer`` and
    ``Fleet`` ``varz()`` reads in ``tools/costreport.py``: exit 0 (no
    regression), the tenants' rows in the table and in ``--json``."""
    from sparkdl_tpu_torch.parallel.engine import (head_fanout_backbone_fn,
                                                   head_fanout_module)
    from sparkdl_tpu_torch.serving import Fleet, HeadFanoutServer, Server

    w1, _, x = _weights()
    rng = np.random.default_rng(3)
    kw = dict(max_batch_size=8, max_wait_ms=1)
    docs = {}
    with Server(_pfn, Dense(w1["w"]), model_desc="dense", bucket_sizes=[8],
                cost=CostLedger(lockfile_path=MISSING), **kw) as srv:
        for t in ("a", "b", "a"):
            srv.submit(x, tenant=t).result(timeout=60)
        docs["server"] = srv.varz()
    head = {"kernel": rng.normal(size=(16, 4)).astype(np.float32),
            "bias": rng.normal(size=(4,)).astype(np.float32)}
    with HeadFanoutServer(
            head_fanout_backbone_fn, head_fanout_module(
                {"backbone": rng.normal(size=(12, 16)).astype(np.float32)}),
            model_desc="headfanout", cache=False,
            cost=CostLedger(lockfile_path=MISSING), **kw) as fan:
        for t in ("a", "b"):
            fan.add_head(t, head)
            fan.predict(rng.normal(size=(12,)).astype(np.float32), t)
        docs["headfanout"] = fan.varz()
    with Fleet(cost=CostLedger(lockfile_path=MISSING), bucket_sizes=[8],
               **kw) as fleet:
        fleet.add_model("m", _pfn, Dense(w1["w"]))
        for t in ("a", "b"):
            fleet.predict("m", x, tenant=t)
        docs["fleet"] = fleet.varz()
    for name, doc in docs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(doc))
        assert doc["cost"]["totals"]["batches"] >= 1, name
        assert _costreport(path) == 0, name
        lines = capsys.readouterr().out.splitlines()
        assert lines[1].startswith("conservation:"), name
        assert {ln.split()[0] for ln in lines if ln} >= {"a", "b"}, name
        assert _costreport(path, "--json", "--tenant", "a") == 0, name
        shown = json.loads(capsys.readouterr().out)
        assert list(shown["tenants"]) == ["a"], name
        assert shown["totals"] == doc["cost"]["totals"], name


def test_costreport_exits_1_while_a_port_regression_is_open(tmp_path,
                                                            capsys):
    """The JAX sentinel story on the port's ledger: a 10x slowdown opens
    ``cost.regression`` and costreport exits 1, twice; back at the pinned
    rate it closes and costreport exits 0."""
    ledger = CostLedger(window=4, min_batches=4, regress_factor=2.0,
                        recover_factor=1.5, lockfile_path=MISSING)

    def batch(device_s):
        ledger.record_batch(model="m", bucket=8, tenant_rows={"a": 8},
                            device_s=device_s)

    dump = tmp_path / "varz.json"
    for _ in range(6):
        batch(0.001)
    dump.write_text(json.dumps({"cost": ledger.snapshot()}))
    assert _costreport(dump) == 0
    for _ in range(4):
        batch(0.010)
    assert set(ledger.regressions()) == {"m/b8"}
    dump.write_text(json.dumps({"cost": ledger.snapshot()}))
    assert _costreport(dump) == 1
    assert _costreport(dump, "--json", "--tenant", "a") == 1
    for _ in range(4):
        batch(0.001)
    assert ledger.regressions() == {}
    dump.write_text(json.dumps({"cost": ledger.snapshot()}))
    assert _costreport(dump) == 0
    capsys.readouterr()
