"""The program's spans read over a traced window: ``lib/spans.py`` on a
made-up trace and ring (the alignment by the caller's spans, the order in
which idle time is charged, no alignment where the two cannot be lined
up), and a CPU traced run of each cell reporting its two span metrics."""

import os
import time
from pathlib import Path

import pytest

from bench_port.lib import harness, spans
from bench_port.lib.harness import Window, load_module
from bench_port.lib.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
UNIX = 1.79e9  # the ring's clock: Unix seconds
SHIFT = UNIX + 0.25  # the ring's time at the window's start, made up
CALLER, PREPARE = 11, 12  # the trace's thread ids
RING_CALLER, RING_PREPARE = 901, 902  # the ring's


def ring_span(name, a, b, tid, rows=None):
    """A ``Tracer.snapshot`` dict, ``a``..``b`` seconds from the window's
    start."""
    return {"name": name, "ts_us": (SHIFT + a) * 1e6,
            "dur_us": (b - a) * 1e6, "tid": tid,
            "attrs": {} if rows is None else {"rows": rows}}


def made_up(jitter=0.0):
    """A 1 s window: two transforms on the caller's thread, each with its
    first pack and its column; the other packs and the engine's spans on
    the runner's threads, in the ring only; a warm transform before the
    window in the ring only, as long as the others: only the offsets
    tell which shift lines the two up.  ``jitter`` moves the second
    transform in the ring, its duration kept, by that many seconds."""
    caller = [("stage.transform", 0.00, 0.45), ("stage.pack", 0.01, 0.03),
              ("stage.column", 0.40, 0.44),
              ("stage.transform", 0.50, 0.95), ("stage.pack", 0.51, 0.53),
              ("stage.column", 0.90, 0.94)]
    trace = Trace(window_s=1.0,
                  device=[(0.05, 0.10, "k"), (0.20, 0.30, "k"),
                          (0.55, 0.88, "k")],
                  host=[(a, b, n, CALLER) for n, a, b in caller]
                  + [(0.3, 0.31, "cudaMemcpyAsync", PREPARE)])
    ring = [ring_span("stage.transform", -0.6, -0.15, RING_CALLER, 8),
            ring_span("stage.pack", -0.59, -0.57, RING_CALLER, 64)]
    for i, (n, a, b) in enumerate(caller):
        if i == 3:
            a, b = a + jitter, b + jitter
        ring.append(ring_span(n, a, b, RING_CALLER, 64))
    ring += [ring_span("stage.pack", 0.10, 0.16, RING_PREPARE, 64),
             ring_span("stage.pack", 0.16, 0.25, RING_PREPARE, 64),
             ring_span("engine.pad", 0.25, 0.27, RING_PREPARE, 64),
             ring_span("engine.fetch", 0.30, 0.36, 903, 64),
             ring_span("stage.pack", 0.96, 1.2, RING_PREPARE, 64),
             ring_span("stage.pack", 0.12, 0.13, RING_PREPARE, 16)]
    return trace, ring


def test_the_ring_lines_up_by_the_callers_spans():
    trace, ring = made_up()
    aligned = spans.align(trace, ring)
    assert aligned is not None
    assert aligned.pairs == 4  # both transforms and their first packs
    assert aligned.spread_s == pytest.approx(0.0, abs=1e-6)
    got = {(round(a, 6), round(b, 6), n) for a, b, n, _, _ in aligned.spans}
    assert (0.1, 0.16, "stage.pack") in got
    assert (-0.6, -0.15, "stage.transform") in got


def test_idle_time_is_charged_pack_first_then_column_then_engine():
    trace, ring = made_up()
    aligned = spans.align(trace, ring)
    split = spans.charge(trace, aligned)
    # the ring's Unix seconds carry a few tenths of a microsecond
    near = dict(abs=1e-5)
    # idle: 0-0.05, 0.10-0.20, 0.30-0.55, 0.88-1.0
    assert split["idle"] == pytest.approx(0.52, **near)
    # pack: 0.01-0.03 and 0.10-0.20 (0.10-0.16, 0.16-0.25), 0.51-0.53,
    # 0.96-1.0
    assert split["pack"] == pytest.approx(0.02 + 0.10 + 0.02 + 0.04, **near)
    # column, where no pack is open: 0.40-0.44, 0.90-0.94
    assert split["column"] == pytest.approx(0.08, **near)
    # the engine's fetch 0.30-0.36; the pad lies where the device is busy
    assert split["engine"] == pytest.approx(0.06, **near)
    assert split["unnamed"] == pytest.approx(0.52 - 0.18 - 0.08 - 0.06, **near)


def test_the_readers_on_a_made_up_window(monkeypatch):
    trace, ring = made_up()
    monkeypatch.setattr(spans, "ring", lambda: ring)
    w = Window(seconds=1.0, trace=trace, params={"batch_size": 64})
    # the 64-row packs wholly inside the window: 20, 20, 60 and 90 ms
    assert spans.pack_ms(w) == pytest.approx((20 + 20 + 60 + 90) / 4,
                                             abs=1e-3)
    assert spans.idle_in_pack_pct(w) == pytest.approx(0.18 / 0.52 * 100,
                                                      abs=1e-2)
    for name in ("pack_ms.batch", "pack_ms.host_paced"):
        reader = load_module(ROOT / "bench_port" / "metrics" / f"{name}.py",
                             f"spans_test_{name}")
        assert reader.read(w) == pytest.approx(47.5, abs=1e-3)
    for name in ("idle_in_pack_pct.batch", "idle_in_pack_pct.host_paced"):
        reader = load_module(ROOT / "bench_port" / "metrics" / f"{name}.py",
                             f"spans_test_{name}")
        assert 0.0 <= reader.read(w) <= 100.0


@pytest.mark.parametrize("case", ["empty ring", "no transform", "one pair",
                                  "durations differ", "offsets spread",
                                  "no trace"])
def test_no_alignment_gives_no_reading(case, monkeypatch):
    trace, ring = made_up()
    if case == "empty ring":
        ring = []
    elif case == "no transform":
        ring = [s for s in ring if s["name"] != "stage.transform"]
        trace.host = [h for h in trace.host if h[2] != "stage.transform"]
    elif case == "one pair":
        ring = [s for s in ring if s["name"] == "stage.transform"][:2]
    elif case == "durations differ":
        for s in ring:
            if s["tid"] == RING_CALLER:
                s["dur_us"] += 60.0  # over the 50 us two anchors may differ
    elif case == "offsets spread":
        # every anchor pairs, and their offsets spread over 100 us
        _, ring = made_up(jitter=150e-6)
    elif case == "no trace":
        trace = None
    assert spans.align(trace, ring) is None
    monkeypatch.setattr(spans, "ring", lambda: ring)
    w = Window(seconds=1.0, trace=trace, params={"batch_size": 64})
    assert spans.pack_ms(w) is None and spans.idle_in_pack_pct(w) is None


def test_a_small_offset_spread_still_lines_up():
    _, ring = made_up(jitter=40e-6)
    trace, _ = made_up()
    aligned = spans.align(trace, ring)
    assert aligned is not None and aligned.pairs == 4
    assert aligned.spread_s == pytest.approx(40e-6, abs=1e-6)


SMALL = {"rows": 6, "nulls": 1, "batch_size": 4, "warmup_calls": 1,
         "trace_seconds": 0.5}
NEW = {"xception-predict-b64": ("pack_ms.batch", "idle_in_pack_pct.batch"),
       "inceptionv3-featurize-b64": ("pack_ms.host_paced",
                                     "idle_in_pack_pct.host_paced")}


@pytest.fixture
def own_environment():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_cpu_traced_run_reports_the_span_metrics(cell, own_environment):
    line, _ = harness.execute(ROOT, cell, 2**31 + 7, 0.8, True,
                              time.monotonic(), device="cpu",
                              overrides=dict(SMALL))
    assert line["correct"] is True
    pack, idle = NEW[cell]
    assert line["metrics"][pack]["unit"] == "ms"
    assert line["metrics"][pack]["value"] > 0
    # off the card the whole window is idle
    assert 0.0 <= line["metrics"][idle]["value"] <= 100.0
