"""The port's spans while a ``torch.profiler`` collects, on the CPU.

With neither ``SPARKDL_TRACE`` nor a profiler on, a span site does one
check and gets ``NULL_SPAN``: no span, no ring write, no profiler range,
no CUDA event.  With a profiler collecting and ``SPARKDL_TRACE`` off, the
ring fills; the spans of the thread that started the profiler appear in
its exported trace as ``user_annotation`` ranges of the same name, at the
same place on the clock (a span's ``ts_us`` lies within 100 us of its
range's ``ts`` + ``baseTimeNanoseconds`` / 1e3), and other threads' spans
go to the ring only; no CUDA event is made and ``block_until_ready`` does
not wait.  A CPU ``DeepImagePredictor`` transform under a profiler
records ``stage.transform``, one ``stage.pack`` a chunk (on the runner's
prepare thread after the first), ``engine.pad`` and ``stage.column``,
each nested in its parent.  ``SPARKDL_TRACE`` on keeps its ways under a
profiler, on the same clock.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sparkdl_tpu_torch
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu_torch import obs
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.image.schema import imageArrayToStruct, imageSchema
from sparkdl_tpu_torch.models import get_model_spec, load_model
from sparkdl_tpu_torch.obs import trace as ptrace
from sparkdl_tpu_torch.obs.trace import NULL_SPAN
from sparkdl_tpu_torch.parallel.engine import InferenceEngine

SIZE = 96  # Xception narrowed, as in tests/test_torch_obs.py


@pytest.fixture(autouse=True)
def _restore_tracer(monkeypatch):
    monkeypatch.setattr(ptrace, "_tracer", ptrace._tracer)


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _profiled(tmp_path, body):
    """Run ``body()`` under a CPU profiler; returns the exported Chrome
    trace's ``user_annotation`` events by name and the trace's base, in
    microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first range sets itself up after its start is
        # stamped (about a millisecond on the CPU): warm it here
        with torch.profiler.record_function("warm"):
            pass
        body()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    return ranges, doc.get("baseTimeNanoseconds", 0) / 1e3


def _fail(*args, **kwargs):
    raise AssertionError("must not be called")


def test_neither_gate_on_one_check_and_the_null_span(monkeypatch):
    tracer = obs.configure(enabled=False)
    # nothing past the check may run: no span made, no thread's profiler
    # state read, no range, no CUDA event
    monkeypatch.setattr(ptrace.Tracer, "_make", _fail)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", _fail)
    monkeypatch.setattr(ptrace._profiler, "record_function", _fail)
    monkeypatch.setattr(torch.cuda, "Event", _fail)
    for _ in range(1000):
        with tracer.span("engine.pad", rows=64) as sp:
            assert sp is NULL_SPAN
            marker = object()
            assert sp.block_until_ready(marker) is marker
        assert tracer.start_span("pipeline.run") is NULL_SPAN
    assert len(tracer) == 0 and tracer.snapshot() == []


def test_under_a_profiler_the_ring_fills_and_ranges_follow(tmp_path):
    tracer = obs.configure(enabled=False)
    assert tracer.span("before") is NULL_SPAN
    other = []

    def worker():
        with tracer.span("worker.span", rows=2) as sp:
            other.append(sp)
            time.sleep(0.002)

    def body():
        with tracer.span("outer.span", rows=8) as outer:
            assert outer is not NULL_SPAN and outer.profiled
            for _ in range(3):
                with tracer.span("inner.span", rows=4):
                    time.sleep(0.002)
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            cross = tracer.start_span("cross.span")
            time.sleep(0.001)
            cross.finish()

    ranges, base_us = _profiled(tmp_path, body)
    assert tracer.span("after") is NULL_SPAN
    spans = tracer.snapshot()
    names = [s["name"] for s in spans]
    assert sorted(names) == sorted(["outer.span", "inner.span", "inner.span",
                                    "inner.span", "worker.span",
                                    "cross.span"])
    by_id = {s["span_id"]: s for s in spans}
    outer = next(s for s in spans if s["name"] == "outer.span")
    for s in spans:
        if s["name"] in ("inner.span", "cross.span"):
            assert by_id[s["parent_id"]] is outer
    assert outer["attrs"] == {"rows": 8}
    # the profiling thread's context-manager spans are ranges; another
    # thread's span and a start_span span are in the ring only
    assert len(ranges["outer.span"]) == 1 and len(ranges["inner.span"]) == 3
    assert "worker.span" not in ranges and "cross.span" not in ranges
    assert other[0].thread != outer["thread"]
    ring = sorted((s for s in spans if s["name"] in ranges),
                  key=lambda s: s["ts_us"])
    marks = sorted((e for n in ("outer.span", "inner.span")
                    for e in ranges[n]), key=lambda e: e["ts"])
    assert [s["name"] for s in ring] == [e["name"] for e in marks]
    for s, e in zip(ring, marks):
        assert abs(s["ts_us"] - (e["ts"] + base_us)) < 100.0
        assert abs(s["dur_us"] - e["dur"]) < 100.0
    # Unix microseconds, monotonic in the ring
    assert abs(outer["ts_us"] / 1e6 - time.time()) < 60.0
    starts = [s["ts_us"] for s in sorted(spans, key=lambda s: s["span_id"])]
    assert starts == sorted(starts)


def test_under_a_profiler_no_cuda_event_and_no_wait(tmp_path, monkeypatch):
    tracer = obs.configure(enabled=False)
    monkeypatch.setattr(ptrace, "_cuda_wait", _fail)
    made = []
    real_event = torch.cuda.Event

    def counted(*a, **k):
        made.append(1)
        return real_event(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    eng = InferenceEngine(lambda m, x: torch.tanh(x @ w), torch.nn.Module(),
                          device_batch_size=4)
    x = rng.normal(size=(11, 6)).astype(np.float32)
    off = eng(x, pipeline=True)
    got = {}

    def body():
        with tracer.span("gather") as sp:
            marker = object()
            assert sp.block_until_ready(marker) is marker
        got["on"] = eng(x, pipeline=True)

    _profiled(tmp_path, body)
    np.testing.assert_array_equal(got["on"], off)
    names = [s["name"] for s in tracer.snapshot()]
    for name in ("engine.call", "pipeline.run", "engine.pad",
                 "engine.replay", "engine.fetch", "engine.trim"):
        assert name in names
    assert names.count("engine.pad") == 3
    assert made == []


def test_the_tracer_on_keeps_its_ways_on_the_same_clock(tmp_path,
                                                        monkeypatch):
    """``SPARKDL_TRACE`` on, under a profiler too: full spans (they wait
    in ``block_until_ready``), no ranges, stamped in Unix time."""
    tracer = obs.configure(enabled=True)
    waited = []
    monkeypatch.setattr(ptrace, "_cuda_wait", waited.append)

    def body():
        with tracer.span("traced.span") as sp:
            assert not sp.profiled
            sp.block_until_ready("x")

    ranges, _ = _profiled(tmp_path, body)
    assert waited == ["x"] and "traced.span" not in ranges
    (s,) = tracer.snapshot()
    assert abs(s["ts_us"] / 1e6 - time.time()) < 60.0


@pytest.fixture
def small_xception(monkeypatch):
    """A seeded Xception behind the zoo transformers at 96x96."""
    narrow = dataclasses.replace(get_model_spec("Xception"),
                                 input_size=(SIZE, SIZE))
    monkeypatch.setattr(port_ni, "get_model_spec", lambda name: narrow)
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    monkeypatch.setitem(port_ni._MODEL_CACHE,
                        ("Xception", port_ni.model_variant_key("Xception")),
                        load_model("Xception", weights=None))


def test_zoo_transform_under_a_profiler_records_the_stage(tmp_path,
                                                          small_xception):
    rng = np.random.default_rng(5)
    structs = [imageArrayToStruct(rng.integers(0, 256, (SIZE, SIZE, 3),
                                               dtype=np.uint8))
               for _ in range(10)]
    structs[6] = None
    df = DataFrame(pa.table({"image": pa.array(structs, type=imageSchema)}))
    tr = port_ni.DeepImagePredictor(inputCol="image", outputCol="p",
                                    modelName="Xception", batchSize=4)
    tracer = obs.configure(enabled=False)
    off = tr.transform(df).table.column("p").to_pylist()
    assert len(tracer) == 0
    got = {}
    ranges, _ = _profiled(tmp_path, lambda: got.update(
        on=tr.transform(df).table.column("p").to_pylist()))
    assert got["on"] == off
    spans = tracer.snapshot()
    by_id = {s["span_id"]: s for s in spans}

    def named(name):
        return [s for s in spans if s["name"] == name]

    (transform,) = named("stage.transform")
    (column,) = named("stage.column")
    assert transform["attrs"] == {"rows": 10}
    assert column["attrs"] == {"rows": 10}
    packs = sorted(named("stage.pack"), key=lambda s: s["ts_us"])
    assert [p["attrs"]["rows"] for p in packs] == [4, 4, 2]
    caller = transform["tid"]
    assert packs[0]["tid"] == caller and column["tid"] == caller
    assert {p["tid"] for p in packs[1:]} == {
        next(s["tid"] for s in spans if s["name"] == "pipeline.prepare")}
    assert packs[1]["tid"] != caller
    pads = named("engine.pad")
    assert len(pads) == 3 and all(p["tid"] != caller for p in pads)

    def chain(s):
        names = []
        while s["parent_id"] in by_id:
            s = by_id[s["parent_id"]]
            names.append(s["name"])
        return names

    def inside(s, p):
        return (p["ts_us"] <= s["ts_us"] + 1.0 and s["ts_us"] + s["dur_us"]
                <= p["ts_us"] + p["dur_us"] + 1.0)

    assert chain(packs[0]) == ["stage.transform"]
    assert chain(column) == ["stage.transform"]
    for s in packs[1:] + pads:
        assert chain(s)[0] == "pipeline.prepare"
        assert chain(s)[-1] == "stage.transform"
    for s in spans:
        if s["parent_id"] in by_id:
            assert inside(s, by_id[s["parent_id"]]), s["name"]
    # the caller's spans are the profiler's ranges; the prepare thread's
    # are not
    assert len(ranges["stage.transform"]) == 1
    assert len(ranges["stage.pack"]) == 1 and len(ranges["stage.column"]) == 1
    assert "engine.pad" not in ranges
