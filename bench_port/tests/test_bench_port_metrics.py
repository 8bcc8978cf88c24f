"""The benchmark's arithmetic on made-up inputs: the rate over a whole
window, the idle share of a trace, mfu and a kernel's roofline share."""

import json
from pathlib import Path

import pytest

from bench_port.lib import readers
from bench_port.lib.harness import Window, load_module
from bench_port.lib.trace import Trace, read_busy, read_chrome_trace, union
from bench_port.lib.yardstick import (PEAK_BF16_FLOPS, PEAK_BYTES, bound,
                                      rate, sepconv_cost)

ROOT = Path(__file__).resolve().parents[2]


def test_rate_counts_all_work_over_all_time():
    # three calls of 100 items finishing at 0.9, 2.1 and 3.0 s after the
    # start: 300 items over 3 s, not the mean of the calls' own rates
    assert rate(300, 10.0, 13.0) == pytest.approx(100.0)


def test_union_and_idle_share_of_a_made_up_trace():
    assert union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == [(0.0, 2.0),
                                                          (3.0, 4.0)]
    tr = Trace(window_s=10.0,
               device=[(0.0, 2.0, "k1"), (1.0, 3.0, "k2"), (5.0, 6.0, "k1")],
               host=[(3.0, 5.0, "bench.transform", 1),
                     (3.5, 4.5, "cudaEventSynchronize", 2)])
    assert tr.busy_s() == pytest.approx(4.0)
    w = Window(seconds=10.0, trace=tr)
    assert readers.idle_pct(w) == pytest.approx(60.0)
    ops = dict(tr.top_device_ops())
    assert ops == pytest.approx({"k1": 3.0, "k2": 2.0})
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(4.0)  # 6 s to the window's end
    assert gaps[1][1] == pytest.approx(2.0)
    assert "bench.transform" in gaps[1][0]
    assert "cudaEventSynchronize" in gaps[1][0]


def test_chrome_trace_is_read_inside_the_window_only():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 1000.0, "dur": 1000.0, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 500.0,
         "dur": 1000.0},                                   # half inside
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1800.0,
         "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 2500.0, "dur": 100.0},                      # after
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1200.0,
         "dur": 10.0, "tid": 3},
    ]
    tr = read_chrome_trace(ev)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(0.6e-3)
    assert [h[2] for h in tr.host] == ["aten::copy_"]
    assert read_chrome_trace(ev[1:]) is None


class Device:
    def __init__(self, name):
        self.name = name


class Event:
    """A stand-in for the profiler's event, as ``read_busy`` reads it."""

    def __init__(self, device, name, a, b, annotation=False):
        self.device, self._name, self.a, self.b = device, name, a, b
        self.annotation = annotation

    def device_type(self):
        return Device(self.device)

    def is_user_annotation(self):
        return self.annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b


def test_busy_reads_device_records_inside_the_window_only():
    ev = [Event("CUDA", "k", 100, 300),              # the warm call
          Event("CPU", "bench.window", 1000, 3000, annotation=True),
          Event("CUDA", "bench.window", 1100, 2900, annotation=True),
          Event("CUDA", "k", 900, 1200),             # half inside
          Event("CUDA", "k", 1100, 1300),
          Event("CUDA", "Memcpy HtoD", 2000, 2100),
          Event("CPU", "aten::copy_", 1500, 2500),
          Event("CPU", "cudaGraphLaunch", 1050, 1060),
          Event("CUDA", "k", 3500, 3600)]            # after
    b = read_busy(ev)
    assert b.window_s == pytest.approx(2e-6)
    assert b.busy_s == pytest.approx(0.4e-6)
    assert (b.records, b.records_before) == (3, 1)
    assert read_busy(ev[2:]) is None


def test_mfu_and_roofline_shares():
    cfg = json.loads((ROOT / "bench_port/configs/xception-bf16.json")
                     .read_text())
    flops = cfg["flops_per_image"]["probabilities"]
    w = Window(seconds=2.0, images=4000, config=cfg,
               params={"output": "probabilities"})
    assert readers.mfu_pct(w) == pytest.approx(
        flops * 2000 / PEAK_BF16_FLOPS * 100)
    assert readers.window_rate(w) == pytest.approx(2000.0)
    assert readers.busy_mfu_pct(w) is None  # no trace
    w.trace = Trace(window_s=2.0, device=[(0.0, 0.5, "k"), (0.25, 1.0, "k")])
    assert readers.busy_mfu_pct(w) == pytest.approx(
        flops * 4000 / PEAK_BF16_FLOPS * 100)
    # two forwards' B1 launches, each launch taking 4x its least time
    classes = cfg["b1_launch_classes"]
    dev, t = [], 0.0
    for _ in range(2):
        for c in classes:
            least = bound(c["flops"], c["bytes"])[0]
            for _ in range(c["launches"]):
                dev.append((t, t + 4 * least,
                            "void (anonymous namespace)::sepconv_kernel"
                            "<128, true, false>(...)"))
                t += 4 * least
    dev.append((t, t + 1.0, "sm90_xmma_fprop_implicit_gemm"))
    w.trace = Trace(window_s=t + 1.0, device=dev)
    reader = load_module(ROOT / "bench_port/metrics/b1_roofline_pct.batch.py",
                         "b1_test")
    assert reader.read(w) == pytest.approx(25.0)
    w.trace = Trace(window_s=1.0, device=[(0.0, 1.0, "other_kernel")])
    assert reader.read(w) is None  # nothing to read: no B1 launch


def test_frozen_costs_match_the_bound_arithmetic():
    flops, nbytes = sepconv_cost(64, 19, 19, 728, 728)
    assert flops == 2.0 * 64 * 19 * 19 * 728 * (9 + 728)
    s, by = bound(flops, nbytes)
    assert s == pytest.approx(max(flops / PEAK_BF16_FLOPS,
                                  nbytes / PEAK_BYTES))
    assert by == "operations"
    cfg = json.loads((ROOT / "bench_port/configs/xception-bf16.json")
                     .read_text())
    for c in cfg["b1_launch_classes"]:
        assert (c["flops"], c["bytes"]) == sepconv_cost(
            c["n"], c["hw"], c["hw"], c["c"], c["f"])
    assert sum(c["launches"] for c in cfg["b1_launch_classes"]) == 30


def test_counter_share_and_series_readers():
    w = Window(seconds=4.0, counters={"pipeline.dispatch_in_stall_s": 1.0},
               series={"engine.replay_host": [0.001, 0.003]})
    assert readers.counter_share_pct(
        w, "pipeline.dispatch_in_stall_s",
        ran="engine.replay_host") == pytest.approx(25.0)
    assert readers.series_mean_ms(w, "engine.replay_host") == \
        pytest.approx(2.0)
    assert readers.counter_share_pct(w, "x", ran="none") is None
