"""The port's metrics registry (sparkdl_tpu_torch/utils/metrics.py) held
against the JAX package's: the same recordings give the same counters,
gauges, percentiles, summary and subsets, and the series stay bounded."""

import numpy as np
import pytest

from sparkdl_tpu.utils.metrics import Metrics as JaxMetrics
from sparkdl_tpu_torch.utils.metrics import Metrics


def _record(m, rng):
    for i in range(300):
        m.incr("engine.rows", int(rng.integers(1, 33)))
        m.incr("pipeline.dispatches")
        m.record_time("engine_call", float(rng.random()))
        m.observe("pipeline.prep_q_depth", int(rng.integers(0, 3)))
        m.gauge("engine.graph_pool_bytes", float(i * 1024))
    m.incr("engine.pad_rows", np.int64(5))  # numpy scalars enter as float


@pytest.mark.parametrize("seed,max_samples", [(0, 16384), (1, 64), (2, 7)])
def test_summary_matches_jax(seed, max_samples):
    ours, ref = Metrics(max_samples=max_samples), JaxMetrics(
        max_samples=max_samples)
    _record(ours, np.random.default_rng(seed))
    _record(ref, np.random.default_rng(seed))
    assert ours.summary() == ref.summary()
    assert ours.subset("pipeline.") == ref.subset("pipeline.")
    for q in (0, 50, 99, 100):
        assert ours.percentile("engine_call", q) == ref.percentile(
            "engine_call", q)
        assert ours.percentile("pipeline.prep_q_depth", q,
                               kind="histogram") == ref.percentile(
            "pipeline.prep_q_depth", q, kind="histogram")
    assert all(len(v) <= max_samples for v in ours.timings_s.values())
    assert type(ours.counters["engine.pad_rows"]) is float


def test_percentile_lookup_rules():
    m = Metrics()
    assert m.percentile("absent", 50) is None
    m.timings_s["x"] = []
    m.observe("x", 3.0)
    assert m.percentile("x", 50) is None  # a present timing name wins
    assert m.percentile("x", 50, kind="histogram") == 3.0
    with pytest.raises(ValueError):
        m.percentile("x", 50, kind="nope")


def test_reset_series_keeps_counters_and_starts_a_whole_window():
    """After ``reset_series`` the series hold only the window's samples,
    even where a slice of the bounded series would have lost some."""
    m = Metrics(max_samples=8)
    for i in range(11):
        m.record_time("lat", float(i))
        m.observe("fill", 1.0)
        m.incr("n")
    m.gauge("g", 2.0)
    m.reset_series()
    for i in range(5):
        m.record_time("lat", 100.0 + i)
    raw = m.snapshot_raw()
    assert raw["timings_s"] == {"lat": [100.0, 101.0, 102.0, 103.0, 104.0]}
    assert raw["histograms"] == {}
    assert raw["counters"] == {"n": 11.0} and raw["gauges"] == {"g": 2.0}


def test_profiled_kernels_counts_the_second_call_and_keeps_the_trace(
        tmp_path):
    """The two-pass count on the CPU: ``fn`` runs twice in one window, the
    second call is the ``sparkdl.counted`` range whose wall ms comes
    back, the Chrome trace is kept where asked, and without a card no
    kernel is counted."""
    import json

    import torch

    from sparkdl_tpu_torch.utils.metrics import profiled_kernels

    calls = []
    x = torch.ones(64, 64)

    def fn():
        calls.append(1)
        return x @ x

    path = tmp_path / "trace.json"
    total, names, wall_ms = profiled_kernels(fn, trace_path=str(path))
    assert len(calls) == 2
    assert (total, names) == (0, {}) and wall_ms > 0
    events = json.loads(path.read_text())["traceEvents"]
    counted = [e for e in events if e.get("name") == "sparkdl.counted"]
    assert len(counted) == 1 and counted[0]["dur"] / 1e3 == wall_ms
