"""The port's pipelined runner (sparkdl_tpu_torch/parallel/pipeline.py) and
the engine paths it drives, held against the serial path bit for bit and
against the JAX package's engine on the same seeded inputs (the contracts
of tests/test_pipeline.py, on the CPU)."""

import threading
import time
import weakref

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel.engine import InferenceEngine as JaxEngine
from sparkdl_tpu_torch import faults
from sparkdl_tpu_torch.faults import FaultPlan
from sparkdl_tpu_torch.parallel import engine as engine_mod
from sparkdl_tpu_torch.parallel.engine import (CircuitOpenError,
                                               InferenceEngine)
from sparkdl_tpu_torch.parallel.pipeline import (PipelinedRunner,
                                                 PipelineStageError,
                                                 PipelineStageFatalError,
                                                 pipeline_enabled_from_env,
                                                 pipeline_stage_summary,
                                                 synthetic_overlap_benchmark)
from sparkdl_tpu_torch.utils.metrics import Metrics
from sparkdl_tpu_torch.utils.retry import NON_RETRYABLE, with_retries

# f32 tanh(x @ w + b) over 12-wide rows on both sides: only the summation
# order of the 12 products differs.
PARITY_REL = 1e-6


@pytest.fixture(autouse=True)
def _isolated_plan():
    from sparkdl_tpu_torch.faults import plan as plan_mod

    prev = plan_mod._PLAN
    yield
    plan_mod._PLAN = prev


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    x = rng.normal(size=(145, 12)).astype(np.float32)
    return w, b, x


def _linear(w, b):
    lin = nn.Linear(w.shape[0], w.shape[1])
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    return lin


def _engine(setup, **kw):
    w, b, _ = setup
    return InferenceEngine(lambda m, x: torch.tanh(m(x)), _linear(w, b),
                           device="cpu", **kw)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("sparkdl-pipeline")]


def _wait_threads_gone(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _pipeline_threads():
            return True
        time.sleep(0.02)
    return False


def test_pipeline_env_knob(monkeypatch):
    monkeypatch.delenv("SPARKDL_PIPELINE", raising=False)
    assert pipeline_enabled_from_env()
    for off in ("0", "false", "OFF", "no"):
        monkeypatch.setenv("SPARKDL_PIPELINE", off)
        assert not pipeline_enabled_from_env()
    monkeypatch.setenv("SPARKDL_PIPELINE", "1")
    assert pipeline_enabled_from_env()


def test_escape_hatch_never_builds_a_runner(setup, monkeypatch):
    monkeypatch.setenv("SPARKDL_PIPELINE", "0")

    def boom(*a, **k):
        raise AssertionError("PipelinedRunner built despite the escape "
                             "hatch")

    monkeypatch.setattr(engine_mod, "PipelinedRunner", boom)
    w, b, x = setup
    eng = _engine(setup, device_batch_size=16)
    ref = np.tanh(x @ w + b)
    np.testing.assert_allclose(eng(x), ref, rtol=1e-5, atol=1e-6)
    got = np.concatenate(list(eng.map_batches([x])), axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bpd", [1, 2, 3])
def test_map_batches_bit_identical_to_serial(setup, bpd):
    """Same dispatches, same pad/trim, same order: the pipelined stream is
    the serial stream byte for byte, ragged chunks and ragged tail groups
    included."""
    _, _, x = setup
    eng = _engine(setup, device_batch_size=16, batches_per_dispatch=bpd)
    chunks = [x[:60], x[60:63], x[63:]]
    serial = list(eng.map_batches(iter(chunks), pipeline=False))
    piped = list(eng.map_batches(iter(chunks), pipeline=True))
    assert len(serial) == len(piped) == 4 + 1 + 6
    for a, b in zip(serial, piped):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert _wait_threads_gone()


@pytest.mark.parametrize("bpd", [1, 2, 3])
def test_pytree_batches_bit_identical_to_serial(setup, bpd):
    """Pytree batches in, pytree outputs out (a dict of a float and an
    integer leaf, a tuple inside): pipelined == serial per piece, integer
    leaves never cast."""
    w, b, x = setup
    ids = np.arange(len(x), dtype=np.int64)

    def fn(m, batch):
        y = torch.tanh(m(batch["x"]))
        return {"y": y, "pair": (torch.argmax(y, -1), batch["ids"] * 2)}

    eng = InferenceEngine(fn, _linear(w, b), device="cpu",
                          device_batch_size=16, batches_per_dispatch=bpd,
                          output_host_dtype=np.float64)
    chunks = [{"x": x[:40], "ids": ids[:40]}, {"x": x[40:], "ids": ids[40:]}]
    serial = list(eng.map_batches(iter(chunks), pipeline=False))
    piped = list(eng.map_batches(iter(chunks), pipeline=True))
    assert len(serial) == len(piped)
    for a, p in zip(serial, piped):
        np.testing.assert_array_equal(a["y"], p["y"])
        for u, v in zip(a["pair"], p["pair"]):
            np.testing.assert_array_equal(u, v)
        assert p["y"].dtype == np.float64
        assert p["pair"][0].dtype.kind in "iu"
    got = eng({"x": x, "ids": ids}, pipeline=True)
    np.testing.assert_array_equal(got["pair"][1], ids * 2)
    np.testing.assert_allclose(got["y"], np.tanh(x @ w + b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("bpd", [1, 2, 3])
def test_pipelined_matches_jax_engine(setup, bpd):
    """The port's pipelined outputs and pad ledger against the JAX engine's
    on the same seeded ``tanh(x @ w + b)``."""
    w, b, x = setup
    jeng = JaxEngine(lambda v, a: jnp.tanh(a @ v["w"] + v["b"]),
                     {"w": w, "b": b},
                     mesh=jax_mesh.get_mesh(num_devices=1),
                     device_batch_size=16, batches_per_dispatch=bpd)
    peng = _engine(setup, device_batch_size=16, batches_per_dispatch=bpd)
    chunks = [x[:60], x[60:63], x[63:]]
    want = [np.asarray(o) for o in jeng.map_batches(iter(chunks),
                                                    pipeline=True)]
    got = list(peng.map_batches(iter(chunks), pipeline=True))
    assert [g.shape for g in got] == [a.shape for a in want]
    for g, a in zip(got, want):
        assert np.linalg.norm(g - a) <= PARITY_REL * np.linalg.norm(a)
    ledger = ("engine.rows", "engine.pad_rows")
    assert ({k: peng.metrics.counters[k] for k in ledger}
            == {k: jeng.metrics.counters[k] for k in ledger})
    assert (peng.metrics.counters["pipeline.dispatches"]
            == jeng.metrics.counters["pipeline.dispatches"])


def test_call_bit_identical_to_serial_pytree(setup):
    w, b, x = setup

    def fn(m, xb):
        y = torch.tanh(m(xb))
        return {"y": y, "ids": torch.argmax(y, dim=-1)}

    eng = InferenceEngine(fn, _linear(w, b), device="cpu",
                          device_batch_size=8, output_host_dtype=np.float32)
    a = eng(x, pipeline=False)
    b_ = eng(x, pipeline=True)
    np.testing.assert_array_equal(a["y"], b_["y"])
    np.testing.assert_array_equal(a["ids"], b_["ids"])
    assert b_["ids"].dtype.kind in "iu"
    assert b_["y"].dtype == np.float32


def test_single_piece_call_skips_worker_threads(setup, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("runner built for a single-piece call")

    monkeypatch.setattr(engine_mod, "PipelinedRunner", boom)
    w, b, x = setup
    eng = _engine(setup, device_batch_size=16)
    out = eng(x[:10], pipeline=True)
    np.testing.assert_allclose(out, np.tanh(x[:10] @ w + b), rtol=1e-5,
                               atol=1e-6)


def test_pipelined_grouped_tail_uses_plain_path(setup, monkeypatch):
    """The ragged tail of a grouped run takes the per-batch path in the
    pipelined stages too, never a group padded with whole zero batches."""
    _, _, x = setup
    eng = _engine(setup, device_batch_size=16, batches_per_dispatch=3)
    calls = {"group": 0, "plain": 0}
    lock = threading.Lock()
    orig_group, orig_plain = eng._dispatch_group, eng.run_padded

    def spy_group(stacked):
        with lock:
            calls["group"] += 1
        return orig_group(stacked)

    def spy_plain(batch):
        with lock:
            calls["plain"] += 1
        return orig_plain(batch)

    monkeypatch.setattr(eng, "_dispatch_group", spy_group)
    monkeypatch.setattr(eng, "run_padded", spy_plain)
    out = eng(np.concatenate([x[:45], x[:19]]), pipeline=True)  # 4 pieces
    assert out.shape[0] == 64
    assert calls == {"group": 1, "plain": 1}


def test_large_frame_call_preallocates_and_bounds_residency(setup,
                                                            monkeypatch):
    rng = np.random.default_rng(11)
    n_chunks = 48
    x = rng.normal(size=(8 * n_chunks, 12)).astype(np.float32)
    eng = _engine(setup, device_batch_size=8)
    ref = eng(x, pipeline=False)

    refs, peaks = [], []
    orig_trim = eng._trim

    def spy_trim(out, nn_):
        res = orig_trim(out, nn_)
        refs.append(weakref.ref(res))
        peaks.append(sum(1 for r in refs if r() is not None))
        return res

    monkeypatch.setattr(eng, "_trim", spy_trim)
    before = eng.metrics.counters.get("engine_call_prealloc", 0)
    out = eng(x, pipeline=True)
    np.testing.assert_array_equal(out, ref)
    assert eng.metrics.counters["engine_call_prealloc"] == before + 1
    assert len(refs) == n_chunks
    assert max(peaks) <= 8, max(peaks)


def test_producer_error_names_the_prepare_stage(setup):
    _, _, x = setup
    eng = _engine(setup, device_batch_size=16)

    def bad():
        yield x[:16]
        raise OSError("decode exploded")

    with pytest.raises(PipelineStageError, match="decode exploded") as ei:
        list(eng.map_batches(bad(), pipeline=True))
    assert ei.value.stage == "prepare"
    assert isinstance(ei.value.__cause__, OSError)
    assert _wait_threads_gone()


@pytest.mark.parametrize("stage,at", [("prepare", 2), ("dispatch", 1),
                                      ("gather", 2)])
def test_stage_crash_is_structured_and_drains(setup, stage, at):
    """An injected transient fault in a stage: PipelineStageError naming
    the stage and the 0-based piece, the cause chained, every thread gone;
    the rerun (rule spent) is bit-identical to the serial path."""
    _, _, x = setup
    eng = _engine(setup, device_batch_size=8)
    batches = [x[i:i + 8] for i in range(0, 48, 8)]
    ref = list(eng.map_batches(list(batches), pipeline=False))
    with faults.active(FaultPlan.parse(
            f"pipeline.{stage}:error:exc=transient,at={at},times=1")):
        with pytest.raises(PipelineStageError) as ei:
            list(eng.map_batches(list(batches), pipeline=True))
        assert ei.value.stage == stage
        assert ei.value.piece == at - 1
        assert isinstance(ei.value.__cause__, faults.InjectedTransientError)
        assert _wait_threads_gone()
        out = list(eng.map_batches(list(batches), pipeline=True))
    assert all(np.array_equal(a, b) for a, b in zip(ref, out))
    assert eng.metrics.counters[f"pipeline.{stage}_crashes"] == 1
    assert _wait_threads_gone()


def test_fatal_cause_stays_non_retryable(setup):
    _, _, x = setup
    eng = _engine(setup, device_batch_size=8)
    batches = [x[i:i + 8] for i in range(0, 24, 8)]
    calls = {"n": 0}

    def run_once():
        calls["n"] += 1
        with faults.active(FaultPlan.parse(
                "pipeline.gather:error:exc=fatal,at=1")):
            return list(eng.map_batches(list(batches), pipeline=True))

    with pytest.raises(PipelineStageFatalError) as ei:
        with_retries(run_once, max_retries=3)
    assert isinstance(ei.value, PipelineStageError)
    assert isinstance(ei.value, NON_RETRYABLE)
    assert calls["n"] == 1
    assert _wait_threads_gone()


def test_circuit_open_passes_through_unwrapped(setup):
    _, _, x = setup
    eng = _engine(setup, device_batch_size=8, breaker_threshold=1,
                  breaker_cooldown_s=30.0)
    batches = [x[i:i + 8] for i in range(0, 24, 8)]
    with faults.active(FaultPlan.parse("engine.dispatch:dead:at=1")):
        with pytest.raises(PipelineStageError):
            list(eng.map_batches(list(batches), pipeline=True))
        assert eng.breaker_state()["state"] == "open"
        with pytest.raises(CircuitOpenError) as ei:
            list(eng.map_batches(list(batches), pipeline=True))
        assert ei.value.retry_after_s > 0
    assert _wait_threads_gone()


def test_consumer_abandonment_stops_worker_threads(setup):
    _, _, x = setup
    eng = _engine(setup, device_batch_size=8)
    it = eng.map_batches([x], pipeline=True)
    first = next(it)
    assert first.shape[0] == 8
    it.close()
    assert _wait_threads_gone()


def test_stage_metrics_recorded(setup):
    _, _, x = setup
    m = Metrics()
    eng = _engine(setup, device_batch_size=8, metrics=m)
    list(eng.map_batches([x], pipeline=True))
    assert m.counters.get("pipeline.dispatches") == 19  # ceil(145/8)
    assert m.counters.get("pipeline.gathers") == 19
    for q in ("prep_q", "inflight_q", "out_q"):
        assert f"pipeline.{q}_depth" in m.histograms
    summary = pipeline_stage_summary(m)
    assert summary["pipeline.dispatches"] == 19
    assert any(k.endswith("_depth.mean") for k in summary)


def test_runner_window_counts_groups(setup):
    eng = _engine(setup, device_batch_size=8, batches_per_dispatch=3)
    assert PipelinedRunner(eng, window=2).window == 1
    assert PipelinedRunner(eng, window=7).window == 2
    assert PipelinedRunner(_engine(setup), window=3).window == 3


def test_synthetic_overlap_benchmark_speedup():
    """The overlap contract: a 100 ms blocking dispatch and 100 ms of host
    prepare per batch; pipelined >= 1.5x serial (ideal 2x)."""
    result = synthetic_overlap_benchmark()
    assert result["speedup"] >= 1.5, result
    assert result["stages"]["pipeline.dispatches"] == result["n_batches"]
    assert "pipeline.gather_in_stall_s" in result["stages"]
