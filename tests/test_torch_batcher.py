"""The port's ``DynamicBatcher`` held against the JAX package's.

A seeded arrival script (payload shapes, deadlines, gaps) drives both
batchers under one injected virtual clock, and the flush sequence must be
the same exactly: the batches and their members, the ragged cuts, the
top-offs a server would pull, the shed requests and the rejected ones with
their ``retry_after_s``.  ``next_batch`` is only called when a flush is due
(both batchers must agree that it is), so nothing waits on the real clock.
Then the edges of the JAX package's ``tests/test_ragged.py`` on the port:
bucket-boundary cuts, top-off limits, a deadline shed inside a forming
batch, the server's top-off and its fault site, and the chip-free ragged
arrival benchmark.
"""

import time

import numpy as np
import pytest
import torch

import sparkdl_tpu.serving.batcher as jbatcher
import sparkdl_tpu_torch
import sparkdl_tpu_torch.serving.batcher as pbatcher
from sparkdl_tpu_torch import faults
from sparkdl_tpu_torch.serving.batcher import (DynamicBatcher, Request,
                                               ragged_arrival_benchmark,
                                               ragged_enabled_from_env)
from sparkdl_tpu_torch.serving.errors import (DeadlineExceededError,
                                              QueueFullError)
from sparkdl_tpu_torch.serving.server import Server


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _due(b, now):
    """The flush predicate of ``next_batch`` (closed batchers are not
    scripted here)."""
    q = b._q
    if not q:
        return False
    earliest = min((r.deadline for r in q if r.deadline is not None),
                   default=None)
    return (len(q) >= b.max_batch_size
            or now - q[0].enqueued_at >= b.max_wait_s
            or (earliest is not None
                and earliest - now <= b.deadline_guard_s))


def _script(seed, n_bursts=20):
    """(gap_s, payload shape, timeout_s or None) per arrival: seeded bursts
    of 1-30 requests (a few 7-wide poison payloads, some deadlines, some
    already expired), bursts apart by 1-12 ms."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_bursts):
        for k in range(int(rng.integers(1, 31))):
            gap = 0.0 if k else float(rng.choice([0.001, 0.002, 0.004,
                                                  0.012]))
            shape = (7,) if rng.random() < 0.05 else (6,)
            timeout = (None if rng.random() < 0.85
                       else float(rng.choice([0.0, 0.004, 0.02, 0.2])))
            out.append((gap, shape, timeout))
    return out


def _replay(mod, script, bucket_plan, max_queue, max_batch_size=32):
    """Run ``script`` through ``mod``'s batcher; returns the event log."""
    clock = Clock()
    b = mod.DynamicBatcher(max_batch_size=max_batch_size, max_wait_ms=3.0,
                           max_queue=max_queue, bucket_plan=bucket_plan,
                           clock=clock)
    log, reqs = [], []

    def ids(rs):
        return [int(r.payload[0]) for r in rs]

    def flush():
        while _due(b, clock()):
            batch = b.next_batch()
            log.append(("flush", ids(batch)))
            if batch and bucket_plan is not None:
                # what Server._execute pulls for a sub-bucket batch
                n = len(batch)
                bucket = next((x for x in sorted(bucket_plan) if x >= n),
                              max(bucket_plan))
                if n < bucket:
                    log.append(("topoff", ids(b.top_off(
                        bucket - n, like=batch[0].payload))))
            # a forming batch is dispatched; the service time elapses
            clock.t += 0.001

    for i, (gap, shape, timeout) in enumerate(script):
        clock.t += gap
        flush()
        payload = np.full(shape, i, np.float32)
        now = clock()
        r = mod.Request(payload, None if timeout is None else now + timeout,
                        now=now)
        reqs.append(r)
        try:
            b.submit(r)
        except Exception as e:  # the two packages' QueueFullError
            assert type(e).__name__ == "QueueFullError"
            log.append(("reject", i, e.retry_after_s))
        flush()
    for _ in range(200):  # let every wait window expire
        clock.t += 0.002
        flush()
    assert b.depth() == 0
    shed = [i for i, r in enumerate(reqs) if r.future.done()
            and type(r.future.exception()).__name__
            == "DeadlineExceededError"]
    return log, shed


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ragged", [True, False])
def test_flush_sequence_is_jax_exactly(seed, ragged):
    plan = [8, 16, 32] if ragged else None
    script = _script(seed)
    want = _replay(jbatcher, script, plan, max_queue=20)
    got = _replay(pbatcher, script, plan, max_queue=20)
    assert got == want
    log, shed = got
    kinds = {e[0] for e in log}
    # the script exercises every branch it claims to
    assert "flush" in kinds and "reject" in kinds and shed
    if ragged:
        assert "topoff" in kinds
        assert any(len(e[1]) in (8, 16) for e in log if e[0] == "flush")


# -- batcher-level flush cuts ------------------------------------------------

def _rows(n, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(dim,)).astype(np.float32) for _ in range(n)]


def test_ragged_flush_cuts_at_bucket_boundaries():
    b = DynamicBatcher(max_batch_size=32, max_wait_ms=1.0,
                       bucket_plan=[8, 16, 32])
    for r in _rows(20):
        b.submit(Request(r))
    # 20 waiting -> a zero-pad cut of 16, then the true residual of 4
    assert [len(b.next_batch()), len(b.next_batch())] == [16, 4]


def test_ragged_flush_caps_at_max_batch_size():
    b = DynamicBatcher(max_batch_size=4, max_wait_ms=1.0, bucket_plan=[8])
    for r in _rows(6):
        b.submit(Request(r))
    assert [len(b.next_batch()), len(b.next_batch())] == [4, 2]


def test_urgent_deadline_beyond_cut_rides_this_flush():
    b = DynamicBatcher(max_batch_size=32, max_wait_ms=10_000.0,
                       bucket_plan=[8, 16, 32])
    reqs = [Request(r) for r in _rows(20)]
    reqs[18].deadline = time.monotonic() + 5e-3  # inside the guard window
    for r in reqs:
        b.submit(r)
    batch = b.next_batch()
    assert len(batch) == 20 and reqs[18] in batch


def test_top_off_exactly_full_vs_one_over():
    b = DynamicBatcher(max_batch_size=8, max_wait_ms=1.0, bucket_plan=[8])
    for r in _rows(9):
        b.submit(Request(r))
    batch = b.next_batch()
    assert len(batch) == 8
    assert b.top_off(0, like=batch[0].payload) == []
    residual = b.next_batch()
    assert len(residual) == 1
    for r in _rows(3, seed=7):
        b.submit(Request(r))
    assert len(b.top_off(7, like=residual[0].payload)) == 3


def test_top_off_stops_at_stack_incompatible_payload():
    b = DynamicBatcher(max_batch_size=8, max_wait_ms=1.0, bucket_plan=[8])
    b.submit(Request(np.zeros((6,), np.float32)))
    poison = Request(np.zeros((7,), np.float32))
    b.submit(poison)
    b.submit(Request(np.zeros((6,), np.float32)))
    # FIFO: the pull stops AT the poison, neither taking nor skipping it
    assert len(b.top_off(8, like=np.zeros((6,), np.float32))) == 1
    assert b.depth() == 2 and not poison.future.done()


def test_deadline_shed_inside_partially_formed_batch():
    b = DynamicBatcher(max_batch_size=8, max_wait_ms=1.0, bucket_plan=[8])
    live1 = Request(np.zeros((6,), np.float32))
    expired = Request(np.zeros((6,), np.float32),
                      deadline=time.monotonic() - 1e-3)
    live2 = Request(np.zeros((6,), np.float32))
    for r in (live1, expired, live2):
        b.submit(r)
    assert b.top_off(8, like=live1.payload) == [live1, live2]
    with pytest.raises(DeadlineExceededError):
        expired.future.result(timeout=1)
    assert b.metrics.counters["serving.shed_deadline"] == 1


def test_queue_full_and_closed_admission():
    b = DynamicBatcher(max_batch_size=4, max_wait_ms=1_000.0, max_queue=2)
    for r in _rows(2):
        b.submit(Request(r))
    with pytest.raises(QueueFullError) as ei:
        b.submit(Request(_rows(1)[0]))
    # one batch period per max_batch_size waiting: 2/4 x the 1 s hint
    assert ei.value.retry_after_s == pytest.approx(0.5)
    b.close(drain=False)
    from sparkdl_tpu_torch.serving.errors import ServerClosedError

    with pytest.raises(ServerClosedError):
        b.submit(Request(_rows(1)[0]))
    assert b.next_batch() is None


def test_sparkdl_ragged_env_knob(monkeypatch):
    monkeypatch.delenv("SPARKDL_RAGGED", raising=False)
    assert ragged_enabled_from_env() is True
    for off in ("0", "false", "off", "no"):
        monkeypatch.setenv("SPARKDL_RAGGED", off)
        assert ragged_enabled_from_env() is False
        assert jbatcher.ragged_enabled_from_env() is False
    monkeypatch.setenv("SPARKDL_RAGGED", "1")
    assert ragged_enabled_from_env() is True


# -- the server's top-off -------------------------------------------------------

def _fn(m, x):
    return torch.tanh(x * 2.0 + 0.25)


def _want(r):
    return np.tanh(r * np.float32(2.0) + np.float32(0.25))


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def test_server_top_off_fills_forming_batch():
    """A sub-bucket flush forms, an injected ``batch.topoff`` sleep holds
    the worker before its pull, late arrivals land, and the pull absorbs
    them: one full-bucket dispatch, no pad rows."""
    rows = _rows(8)
    plan = faults.FaultPlan.parse("seed=13;batch.topoff:sleep:ms=150,times=1")
    with Server(_fn, max_batch_size=8, max_wait_ms=2_000, bucket_sizes=[8],
                max_inflight_batches=1, cache=False) as srv:
        srv.warmup(rows[0])
        with faults.active(plan):
            early = [srv.submit(r, timeout_ms=40) for r in rows[:3]]
            time.sleep(0.07)  # flushed by the deadline guard; held
            late = [srv.submit(r) for r in rows[3:]]
            outs = [f.result(timeout=60) for f in early + late]
        s = srv.metrics.summary()
    assert s["serving.batches"] == 1
    assert s["serving.topoff_rows"] == 5
    assert s["engine.rows"] - 8 == 8  # less the warm-up batch
    assert s.get("engine.pad_rows", 0) == 0
    for got, r in zip(outs, rows):
        np.testing.assert_allclose(got, _want(r), rtol=1e-6, atol=1e-6)


def test_injected_topoff_error_degrades_to_baseline_padding():
    rows = _rows(3)
    plan = faults.FaultPlan.parse("seed=13;batch.topoff:error:times=1")
    with Server(_fn, max_batch_size=8, max_wait_ms=10, bucket_sizes=[8],
                cache=False) as srv:
        with faults.active(plan):
            outs = [srv.submit(r).result(timeout=60) for r in rows]
        s = srv.metrics.summary()
    assert s["serving.topoff_aborted"] >= 1
    assert s["serving.completed"] == 3
    for got, r in zip(outs, rows):
        np.testing.assert_allclose(got, _want(r), rtol=1e-6, atol=1e-6)


def test_mixed_shape_base_batch_never_pulls_healthy_arrivals():
    good = np.zeros((6,), np.float32)
    poison = np.zeros((7,), np.float32)
    plan = faults.FaultPlan.parse("seed=13;batch.topoff:sleep:ms=150,times=1")
    with Server(_fn, max_batch_size=8, max_wait_ms=2_000, bucket_sizes=[8],
                max_inflight_batches=1, cache=False) as srv:
        with faults.active(plan):
            # the deadline guard flushes these two mixed shapes together:
            # the batch cannot stack, so it pulls nothing
            doomed = [srv.submit(good, timeout_ms=40),
                      srv.submit(poison, timeout_ms=40)]
            time.sleep(0.07)
            # its deadline flushes it while the doomed batch is held; a
            # deadline is judged at the flush, so the wait for the slot
            # does not shed it
            healthy = srv.submit(good, timeout_ms=100)
            for f in doomed:
                with pytest.raises(ValueError):
                    f.result(timeout=30)
            out = healthy.result(timeout=30)
    np.testing.assert_allclose(out, _want(good), rtol=1e-6, atol=1e-6)


def test_server_ragged_wiring():
    with Server(_fn, max_batch_size=8, bucket_sizes=[8], cache=False) as on:
        assert on._batcher.bucket_plan == on.bucket_sizes
        assert on.varz()["server"]["ragged"] is True
    with Server(_fn, max_batch_size=8, bucket_sizes=[8], ragged=False,
                cache=False) as off:
        assert off._batcher.bucket_plan is None
        assert off.varz()["server"]["ragged"] is False


def test_ragged_arrival_benchmark_headline():
    """Seeded mixed-size bursts over a sleep-wrapped server: fewer pad rows
    and a higher fill than flush-on-full, outputs bit for bit the same."""
    res = ragged_arrival_benchmark(n_bursts=5, gap_ms=50.0, dispatch_ms=4.0,
                                   max_wait_ms=20.0)
    assert res["bit_identical"], res
    assert res["ragged"]["rows"] == res["flush"]["rows"] == \
        res["n_requests"]
    assert res["pad_rows_saved"] > 0, res
    assert res["ragged"]["fill_mean"] > res["flush"]["fill_mean"], res


@pytest.mark.parametrize("plan, align", [([3, 5, 8], 1), ([3, 5, 8], 4),
                                         ([1, 2, 6, 7], 2), ([8], 8)])
def test_mesh_align_rounds_the_plan_as_jax(plan, align):
    """``align`` (the serving mesh's data axis) rounds a raw bucket plan up
    to its multiples, de-duplicated, as JAX's batcher does, and the ragged
    cuts then land on those buckets; ``bucket_plan(mesh=)`` rounds to the
    port's one-device mesh (data axis 1)."""
    from sparkdl_tpu_torch.parallel.mesh import get_mesh
    from sparkdl_tpu_torch.serving.server import bucket_plan

    p = DynamicBatcher(max_batch_size=8, bucket_plan=plan, align=align)
    j = jbatcher.DynamicBatcher(max_batch_size=8, bucket_plan=plan,
                                align=align)
    assert p.bucket_plan == j.bucket_plan and p.align == j.align
    cuts = []
    for b, req in ((DynamicBatcher, Request),
                   (jbatcher.DynamicBatcher, jbatcher.Request)):
        batcher = b(max_batch_size=8, max_wait_ms=1.0, bucket_plan=plan,
                    align=align)
        for r in _rows(7):
            batcher.submit(req(r))
        cut = []
        while sum(cut) < 7:
            cut.append(len(batcher.next_batch()))
        cuts.append(cut)
    assert cuts[0] == cuts[1]
    with sparkdl_tpu_torch.default_device("cpu"):
        assert bucket_plan(max(plan), plan, mesh=get_mesh()) == \
            sorted(set(plan))
