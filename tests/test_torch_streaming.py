"""The port's exactly-once streaming (``sparkdl_tpu_torch.streaming``) held
against the JAX package's on the CPU.

The same seeded chunks go through the JAX ``StreamScorer`` over its
``InferenceEngine`` (``tanh(x @ w)``, 6 -> 4, device batch 8) and through
the port's over the same weights: the port's assembled output equals its
own batch oracle (``map_batches`` over the same chunks) bit for bit, and
JAX's within 1e-6.  Chunk ids equal the JAX package's, each package reads
the other's journal (torn tail included), and on a model whose arithmetic
is exact in both, the two journals are equal record for record.  Then the
contracts of the JAX package's ``tests/test_stream_ingest.py``: sources,
journal edge cases, duplicate suppression, the crash between output and
commit, replay under a ``stream.resume`` fault, a flaky source, the stall
watchdog, ``health()``, a ``Server`` sink, the replay cache, output
ownership, and a real SIGKILL in a child process that imports only the
port.  Every port engine and server runs on the CPU.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import sparkdl_tpu.streaming as jstreaming
import sparkdl_tpu_torch
from sparkdl_tpu import faults as jfaults
from sparkdl_tpu.obs import flight as jflight
from sparkdl_tpu.parallel.engine import InferenceEngine as JaxEngine
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch import streaming
from sparkdl_tpu_torch.faults import FaultPlan
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.parallel.engine import InferenceEngine
from sparkdl_tpu_torch.parallel.pipeline import PipelineStageError
from sparkdl_tpu_torch.serving import InferenceCache, Server
from sparkdl_tpu_torch.streaming import (DirectorySource, Journal,
                                         MemorySource, StreamScorer,
                                         assemble_outputs, content_chunk_id,
                                         finish_directory_stream,
                                         write_directory_chunk)
from sparkdl_tpu_torch.utils.jsonl import read_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = dict(rtol=0, atol=1e-6)   # JAX vs port outputs, as the JAX test's


def _jfn(v, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ v["w"])


class Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.array(w)))


def _pfn(m, x):
    # x @ w as a broadcast multiply and a sum: a row's arithmetic is then
    # the same wherever it sits in a batch, and in every process
    return torch.tanh((x[..., :, None] * m.w).sum(-2))


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No fault plan leaks between tests, and both packages' recorders
    come back as they were."""
    for mod in (pflight, jflight):
        monkeypatch.setattr(mod, "_recorder", mod._recorder)
    pfaults.clear()
    jfaults.clear()
    yield
    pfaults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(7)
    return rng.normal(size=(6, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def engine(weights):
    return InferenceEngine(_pfn, Dense(weights), device_batch_size=8,
                           device="cpu")


@pytest.fixture(scope="module")
def jax_engine(weights):
    return JaxEngine(_jfn, {"w": weights}, device_batch_size=8)


@pytest.fixture(scope="module")
def payloads():
    rng = np.random.default_rng(11)
    return [rng.normal(size=(8, 6)).astype(np.float32) for _ in range(6)]


@pytest.fixture(scope="module")
def oracle(engine, payloads):
    """The batch half of the exactly-once check: one map_batches pass over
    the same chunks."""
    return np.concatenate(list(engine.map_batches(payloads, pipeline=False)))


def _scorer(sink, src, base, **kw):
    kw.setdefault("pipeline", False)
    return StreamScorer(sink, src,
                        journal_path=os.path.join(base, "journal.jsonl"),
                        out_dir=os.path.join(base, "out"), **kw)


def _assemble(base):
    return assemble_outputs(os.path.join(base, "journal.jsonl"),
                            os.path.join(base, "out"))


def _no_pipeline_threads():
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("sparkdl-pipeline", "sparkdl-serving"))]
    assert not left, left


# -- the package surface ---------------------------------------------------

def test_streaming_exports_jax_all_and_lazy_names():
    assert streaming.__all__ == jstreaming.__all__
    for name in streaming.__all__:
        assert hasattr(streaming, name), name
    assert sparkdl_tpu_torch.streaming is streaming
    assert sparkdl_tpu_torch.StreamScorer is StreamScorer
    assert {"streaming", "StreamScorer"} <= set(sparkdl_tpu_torch.__all__)
    assert (streaming.INTENT, streaming.OUTPUT, streaming.COMMIT) == (
        jstreaming.INTENT, jstreaming.OUTPUT, jstreaming.COMMIT)


# -- sources ---------------------------------------------------------------

def test_memory_source_ordered_ids_stable_across_seek_equal_to_jax():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(4, 3)) for _ in range(3)]
    src = MemorySource(chunks, finished=True)
    jsrc = jstreaming.MemorySource(chunks, finished=True)
    first = [src.poll() for _ in range(3)]
    assert [c.offset for c in first] == [0, 1, 2]
    assert [c.chunk_id for c in first] == [jsrc.poll().chunk_id
                                           for _ in range(3)]
    assert src.poll() is None and src.exhausted()
    src.seek(1)
    again = src.poll()
    assert again.chunk_id == first[1].chunk_id
    assert np.array_equal(again.payload, first[1].payload)
    assert len({c.chunk_id for c in first}) == 3
    with pytest.raises(ValueError, match="finished"):
        src.feed(chunks[0])
    with pytest.raises(ValueError, match="outside"):
        src.seek(4)


def test_directory_source_order_end_marker_seek(tmp_path):
    d = str(tmp_path / "in")
    rng = np.random.default_rng(1)
    chunks = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    write_directory_chunk(d, 0, chunks[0])
    src = DirectorySource(d)
    c0 = src.poll()
    assert c0.offset == 0 and np.array_equal(c0.payload, chunks[0])
    assert src.poll() is None and not src.exhausted()  # live, nothing yet
    write_directory_chunk(d, 1, chunks[1])
    write_directory_chunk(d, 2, chunks[2])
    finish_directory_stream(d)
    got = [src.poll() for _ in range(2)]
    assert [c.offset for c in got] == [1, 2]
    assert src.exhausted()
    src.seek(1)
    replay = src.poll()
    assert replay.chunk_id == got[0].chunk_id
    assert replay.chunk_id == content_chunk_id(1, chunks[1])
    # the JAX package's source reads the port producer's directory alike
    jsrc = jstreaming.DirectorySource(d)
    assert [jsrc.poll().chunk_id for _ in range(3)] == \
        [c0.chunk_id] + [c.chunk_id for c in got]
    assert jsrc.exhausted()
    assert sorted(os.listdir(d)) == ["_END"] + [
        f"chunk-{i:08d}.npy" for i in range(3)]


# -- journal edge cases ----------------------------------------------------

def test_journal_cold_start_empty(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    assert j.resume_offset() == 0
    assert j.committed_count() == 0 and j.uncommitted() == []
    assert j.recovered_torn_bytes == 0
    j.close()


def test_journal_torn_tail_truncated_on_restart(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = Journal(p)
    j.begin("c0", 0)
    j.record_output("c0", 0, "out-c0.npy", "d0")
    j.commit("c0", 0)
    j.begin("c1", 1)
    j.close()
    size = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(b'{"rec": "output", "chunk_id": "c1", "off')  # torn
    j2 = Journal(p)
    assert j2.recovered_torn_bytes > 0
    assert os.path.getsize(p) == size
    assert j2.is_committed("c0")
    assert j2.uncommitted() == [{"chunk_id": "c1", "offset": 1,
                                 "has_output": False}]
    assert j2.resume_offset() == 1
    j2.record_output("c1", 1, "out-c1.npy", "d1")
    j2.commit("c1", 1)
    j2.close()
    recs, valid = read_jsonl(p)
    assert recs[-1]["rec"] == "commit" and valid == os.path.getsize(p)


def test_journal_duplicate_commit_idempotent(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = Journal(p)
    j.begin("c0", 0)
    assert j.commit("c0", 0) is True
    assert j.commit("c0", 0) is False
    j.close()
    recs, _ = read_jsonl(p)
    assert sum(r["rec"] == "commit" for r in recs) == 1
    j2 = Journal(p)
    assert j2.commit("c0", 0) is False
    assert j2.committed_count() == 1
    j2.close()


def test_journal_resume_offset_skips_only_contiguous_prefix(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    for cid, off in (("c0", 0), ("c2", 2)):  # a hole at offset 1
        j.begin(cid, off)
        j.commit(cid, off)
    assert j.resume_offset() == 1
    assert j.is_committed("c2")
    assert j.committed_offsets() == [0, 2]
    j.close()


def test_journal_refuses_foreign_records(tmp_path):
    p = str(tmp_path / "j.jsonl")
    with open(p, "w") as f:
        f.write('{"rec": "intent", "chunk_id": "c0", "offset": 0}\n')
        f.write('{"rec": "bogus", "chunk_id": "c0", "offset": 0}\n')
    with pytest.raises(streaming.JournalFormatError, match="bad journal"):
        Journal(p)


def _write_history(journal_cls, path):
    """Two committed chunks, one with an output and no commit, one intent
    only, then a torn tail."""
    j = journal_cls(path)
    for k in range(2):
        j.begin(f"c{k}", k)
        j.record_output(f"c{k}", k, f"out-c{k}.npy", f"d{k}")
        j.commit(f"c{k}", k)
    j.begin("c2", 2)
    j.record_output("c2", 2, "out-c2.npy", "d2")
    j.begin("c3", 3)
    j.close()
    with open(path, "ab") as f:
        f.write(b'{"rec": "commit", "chunk_id": "c2", "of')


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journals_read_across_packages(tmp_path, writer):
    """A journal written by either package (torn tail included) reads the
    same through both packages' Journal: resume offset, the replay set,
    the committed ids and the stats."""
    src = str(tmp_path / "w.jsonl")
    _write_history(jstreaming.Journal if writer == "jax" else Journal, src)
    views = {}
    for reader, cls in (("jax", jstreaming.Journal), ("port", Journal)):
        p = str(tmp_path / f"{reader}.jsonl")
        shutil.copyfile(src, p)
        j = cls(p)
        stats = j.stats()
        stats.pop("path")
        views[reader] = dict(
            resume=j.resume_offset(), uncommitted=j.uncommitted(),
            committed=j.committed_ids(), stats=stats,
            output=j.output_record("c2"), seen=j.seen("c3"))
        j.close()
    assert views["port"] == views["jax"]
    assert views["port"]["resume"] == 2
    assert views["port"]["stats"]["recovered_torn_bytes"] > 0
    assert [r["chunk_id"] for r in views["port"]["uncommitted"]] == \
        ["c2", "c3"]


# -- StreamScorer ----------------------------------------------------------

@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_exactly_once_matches_oracle_and_jax(engine, jax_engine, payloads,
                                             oracle, tmp_path, pipeline):
    base = str(tmp_path / "port")
    sc = _scorer(engine, MemorySource(payloads, finished=True), base,
                 pipeline=pipeline)
    summary = sc.run()
    assert summary["chunks_scored"] == len(payloads)
    assert summary["duplicates_suppressed"] == 0
    got = _assemble(base)
    assert np.array_equal(got, oracle)
    m = sc.metrics
    assert m.counters["stream.chunks"] == len(payloads)
    assert m.counters["stream.commits"] == len(payloads)
    assert m.gauges["stream.watermark"] == len(payloads)
    h = sc.health()
    assert h["state"] == "ready" and h["watermark"] == len(payloads)
    sc.close()
    assert sc.health()["state"] == "closed" and not sc.health()["live"]
    _no_pipeline_threads()
    # the JAX package's scorer over the same chunks
    jbase = str(tmp_path / "jax")
    jsc = jstreaming.StreamScorer(
        jax_engine, jstreaming.MemorySource(payloads, finished=True),
        journal_path=os.path.join(jbase, "journal.jsonl"),
        out_dir=os.path.join(jbase, "out"), pipeline=pipeline)
    jsummary = jsc.run()
    jsc.close()
    assert summary == jsummary
    want = jstreaming.assemble_outputs(os.path.join(jbase, "journal.jsonl"),
                                       os.path.join(jbase, "out"))
    np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_chunks_larger_than_the_device_batch(engine, tmp_path, pipeline):
    """Chunks of 20 rows over a device batch of 8 (three pieces each, the
    last ragged): each chunk is committed once its pieces are back."""
    rng = np.random.default_rng(12)
    big = [rng.normal(size=(20, 6)).astype(np.float32) for _ in range(4)]
    want = np.concatenate(list(engine.map_batches(big, pipeline=False)))
    base = str(tmp_path)
    sc = _scorer(engine, MemorySource(big, finished=True), base,
                 pipeline=pipeline)
    assert sc.run()["chunks_scored"] == 4
    sc.close()
    assert np.array_equal(_assemble(base), want)
    j = Journal(os.path.join(base, "journal.jsonl"))
    shapes = [np.load(os.path.join(base, "out",
                                   j.output_record(c)["artifact"])).shape
              for c in j.committed_ids()]
    j.close()
    assert shapes == [(20, 4)] * 4


def test_chunk_without_rows_is_refused(engine, tmp_path):
    sc = _scorer(engine, MemorySource([np.zeros((0, 6), np.float32)],
                                      finished=True), str(tmp_path))
    with pytest.raises(ValueError, match="no rows"):
        sc.run()
    sc.close()


def test_duplicate_delivery_suppressed_by_id(engine, payloads, oracle,
                                             tmp_path):
    """Offset 1 committed out of band (the contiguous prefix stops at 0):
    the seeked source delivers it again and it is suppressed by id."""
    from sparkdl_tpu_torch.streaming.runner import _write_artifact_atomic
    from sparkdl_tpu_torch.utils.digest import array_digest

    base = str(tmp_path)
    cid1 = content_chunk_id(1, payloads[1])
    j = Journal(os.path.join(base, "journal.jsonl"))
    j.begin(cid1, 1)
    out1 = list(engine.map_batches([payloads[1]], pipeline=False))[0]
    os.makedirs(os.path.join(base, "out"), exist_ok=True)
    _write_artifact_atomic(os.path.join(base, "out", f"out-{cid1}.npy"),
                           out1)
    j.record_output(cid1, 1, f"out-{cid1}.npy", array_digest(out1))
    j.commit(cid1, 1)
    j.close()
    sc = _scorer(engine, MemorySource(payloads, finished=True), base)
    summary = sc.run()
    assert summary["resume_offset"] == 0
    assert summary["duplicates_suppressed"] == 1
    assert summary["chunks_scored"] == len(payloads) - 1
    assert sc.metrics.counters["stream.duplicates_suppressed"] == 1
    assert np.array_equal(_assemble(base), oracle)
    sc.close()


def _commits_and_artifacts(base):
    recs, _ = read_jsonl(os.path.join(base, "journal.jsonl"))
    commits = [r["chunk_id"] for r in recs if r["rec"] == "commit"]
    arts = [f for f in os.listdir(os.path.join(base, "out"))
            if f.endswith(".npy")]
    return commits, arts


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_crash_between_output_and_commit_then_resume(engine, payloads,
                                                     oracle, tmp_path,
                                                     pipeline):
    """``stream.commit`` kills run 1 after the output artifact is durable
    and before its commit; the pipelined run stops its threads; run 2
    replays the uncommitted suffix to exactly-once output."""
    base = str(tmp_path)
    sc = _scorer(engine, MemorySource(payloads, finished=True), base,
                 pipeline=pipeline)
    with pfaults.active(FaultPlan.parse(
            "stream.commit:error:exc=fatal,at=3")) as plan:
        with pytest.raises(pfaults.InjectedFatalError):
            sc.run()
        assert plan.fired("stream.commit") == 1
    _no_pipeline_threads()
    sc.close()
    j = Journal(os.path.join(base, "journal.jsonl"))
    assert j.resume_offset() == 2
    pending = j.uncommitted()
    assert any(r["offset"] == 2 and r["has_output"] for r in pending)
    # every intent left behind lies at or past the resume offset: the
    # restart replays it
    assert all(r["offset"] >= j.resume_offset() for r in pending)
    j.close()
    sc2 = _scorer(engine, MemorySource(payloads, finished=True), base,
                  pipeline=pipeline)
    summary = sc2.run()
    assert summary["resume_offset"] == 2
    assert summary["redeliveries"] >= 1
    assert sc2.metrics.counters["stream.redeliveries"] >= 1
    assert np.array_equal(_assemble(base), oracle)
    commits, arts = _commits_and_artifacts(base)
    assert len(commits) == len(set(commits)) == len(payloads)
    assert len(arts) == len(payloads)
    sc2.close()


def test_replay_survives_stream_resume_injection(engine, payloads, oracle,
                                                 tmp_path):
    """``stream.resume`` fires at replay time: a restart that dies again
    while redelivering still converges on the next clean restart."""
    base = str(tmp_path)
    sc = _scorer(engine, MemorySource(payloads, finished=True), base)
    with pfaults.active(FaultPlan.parse(
            "stream.commit:error:exc=fatal,at=2")):
        with pytest.raises(pfaults.InjectedFatalError):
            sc.run()
    sc.close()
    with pfaults.active(FaultPlan.parse(
            "stream.resume:error:exc=fatal,at=1")) as plan:
        sc2 = _scorer(engine, MemorySource(payloads, finished=True), base)
        with pytest.raises(pfaults.InjectedFatalError):
            sc2.run()
        assert plan.fired("stream.resume") == 1
    sc2.close()
    sc3 = _scorer(engine, MemorySource(payloads, finished=True), base)
    assert sc3.run()["redeliveries"] >= 1
    assert np.array_equal(_assemble(base), oracle)
    sc3.close()


def test_source_transient_fault_absorbed_by_repoll(engine, payloads, oracle,
                                                   tmp_path):
    base = str(tmp_path)
    sc = _scorer(engine, MemorySource(payloads, finished=True), base)
    with pfaults.active(FaultPlan.parse(
            "seed=5;stream.source:error:exc=transient,at=2")) as plan:
        summary = sc.run()
        assert plan.fired("stream.source") == 1
    assert summary["chunks_scored"] == len(payloads)
    assert sc.metrics.counters["stream.source_errors"] == 1
    assert np.array_equal(_assemble(base), oracle)
    states = [t["state"] for t in sc.health()["transitions"]]
    assert "degraded" in states and sc.health()["state"] == "ready"
    sc.close()


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_stall_watchdog_degraded_then_recovered(engine, payloads, tmp_path,
                                                pipeline):
    """A source silent past the deadline: degraded (last_error, a
    transition, ``stream.stall``), the seeded re-poll keeps the run alive,
    the late chunk recovers it (``stream.stall_recovered``), no thread
    is left."""
    recorder = pflight.configure(enabled=True, capacity=256)
    base = str(tmp_path)
    src = MemorySource([payloads[0]])  # live: not finished yet
    sc = _scorer(engine, src, base, stall_deadline_s=0.05,
                 pipeline=pipeline)
    mid_state = {}

    def feeder():
        time.sleep(0.35)
        mid_state.update(sc.health())
        src.feed(payloads[1])
        src.finish()

    t = threading.Thread(target=feeder)
    t.start()
    summary = sc.run()
    t.join()
    assert summary["chunks_scored"] == 2
    assert mid_state["state"] == "degraded"
    assert mid_state["lag_s"] > 0.05
    assert mid_state["last_error"]["type"] == "StreamStallError"
    h = sc.health()
    assert h["state"] == "ready" and h["watermark"] == 2
    assert [x["state"] for x in h["transitions"]][-2:] == ["degraded",
                                                          "ready"]
    assert sc.metrics.counters["stream.stalls"] >= 1
    assert sc.metrics.counters["stream.stall_recoveries"] >= 1
    events = [e["event"] for e in recorder.snapshot()]
    assert {"stream.stall", "stream.stall_recovered",
            "stream.commit"} <= set(events)
    assert events.index("stream.stall") < events.index(
        "stream.stall_recovered")
    _no_pipeline_threads()
    sc.close()


def test_health_mirrors_server_contract_and_jax_keys(engine, jax_engine,
                                                     payloads, tmp_path):
    """health() carries the core keys of Server.health() with the same
    state vocabulary, plus watermark / lag_s / source_exhausted: the same
    keys as the JAX package's scorer."""
    sc = _scorer(engine, MemorySource(payloads[:1], finished=True),
                 str(tmp_path / "p"))
    jsc = jstreaming.StreamScorer(
        jax_engine, jstreaming.MemorySource(payloads[:1], finished=True),
        journal_path=str(tmp_path / "j" / "j.jsonl"),
        out_dir=str(tmp_path / "j" / "out"))
    h = sc.health()
    assert set(h) == set(jsc.health())
    for key in ("live", "state", "last_error", "transitions"):
        assert key in h
    assert h["state"] in ("ready", "degraded", "closed")
    assert h["transitions"][0]["state"] == "ready"
    assert {"watermark", "lag_s", "source_exhausted"} <= set(h)
    json.dumps(h)
    sc.run()
    assert sc.health()["source_exhausted"] is True
    assert sc.health()["lag_s"] == 0.0
    sc.close()
    jsc.close()
    assert sc.health()["state"] == "closed"


def test_serving_sink_rides_online_queue(engine, weights, payloads, oracle,
                                         tmp_path):
    """A port ``Server`` as the sink: each chunk's rows ride the online
    queue; the assembled output is the engine sink's within 1e-6."""
    base = str(tmp_path)
    with Server(_pfn, Dense(weights), max_batch_size=8, max_wait_ms=1.0,
                cache=False) as srv:
        sc = _scorer(srv, MemorySource(payloads[:3], finished=True), base)
        summary = sc.run()
        assert summary["chunks_scored"] == 3
        got = _assemble(base)
        assert got.shape == (24, 4)
        np.testing.assert_allclose(got, oracle[:24], **JAX_TOL)
        sc.close()
    _no_pipeline_threads()


def test_replay_cache_short_circuits_redispatch(engine, payloads, oracle,
                                                tmp_path):
    """With a shared cache namespace, the replay after a commit fault in
    the same process commits the cached output with no second dispatch."""
    base = str(tmp_path)
    cache = InferenceCache()
    ns = ("stream-test",)
    sc = _scorer(engine, MemorySource(payloads, finished=True), base,
                 cache=cache, cache_namespace=ns)
    with pfaults.active(FaultPlan.parse(
            "stream.commit:error:exc=fatal,at=3")):
        with pytest.raises(pfaults.InjectedFatalError):
            sc.run()
    sc.close()
    rows = []
    real = engine.map_batches

    def counted(batches, **kw):
        def tally():
            for b in batches:
                rows.append(len(b))
                yield b
        return real(tally(), **kw)

    engine.map_batches = counted
    try:
        sc2 = _scorer(engine, MemorySource(payloads, finished=True), base,
                      cache=cache, cache_namespace=ns)
        summary = sc2.run()
    finally:
        del engine.map_batches
    # run 1 journaled intents ahead of its commits (the window): offset 2
    # was scored and cached, the others after it only begun
    assert summary["resume_offset"] == 2
    assert summary["cache_hits"] == 1
    assert summary["redeliveries"] >= 1
    assert sc2.metrics.counters["stream.cache_hits"] == 1
    assert summary["chunks_scored"] == len(payloads) - 2
    # offset 2 never reached the engine again
    assert rows == [8] * (len(payloads) - 3)
    assert np.array_equal(_assemble(base), oracle)
    sc2.close()


def test_outputs_own_their_memory(engine, payloads, oracle, tmp_path):
    """Artifacts, cache entries and digests never alias a buffer that a
    later dispatch or the caller reuses: the outputs handed to the commit
    path and the source payloads are overwritten after the run, and the
    assembled result and the cached rows still read the oracle."""
    base = str(tmp_path)
    seen = []
    real = engine.map_batches

    def keep(batches, **kw):
        for out in real(batches, **kw):
            seen.append(out)
            yield out

    engine.map_batches = keep
    mine = [p.copy() for p in payloads]
    cache = InferenceCache()
    try:
        sc = _scorer(engine, MemorySource(mine, finished=True), base,
                     pipeline=True, cache=cache,
                     cache_namespace=("own",))
        sc.run()
    finally:
        del engine.map_batches
    for arr in seen + mine:
        arr[...] = 7.0
    got = _assemble(base)
    assert np.array_equal(got, oracle)
    got[...] = 0.0
    assert np.array_equal(_assemble(base), oracle)
    for k in range(len(payloads)):
        cid = content_chunk_id(k, payloads[k])
        assert np.array_equal(cache.get(("own", cid)),
                              oracle[8 * k:8 * (k + 1)])
    sc.close()


def test_journal_write_error_surfaces_as_prepare_stage_error(
        engine, payloads, tmp_path):
    """On the pipelined path the intent is journaled on the prepare
    thread: an append that cannot reach the disk reaches run()'s caller as
    a PipelineStageError naming ``prepare``, and no thread is left."""
    base = str(tmp_path)
    sc = _scorer(engine, MemorySource(payloads, finished=True), base,
                 pipeline=True)
    writer = sc.journal._writer
    real = writer.write_line
    intents = []

    def failing(line):  # the third intent cannot reach the disk
        if json.loads(line)["rec"] == "intent":
            intents.append(line)
            if len(intents) == 3:
                return False
        return real(line)

    writer.write_line = failing
    with pytest.raises(PipelineStageError) as ei:
        sc.run()
    assert ei.value.stage == "prepare"
    assert isinstance(ei.value.__cause__, streaming.JournalWriteError)
    assert sc.health()["state"] == "degraded"
    _no_pipeline_threads()
    sc.close()


# -- the same stream through both packages ----------------------------------

def _jscale(v, x):
    return x * v["s"]


class Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("s", torch.tensor(2.0))


def _pscale(m, x):
    return x * m.s


def test_journal_records_and_tool_summaries_equal_to_jax(payloads,
                                                         tmp_path):
    """On a model exact in both packages (x * 2), the two scorers write
    the same journal record for record (kinds, chunk ids, offsets,
    artifact names, digests) and the same artifacts; the port's journal
    tool summarises either journal as the JAX package's tool does."""
    from tools import port_stream_journal, stream_journal

    pbase, jbase = str(tmp_path / "port"), str(tmp_path / "jax")
    peng = InferenceEngine(_pscale, Scale(), device_batch_size=8)
    jeng = JaxEngine(_jscale, {"s": np.float32(2.0)}, device_batch_size=8)
    with pfaults.active(FaultPlan.parse(
            "stream.commit:error:exc=fatal,at=4")):
        sc = _scorer(peng, MemorySource(payloads, finished=True), pbase)
        with pytest.raises(pfaults.InjectedFatalError):
            sc.run()
        sc.close()
    with jfaults.active(jfaults.FaultPlan.parse(
            "stream.commit:error:exc=fatal,at=4")):
        jsc = jstreaming.StreamScorer(
            jeng, jstreaming.MemorySource(payloads, finished=True),
            journal_path=os.path.join(jbase, "journal.jsonl"),
            out_dir=os.path.join(jbase, "out"), pipeline=False)
        with pytest.raises(jfaults.InjectedFatalError):
            jsc.run()
        jsc.close()
    for path in (os.path.join(pbase, "journal.jsonl"),
                 os.path.join(jbase, "journal.jsonl")):
        mine = port_stream_journal.summarize(path)
        assert mine == stream_journal.summarize(path)
        assert mine["resume_offset"] == 3
        assert mine["uncommitted"][0] == dict(
            chunk_id=content_chunk_id(3, payloads[3]), offset=3,
            has_output=True)
        assert port_stream_journal.main([path, "--json"]) == 1
    precs, _ = read_jsonl(os.path.join(pbase, "journal.jsonl"))
    jrecs, _ = read_jsonl(os.path.join(jbase, "journal.jsonl"))
    assert precs == jrecs
    assert {r["rec"] for r in precs} == {"intent", "output", "commit"}
    for rec in precs:
        if rec["rec"] == "output":
            a = np.load(os.path.join(pbase, "out", rec["artifact"]))
            b = np.load(os.path.join(jbase, "out", rec["artifact"]))
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # both resume to the full stream, and the records stay equal
    sc = _scorer(peng, MemorySource(payloads, finished=True), pbase)
    sc.run()
    sc.close()
    jsc = jstreaming.StreamScorer(
        jeng, jstreaming.MemorySource(payloads, finished=True),
        journal_path=os.path.join(jbase, "journal.jsonl"),
        out_dir=os.path.join(jbase, "out"), pipeline=False)
    jsc.run()
    jsc.close()
    precs, _ = read_jsonl(os.path.join(pbase, "journal.jsonl"))
    jrecs, _ = read_jsonl(os.path.join(jbase, "journal.jsonl"))
    assert precs == jrecs
    assert port_stream_journal.main(
        [os.path.join(pbase, "journal.jsonl")]) == 0


def test_port_journal_tool_exit_codes(tmp_path, capsys):
    from tools.port_stream_journal import main

    p = str(tmp_path / "j.jsonl")
    j = Journal(p)
    j.begin("c0", 0)
    j.commit("c0", 0)
    j.close()
    assert main([p]) == 0
    assert "resume at    offset 1" in capsys.readouterr().out
    with open(p, "ab") as f:
        f.write(b'{"rec": "intent", "chunk_id": "c1", "offset": 1}\n')
        f.write(b'{"rec": "commit", "chu')
    assert main([p, "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["uncommitted"][0]["chunk_id"] == "c1"
    assert out["torn_tail_bytes"] > 0
    with open(p, "wb") as f:
        f.write(b'{"rec": "intent"}\nnot json\n{"rec": "commit"}\n')
    assert main([p]) == 2


# -- the headline chaos: SIGKILL between output write and commit -----------

_CHILD = r"""
import json, os, signal, sys
import numpy as np
import torch
from sparkdl_tpu_torch import faults, streaming
from sparkdl_tpu_torch.parallel.engine import InferenceEngine

base = sys.argv[1]


class Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(w))


def fn(m, x):
    return torch.tanh((x[..., :, None] * m.w).sum(-2))


rng = np.random.default_rng(7)
w = rng.normal(size=(6, 4)).astype(np.float32)
eng = InferenceEngine(fn, Dense(w), device_batch_size=8, device="cpu")
src = streaming.DirectorySource(os.path.join(base, "in"))
sc = streaming.StreamScorer(
    eng, src, journal_path=os.path.join(base, "journal.jsonl"),
    out_dir=os.path.join(base, "out"), pipeline=True,
    stall_deadline_s=2.0)
try:
    summary = sc.run()
except faults.InjectedFatalError:
    # a real SIGKILL at the crash point the fault marks: no finally, no
    # atexit, no flush; only what fsync made durable survives
    os.kill(os.getpid(), signal.SIGKILL)
print(json.dumps({"summary": summary, "health": sc.health(),
                  "jax": "jax" in sys.modules,
                  "sparkdl_tpu": "sparkdl_tpu" in sys.modules}))
"""


def test_sigkill_between_output_and_commit_exactly_once(payloads, oracle,
                                                        tmp_path):
    """SIGKILL the scoring process (pipelined) between an output artifact
    and its commit, restart from the journal: the output is exactly-once,
    bit for bit the batch oracle, and the lag and watermark recover.  The
    children import torch and the port only."""
    base = str(tmp_path)
    indir = os.path.join(base, "in")
    for i, p in enumerate(payloads):
        write_directory_chunk(indir, i, p)
    finish_directory_stream(indir)
    env = dict(os.environ)
    env.update({"CUDA_VISIBLE_DEVICES": "-1", "SPARKDL_TRACE": "0",
                "SPARKDL_FAULTS": "stream.commit:error:exc=fatal,at=4"})
    r1 = subprocess.run([sys.executable, "-c", _CHILD, base], cwd=REPO,
                        env=env, capture_output=True, text=True,
                        timeout=120)
    assert r1.returncode == -9, (r1.returncode, r1.stderr[-2000:])
    j = Journal(os.path.join(base, "journal.jsonl"))
    assert j.resume_offset() == 3
    assert any(r["offset"] == 3 and r["has_output"]
               for r in j.uncommitted())
    j.close()
    env.pop("SPARKDL_FAULTS")
    r2 = subprocess.run([sys.executable, "-c", _CHILD, base], cwd=REPO,
                        env=env, capture_output=True, text=True,
                        timeout=120)
    assert r2.returncode == 0, r2.stderr[-2000:]
    rec = json.loads(r2.stdout.strip().splitlines()[-1])
    assert rec["jax"] is False and rec["sparkdl_tpu"] is False
    assert rec["summary"]["resume_offset"] == 3
    assert rec["summary"]["redeliveries"] >= 1
    assert rec["summary"]["committed_total"] == len(payloads)
    assert rec["health"]["state"] == "ready"
    assert rec["health"]["watermark"] == len(payloads)
    assert rec["health"]["lag_s"] == 0.0
    assert np.array_equal(_assemble(base), oracle)
    commits, arts = _commits_and_artifacts(base)
    assert len(commits) == len(set(commits)) == len(payloads)
    assert len(arts) == len(payloads)
