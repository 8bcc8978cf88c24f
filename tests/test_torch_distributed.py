"""The port's multi-process layer (``parallel/distributed.py`` and the
fits' global-batch rules in ``parallel/train.py``) held against the JAX
package's on the CPU.

``shard_files``, ``local_batch_size`` and the one-process ``initialize``
no-op equal JAX's.  One two-process test spawns two ranks over gloo
(``tests/_torch_dist_worker.py``, torch and the port only) with unequal
shards and runs, in one group: the in-memory fit (checkpointed, rank 0
writes), ``steps_per_execution=2``, the stream fit with a pinned
``steps_per_epoch``, ``train_fn`` + ``stats`` (global-batch BatchNorm
statistics) and the zero-row rank, which raises on both ranks.  Each fit
is held to JAX's ``make_train_step`` / ``make_train_step_with_stats``
stepped here on the concatenated global batches, built with JAX's own
``_epoch_batches`` / ``_stream_epoch_batches`` from each rank's shard:
losses within rtol 1e-5, params within rtol 1e-4 / atol 1e-6; the two
ranks agree within rtol 1e-6 / atol 1e-7.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from sparkdl_tpu.parallel import distributed as jdist
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu_torch.parallel import distributed
from tests import _torch_dist_worker as worker

LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
RANK_TOL = dict(rtol=1e-6, atol=1e-7)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("index, count", [(0, 1), (0, 3), (2, 3), (1, 4)])
def test_shard_files_and_local_batch_equal_jax(index, count):
    paths = [f"/data/img_{i:02d}.jpg" for i in (7, 3, 11, 0, 5, 9, 1)]
    assert distributed.shard_files(paths, index, count) == \
        jdist.shard_files(paths, index, count)
    for batch in (count, 4 * count, 12):
        if batch % count:
            with pytest.raises(ValueError, match="not divisible"):
                distributed.local_batch_size(batch, count)
            with pytest.raises(ValueError, match="not divisible"):
                jdist.local_batch_size(batch, count)
        else:
            assert distributed.local_batch_size(batch, count) == \
                jdist.local_batch_size(batch, count)


def test_one_process_defaults_and_initialize_noop():
    """Outside a group: rank 0 of 1, and ``initialize`` is a no-op on the
    same arguments as JAX's; bad shard arguments raise alike."""
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.backend() is None
    for kwargs in ({}, {"num_processes": 1}, {"num_processes": 0}):
        assert distributed.initialize(**kwargs) is False
        assert jdist.initialize(**kwargs) is False
    assert distributed.allgather_ints(7).tolist() == [7]
    for idx, cnt in ((0, 0), (3, 3), (-1, 2)):
        with pytest.raises(ValueError):
            distributed.shard_files(["a"], idx, cnt)
        with pytest.raises(ValueError):
            jdist.shard_files(["a"], idx, cnt)
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("localhost:1", 2)


def _run_ranks(tmp_path, world=2, timeout_s=120):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"rank_{r}.json") for r in range(world)]
    ckpt = str(tmp_path / "ckpt")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "_torch_dist_worker.py"),
                 str(r), str(world), str(port), outs[r], ckpt],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for p in procs:
            stdout, _ = p.communicate(timeout=timeout_s)
            assert p.returncode == 0, stdout.decode(errors="replace")[-4000:]
    finally:
        for p in procs:
            p.kill()
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results, ckpt


def _ce(logits, yb):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, yb.astype(jnp.int32))


def _jpredict(p, xb):
    return xb @ p["w"] + p["b"]


def _jbn_train(v, xb):
    p, s = v["params"], v["batch_stats"]
    h = xb @ p["w1"]
    mean = jnp.mean(h, axis=0)
    var = jnp.maximum(jnp.mean(h * h, axis=0) - mean * mean, 0.0)
    hn = (h - mean) * (jax.lax.rsqrt(var + worker.BN_EPS) * p["scale"]) \
        + p["bias"]
    m = worker.BN_MOMENTUM
    new = {"mean": (1 - m) * s["mean"] + m * mean,
           "var": (1 - m) * s["var"] + m * var}
    return jax.nn.relu(hn) @ p["w2"], new


def _global_batches(per_rank_epochs):
    """Concatenate the ranks' batches of each step (rank order)."""
    for steps in zip(*per_rank_epochs):
        yield (np.concatenate([s[0] for s in steps]),
               np.concatenate([s[1] for s in steps]))


def _oracle(epoch_batches, params, stats=None):
    """JAX's step over the global batches of every epoch: (losses per
    epoch, fitted params[, stats])."""
    opt = optax.sgd(0.1)
    if stats is None:
        step = jtrain.make_train_step(_jpredict, _ce, opt, cache=False)
        p, o = step.put_state(params, opt.init(params))
    else:
        step = jtrain.make_train_step_with_stats(_jbn_train, _ce, opt,
                                                 cache=False)
        p, s, o = step.put_state(params, stats, opt.init(params))
    epoch_losses = []
    for epoch in range(worker.EPOCHS):
        losses = []
        for bx, by in epoch_batches(epoch):
            bx, by = step.put_batch(bx, by)
            if stats is None:
                p, o, lval = step(p, o, bx, by)
            else:
                p, s, o, lval = step(p, s, o, bx, by)
            losses.append(float(lval))
        epoch_losses.append(float(np.mean(losses)))
    host = jax.tree_util.tree_map(np.asarray, p)
    if stats is None:
        return epoch_losses, host
    return epoch_losses, host, jax.tree_util.tree_map(np.asarray, s)


def test_two_process_gloo_fits_match_the_jax_oracle(tmp_path):
    results, ckpt = _run_ranks(tmp_path)
    parts, params, bn_params, bn_stats = worker.shards()
    r0, r1 = results
    for r in results:
        assert r["process_count"] == 2 and r["backend"] == "gloo"
        assert r["mesh_shape"] == {"data": 2, "model": 1}
    local = worker.GLOBAL_BATCH // 2
    steps = -(-16 // worker.GLOBAL_BATCH)  # all-gathered global rows
    # the step mode on the CPU is eager, and every rank ran every step
    assert r0["arrays"]["eager"] == r1["arrays"]["eager"] == 1
    assert r0["arrays"]["steps"] == steps * worker.EPOCHS
    for mode in ("arrays", "spe", "stream"):
        for key in ("losses", "w", "b"):
            np.testing.assert_allclose(r0[mode][key], r1[mode][key],
                                       **RANK_TOL)
    np.testing.assert_allclose(r0["spe"]["losses"], r0["arrays"]["losses"],
                               **LOSS_TOL)

    # in-memory fit: JAX's own per-rank batches, concatenated
    def arrays(epoch):
        return _global_batches([list(jtrain._epoch_batches(
            xr, yr, local, epoch, True, 0, num_steps=steps))
            for xr, yr in parts])

    want_losses, want = _oracle(arrays, params)
    for mode in ("arrays", "spe"):
        np.testing.assert_allclose(r0[mode]["losses"], want_losses,
                                   **LOSS_TOL)
        np.testing.assert_allclose(r0[mode]["w"], want["w"], **PARAM_TOL)
        np.testing.assert_allclose(r0[mode]["b"], want["b"], **PARAM_TOL)

    # the stream fit: each rank's chunks, pinned steps
    def stream(epoch):
        per_rank = []
        for rank, (xr, yr) in enumerate(parts):
            chunks, off = [], 0
            for size in worker.stream_chunks(rank):
                chunks.append((xr[off:off + size], yr[off:off + size]))
                off += size
            per_rank.append(list(jtrain._stream_epoch_batches(
                chunks, local, num_steps=worker.STREAM_STEPS)))
        return _global_batches(per_rank)

    want_losses, want = _oracle(stream, params)
    np.testing.assert_allclose(r0["stream"]["losses"], want_losses,
                               **LOSS_TOL)
    np.testing.assert_allclose(r0["stream"]["w"], want["w"], **PARAM_TOL)

    # global-batch BatchNorm statistics (shuffle off)
    def ordered(epoch):
        return _global_batches([list(jtrain._epoch_batches(
            xr, yr, local, epoch, False, 0, num_steps=steps))
            for xr, yr in parts])

    want_losses, want, want_stats = _oracle(ordered, bn_params, bn_stats)
    for r in results:
        np.testing.assert_allclose(r["stats"]["losses"], want_losses,
                                   **LOSS_TOL)
        for k in want:
            np.testing.assert_allclose(r["stats"]["params"][k], want[k],
                                       **PARAM_TOL)
        for k in want_stats:
            np.testing.assert_allclose(r["stats"]["batch_stats"][k],
                                       want_stats[k], **PARAM_TOL)
    for k in want_stats:
        np.testing.assert_allclose(r0["stats"]["batch_stats"][k],
                                   r1["stats"]["batch_stats"][k], **RANK_TOL)

    # a zero-row rank raises on both ranks (the run ended: no hang)
    for r in results:
        assert len(r["zero_row_errors"]) == 2
        assert "requires >=1 row on every rank" in r["zero_row_errors"][0]
        assert "first-chunk rows per rank: [" in r["zero_row_errors"][1]
    # single writer: each epoch saved exactly once, by rank 0
    assert sorted(os.listdir(ckpt)) == [
        f"epoch_{e:06d}" for e in range(1, worker.EPOCHS + 1)]
