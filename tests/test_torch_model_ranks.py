"""A model axis that spans processes (``parallel/mesh.py local_rows``,
``parallel/distributed.py mesh_groups``, ``parallel/shard.py``'s
``RowSplit`` / ``_RowGather`` / ``_RowInput``, ``parallel/train.py``'s
column-group step) held against the JAX package on the CPU.

Four gloo ranks of one CPU slot each are spawned once
(``tests/_torch_model_ranks_worker.py``, torch and the port only) on
``get_mesh(model_parallel=2)``: data 2 x model 2, rows {0, 1} and {2, 3},
column groups {0, 2} and {1, 3}, each rank holding one shard of every
split weight (layout (iii)).  ``test_torch_rank_slots.py`` runs the same
cases on its two ranks of two slots with ``model_parallel=4`` (layout
(ii)) and checks them with this file's ``check_*`` functions.

JAX's oracle is one JAX process on the conftest's virtual CPU devices with
the same mesh shape and the same global batches (GSPMD's result does not
depend on which process owns a device): the split head with SGD and Adam,
``make_train_step_with_stats`` through a split conv, at JAX's rtol 1e-4 /
atol 1e-6, the ranks of a row equal within rtol 1e-6 / atol 1e-7; a
shard's first gradient is its slice of JAX's gradient (neither doubled by
a gather's backward nor averaged over its row).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as JP

import sparkdl_tpu_torch
from sparkdl_tpu.parallel import get_mesh as jget_mesh
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu_torch.param.converters import OptaxAdam
from sparkdl_tpu_torch.parallel import distributed, mesh as mesh_lib, train
from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map
from sparkdl_tpu_torch.parallel.shard import (RowSplit, ShardedTensor,
                                              gather)
from tests import _torch_model_ranks_worker as worker
from tests._multihost_worker import tp_fit_reference
from tests.test_torch_distributed import RANK_TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TP_TOL = dict(rtol=1e-4, atol=1e-6)  # test_distributed.py's oracle
WORLD = 4


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def assert_tree(got, want, tol):
    """Every leaf of two nested dicts (JSON lists or arrays) within
    ``tol``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree(got[k], want[k], tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (one spawn for every case)."""
    tmp = tmp_path_factory.mktemp("model_ranks")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank_{r}.json") for r in range(WORLD)]
    procs = []
    try:
        for r in range(WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(
                    ROOT, "tests", "_torch_model_ranks_worker.py"), str(r),
                 str(WORLD), port, outs[r], str(tmp)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for p in procs:
            stdout, _ = p.communicate(timeout=120)
            assert p.returncode == 0, stdout.decode(errors="replace")[-4000:]
    finally:
        for p in procs:
            p.kill()
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results, tmp


# -- JAX's one-process oracles ------------------------------------------------


def _jax_tp_rule(path, leaf):
    got = worker.tp_rule_names(path)
    return JP() if got is None else JP(*got)


def _jax_tp_predict(p, xb):
    h = jnp.tanh(jnp.asarray(xb) @ p["body"])
    return h @ p["head"]["kernel"] + p["head"]["bias"]


def _ce(logits, yb):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, yb.astype(jnp.int32))


def jax_tp(opt, model_parallel, steps=None):
    """JAX's split-head step on one process's (4 / m, m) mesh over the
    global batches: (every step's loss, params after ``steps`` steps
    (default every step), the first step's gradients)."""
    x, y, params0, epochs = tp_fit_reference()
    step = jtrain.make_train_step(
        _jax_tp_predict, _ce, opt,
        mesh=jget_mesh(num_devices=4, model_parallel=model_parallel),
        cache=False, param_specs=_jax_tp_rule, params_template=params0)
    params, opt_state = step.put_state(params0, opt.init(params0))
    batches = [(x[off:off + worker.TP_BATCH], y[off:off + worker.TP_BATCH])
               for off in range(0, len(x), worker.TP_BATCH)] * epochs
    losses = []
    for bx, by in batches[:steps]:
        bx, by = step.put_batch(bx, by)
        params, opt_state, lval = step(params, opt_state, bx, by)
        losses.append(float(lval))
    gathered = jax.jit(lambda p: p, out_shardings=step.replicated)(params)
    grads = jax.grad(lambda p: jnp.mean(_ce(_jax_tp_predict(
        p, batches[0][0]), batches[0][1])))(params0)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return losses, host(gathered), host(grads)


def _jbn_train(v, xb):
    """The worker's BatchNorm net in JAX (NCHW, an OIHW conv kernel)."""
    p, s = v["params"], v["batch_stats"]
    h = jax.lax.conv_general_dilated(
        jnp.asarray(xb), p["conv"]["kernel"], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    h = h + p["conv"]["bias"][None, :, None, None]
    mean = jnp.mean(h, axis=(0, 2, 3))
    var = jnp.maximum(jnp.mean(h * h, axis=(0, 2, 3)) - mean * mean, 0.0)
    mul = jax.lax.rsqrt(var + worker.BN_EPS) * p["bn"]["scale"]
    hn = (h - mean[None, :, None, None]) * mul[None, :, None, None] \
        + p["bn"]["bias"][None, :, None, None]
    m = worker.BN_MOMENTUM
    new = {"mean": (1 - m) * s["mean"] + m * mean,
           "var": (1 - m) * s["var"] + m * var}
    logits = jax.nn.relu(hn).mean(axis=(2, 3)) @ p["head"]["kernel"] \
        + p["head"]["bias"]
    return logits, new


def jax_stats(model_parallel):
    """JAX's step with statistics on one process's (4 / m, m) mesh over the
    global batches: (losses, params, stats)."""
    x, y, params, stats = worker.stats_reference()
    opt = optax.sgd(0.1)
    step = jtrain.make_train_step_with_stats(
        _jbn_train, _ce, opt,
        mesh=jget_mesh(num_devices=4, model_parallel=model_parallel),
        cache=False)
    p, s, o = step.put_state(params, stats, opt.init(params))
    losses = []
    for off in range(0, len(x), worker.STATS_BATCH):
        bx, by = step.put_batch(x[off:off + worker.STATS_BATCH],
                                y[off:off + worker.STATS_BATCH])
        p, s, o, lval = step(p, s, o, bx, by)
        losses.append(float(lval))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return losses, host(p), host(s)


# -- checks shared with test_torch_rank_slots.py's layout (ii) ---------------


def row_members(results, r):
    """The results of the ranks in rank ``r``'s data row."""
    return [results[k] for k in r["local"]["row_ranks"][0]]


def check_split_head(results, model_parallel, name):
    """The split head on every rank: JAX's losses and params, the ranks
    equal, each rank holding its own shards of the kernel and bias."""
    opt = optax.sgd(0.1) if name == "sgd" else optax.adam(1e-2)
    want_losses, want, _ = jax_tp(opt, model_parallel)
    per = 4 // model_parallel  # the kernel's columns a slot
    for r in results:
        got = r[name]
        assert got["sharded"] and got["dtypes"] == ["torch.float32"]
        split = got["layout"]["split"]
        assert sorted(split) == ["head/bias", "head/kernel"]
        ranks = r["ranks"][r["local"]["rows"][0]]
        assert split["head/kernel"]["owners"] == ranks
        assert split["head/kernel"]["local"] == r["local"]["positions"]
        assert split["head/kernel"]["shards"] == [[6, per]] * len(
            r["local"]["positions"])
        np.testing.assert_allclose(got["losses"], want_losses, **JAX_TP_TOL)
        assert_tree(got["params"], want, JAX_TP_TOL)
        for other in results:
            assert_tree(got["params"], other[name]["params"], RANK_TOL)
            np.testing.assert_allclose(got["losses"],
                                       other[name]["losses"], **RANK_TOL)


def check_shard_gradients(results, model_parallel):
    """After the first step each shard's gradient is its slice of JAX's
    gradient of the global batch's mean loss: not the row's rank count
    times it (a summing gather's backward), nor its mean over the row."""
    _, _, grads = jax_tp(optax.sgd(0.1), model_parallel, steps=1)
    for r in results:
        for k in ("kernel", "bias"):
            got = r["sgd"]["grads"][k]
            whole = np.asarray(grads["head"][k])
            for (off, n), g in zip(got["spans"], got["grads"]):
                want = np.take(whole, np.arange(off, off + n), got["dim"])
                np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-7)


def check_stats(results, model_parallel):
    """Batch statistics through a split conv: each BatchNorm's sums are
    the row's (the conv's output gathered over the row first), then meet
    over the column group once; JAX's losses, params and statistics."""
    want_losses, want, want_stats = jax_stats(model_parallel)
    per = 8 // model_parallel
    for r in results:
        got = r["stats"]
        assert got["conv_shards"] == [[per, 3, 3, 3]] * len(
            r["local"]["positions"])
        assert got["owners"] == r["ranks"][r["local"]["rows"][0]]
        np.testing.assert_allclose(got["losses"], want_losses, **JAX_TP_TOL)
        assert_tree(got["params"], want, JAX_TP_TOL)
        assert_tree(got["stats"], want_stats, JAX_TP_TOL)
        assert_tree(got["stats"], results[0]["stats"]["stats"], RANK_TOL)
    assert not np.allclose(results[0]["stats"]["stats"]["mean"], 0.0)


def check_resume(results, model_parallel, tmp):
    """Rank 0 alone writes the whole leaves and their Adam moments (each
    gathered over its row); every rank loads its own slices and goes on
    as the uninterrupted step, which is JAX's."""
    _, want, _ = jax_tp(optax.adam(1e-2), model_parallel,
                        steps=worker.RESUME_STEPS)
    assert os.listdir(tmp / f"split_ckpt_{model_parallel}") == [
        "epoch_000001"]
    for r in results:
        got = r["resume"]
        assert got["wrote"] == (r is results[0]) and got["loaded"]
        assert got["saved_shape"] == got["saved_mu_shape"] == [6, 4]
        assert_tree(got["resumed"], got["whole"], dict(rtol=1e-5, atol=1e-6))
        assert_tree(got["whole"], want, JAX_TP_TOL)
        np.testing.assert_allclose(got["gathered"],
                                   got["resumed"]["head"]["kernel"],
                                   rtol=0, atol=0)
        assert_tree(got["resumed"], results[0]["resume"]["resumed"],
                    RANK_TOL)


def check_refusals(results):
    """Both fits refuse the mesh on every rank, naming JAX's replica
    contract and ROADMAP.md §C."""
    for r in results:
        assert len(r["refusals"]) == 2
        for e in r["refusals"]:
            assert e is not None and "ROADMAP.md §C" in e
            assert "replica contract" in e
            assert "make_array_from_process_local_data" in e


# -- layout (iii): four ranks of one slot, data 2 x model 2 ------------------


def test_four_ranks_hold_one_shard_each_rows_and_columns(ranks):
    """dp2 x tp2 over four ranks: each rank's slot of its row, the row
    and column groups (two sub-groups each rank is in, destroyed at
    shutdown) and the step's eager mode naming both groups."""
    results, _ = ranks
    rows = {0: [0, 1], 1: [0, 1], 2: [2, 3], 3: [2, 3]}
    cols = {0: [0, 2], 1: [1, 3], 2: [0, 2], 3: [1, 3]}
    for r in results:
        k = r["rank"]
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["ranks"] == [[0, 1], [2, 3]]
        assert r["local"] == {"shape": {"data": 1, "model": 1},
                              "rows": [k // 2], "row_ranks": [rows[k]],
                              "positions": [k % 2]}
        lay = r["sgd"]["layout"]
        assert lay["row"] == rows[k] and lay["column"] == cols[k]
        assert r["made_groups"] == 2 and r["group_left"]
        mode, why = r["sgd"]["mode"]
        assert mode == "eager"
        assert f"spans ranks {rows[k]}" in why
        assert f"column group {cols[k]}" in why
        # the flat buffer: every gradient (the body whole, the head's
        # shard) and the loss, all-reduced over the column group
        assert r["sgd"]["flat_bytes"] == (36 + 6 * 2 + 2 + 1) * 4
        assert r["adam"]["moments"] == [[6, 2]]
        assert r["adam"]["mu_spec"] == [None, "model"]
        assert r["adam"]["mu_owners"] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_split_head_across_four_ranks_matches_jax(ranks, name):
    check_split_head(ranks[0], 2, name)


def test_shard_gradient_is_its_slice_of_jax_gradient(ranks):
    check_shard_gradients(ranks[0], 2)


def test_batch_stats_through_a_split_conv_match_jax(ranks):
    check_stats(ranks[0], 2)


def test_split_checkpoint_resumes_on_every_rank(ranks):
    check_resume(ranks[0], 2, ranks[1])


def test_fits_refuse_a_row_across_ranks(ranks):
    check_refusals(ranks[0])


def test_ranks_equal_the_one_process_step(ranks):
    """The port's own one-process step on four slots of the same shape
    over the same global batches: the four ranks give its fit."""
    results, _ = ranks
    x, y, params0, epochs = tp_fit_reference()
    params = _tree_map(lambda a: torch.tensor(a, requires_grad=True),
                       params0)

    def predict(p, xb):
        h = torch.tanh(xb @ p["body"])
        return h @ p["head"]["kernel"] + p["head"]["bias"]

    def rule(path, leaf):
        got = worker.tp_rule_names(path)
        return mesh_lib.P() if got is None else mesh_lib.P(*got)

    step = train.make_train_step(
        predict, train.softmax_cross_entropy,
        torch.optim.SGD(_tree_leaves(params), lr=0.1), params,
        mesh=mesh_lib.get_mesh(devices=["cpu"] * 4, model_parallel=2),
        param_specs=rule)
    losses = []
    for _ in range(epochs):
        for off in range(0, len(x), worker.TP_BATCH):
            losses.append(float(step(
                torch.from_numpy(x[off:off + worker.TP_BATCH]),
                torch.from_numpy(y[off:off + worker.TP_BATCH]))))
    for r in results:
        np.testing.assert_allclose(r["sgd"]["losses"], losses,
                                   rtol=1e-5, atol=1e-7)
        assert_tree(r["sgd"]["params"], step.host_params(),
                    dict(rtol=1e-5, atol=1e-7))


# -- without a group ------------------------------------------------------------


@pytest.fixture
def fake_group(monkeypatch):
    """A group of ``n`` ranks, this one rank 0, as the collectives-free
    code sees it (``distributed._SLOTS``: each rank's slot codes)."""

    def make(n, slots):
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: n)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
        monkeypatch.setattr(distributed, "_SLOTS", np.full(
            (n, slots), distributed._CPU_SLOT))

    return make


@pytest.mark.parametrize("world, slots, model, rows, row_ranks, positions", [
    (2, 1, 2, [0], [[0, 1]], [0]),            # layout (i)
    (2, 2, 4, [0], [[0, 1]], [0, 1]),         # layout (ii)
    (4, 1, 2, [0], [[0, 1]], [0]),            # layout (iii)
    (2, 2, 2, [0], [[0]], [0, 1]),            # rows within a rank
    (2, 2, 1, [0, 1], [[0], [0]], [0]),       # dp4
])
def test_local_rows_of_the_supported_layouts(fake_group, world, slots, model,
                                             rows, row_ranks, positions):
    fake_group(world, slots)
    local = mesh_lib.local_rows(mesh_lib.get_mesh(model_parallel=model))
    assert list(local.rows) == rows
    assert [list(r) for r in local.row_ranks] == row_ranks
    assert list(local.positions) == positions
    assert local.spans_ranks == (len(row_ranks[0]) > 1)
    assert local.shape == {"data": len(rows), "model": len(positions)}


def test_local_rows_refuses_uneven_layouts_and_fits_refuse_rows_across(
        fake_group):
    """A row whose ranks hold unequal parts of it, rows over different
    numbers of ranks and a rank without a row raise ValueError; a fit's
    mesh whose row spans ranks raises NotImplementedError."""
    fake_group(2, 2)
    with pytest.raises(ValueError, match="same number of contiguous slots"):
        mesh_lib.local_rows(mesh_lib.get_mesh(num_devices=3,
                                              model_parallel=3))
    uneven = mesh_lib.Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(
        2, 2), ranks=[[0, 1], [1, 1]])
    with pytest.raises(ValueError, match="rows that each span the same"):
        mesh_lib.local_rows(uneven)
    fake_group(3, 1)
    with pytest.raises(ValueError, match=r"ranks \[1, 1, 0\] data rows"):
        mesh_lib.local_rows(mesh_lib.get_mesh(num_devices=2,
                                              model_parallel=2))
    fake_group(2, 1)
    with pytest.raises(NotImplementedError, match="replica contract"):
        train.resolve_fit_mesh(mesh_lib.get_mesh(model_parallel=2))


class _TwoRanks:
    """A row group of two ranks that another rank's identical part
    completes: ``all_gather`` returns this rank's tensor and ``other``'s,
    ``all_reduce`` adds ``other_grad`` (a stand-in for the collectives of
    two ranks that run the same forward)."""

    def __init__(self, me, other=None, other_grad=None):
        self.ranks, self.me = (0, 1), me
        self.other, self.other_grad = other, other_grad
        self.size = 2

    def all_gather(self, t):
        pieces = [t, self.other.to(t.dtype)]
        return pieces if self.me == 0 else pieces[::-1]

    def all_reduce(self, t):
        return t.add_(self.other_grad)


def test_row_gather_hands_each_shard_its_slice_and_inputs_sum():
    """The gather over a row concatenates the ranks' slices in the shards'
    order and its backward gives this rank's shards their slice of the
    gradient (no sum over the ranks); a split linear's input gradient is
    this rank's part plus the other rank's (the row all-reduce), and an
    input that needs no gradient passes no collective."""
    torch.manual_seed(0)
    w = torch.randn(4, 3)
    x = torch.randn(5, 3, requires_grad=True)
    mine, theirs = w[2:].clone().requires_grad_(), w[:2]
    upstream = torch.randn(5, 4)
    # the other rank's part of x's gradient: its shard's
    group = _TwoRanks(1, other=x.detach() @ theirs.t(),
                      other_grad=upstream[:, :2] @ theirs)
    st = ShardedTensor([mine], 0, RowSplit([0, 2, 4], [0, 1], [1], group))
    assert tuple(st.shape) == (4, 3) and st.spans() == [(2, 2)]
    out = torch.nn.functional.linear(x, st)
    assert isinstance(out, ShardedTensor) and out.row_split is st.row_split
    whole = gather(out)
    torch.testing.assert_close(whole, x.detach() @ w.t())
    whole.backward(upstream)
    torch.testing.assert_close(mine.grad, upstream[:, 2:].t() @ x.detach())
    torch.testing.assert_close(x.grad, upstream @ w)
    calls = []
    group.all_reduce = lambda t: calls.append(t) or t
    frozen = torch.randn(5, 3)
    gather(torch.nn.functional.linear(frozen, st)).sum().backward()
    assert calls == []
