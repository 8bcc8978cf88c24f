"""A process group whose ranks each hold several slots (``parallel/
distributed.py initialize(local_slots=...)``, ``parallel/mesh.py
local_rows``, ``parallel/train.py`` over a rank's own data groups,
``models/layers.py GroupSums(cross=...)``) held against the JAX package
on the CPU.

Two gloo ranks, each with two CPU slots, are spawned once for every case
(``tests/_torch_rank_slots_worker.py``, torch and the port only), as
JAX's multi-controller run gives each host its local devices:

  (i) JAX's ``test_two_process_tensor_parallel_fit`` topology on
      ``tests/_multihost_worker.py tp_fit_reference``'s data and params:
      the ranks agree at rtol 1e-6 / atol 1e-7, and both match JAX's
      one-process ``make_train_step`` on ``get_mesh(num_devices=4,
      model_parallel=2)`` at JAX's rtol 1e-4 / atol 1e-6;
  (ii) ``fit_data_parallel`` and ``fit_data_parallel_stream`` on dp4 = 2
      ranks x 2 data groups over unequal shards, against JAX's one-process
      oracle on the concatenated per-rank batches (``LOSS_TOL`` /
      ``PARAM_TOL`` of ``test_torch_distributed.py``);
  (iii) batch statistics summed over each rank's groups, then across the
      ranks, against JAX's ``make_train_step_with_stats`` on one process's
      dp4 mesh: float32 within ``LOSS_TOL`` / ``PARAM_TOL`` (the sums run
      in another order), float64 within rtol 1e-12;
  (iv) a split step checkpointed by rank 0 and resumed on every rank,
      each rank's shards restored, and ``ImageFileEstimator`` with
      ``trainBatchStats`` on the group's default mesh against JAX's on one
      process (rtol 1e-4 / atol 1e-6, ``test_torch_mesh_train.py``'s);
  (v) a mesh whose model axis spans the ranks (one row of four slots,
      each rank two shards of every split weight: layout (ii) of
      ``test_torch_model_ranks.py``, whose checks hold it to JAX's
      one-process dp1 x tp4 step): the split head with SGD and Adam, a
      shard's first gradient, batch statistics through a split conv, a
      checkpoint saved and resumed across the ranks, and both fits'
      refusal; ranks that ask for unequal slot counts raise the same
      ``ValueError`` on every rank;
  (vi) a group's loss keeps its own type: a float32 loss of bf16 params
      is JAX's float32 loss, not rounded to the gradients' bf16.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as JP

import sparkdl_tpu_torch
from sparkdl_tpu.parallel import get_mesh as jget_mesh
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu_torch.models.layers import GroupSums
from sparkdl_tpu_torch.parallel import distributed, mesh as mesh_lib, train
from tests import _torch_dist_worker as dist_worker
from tests import _torch_rank_slots_worker as worker
from tests import test_torch_model_ranks as model_ranks
from tests._multihost_worker import tp_fit_reference
from tests.test_torch_image_file_estimator import _bn_state_dict, _bn_twins
from tests.test_torch_mesh_train import MAP_TOL, _est_kw
from tests.test_torch_distributed import (LOSS_TOL, PARAM_TOL, RANK_TOL,
                                          _ce, _global_batches, _jbn_train,
                                          _oracle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TP_TOL = dict(rtol=1e-4, atol=1e-6)  # test_distributed.py's oracle
F64_TOL = dict(rtol=1e-12, atol=1e-14)
ESTIMATOR_ROWS = 16


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _assert_tree(got, want, tol):
    """Every leaf of two nested dicts (JSON lists or arrays) within
    ``tol``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree(got[k], want[k], tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results (one spawn for every case)."""
    tmp = tmp_path_factory.mktemp("rank_slots")
    # the estimator's images and its BatchNorm net's weights
    (tmp / "images").mkdir()
    rng = np.random.default_rng(0)
    for i in range(ESTIMATOR_ROWS):
        base = np.asarray([200, 40, 40] if i % 2 else [40, 40, 200])
        img = np.clip(base + rng.normal(0, 40, (12, 12, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            tmp / "images" / f"img_{i:02d}.png")
    torch.save(_bn_twins(0)[1].module.state_dict(), tmp / "bn.pt")
    ports = [str(_free_port()), str(_free_port())]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank_{r}.json") for r in range(2)]
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(
                    ROOT, "tests", "_torch_rank_slots_worker.py"), str(r),
                 "2", *ports, outs[r], str(tmp)],
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


def test_each_rank_holds_two_slots_of_the_global_mesh(ranks):
    """The default mesh lays every rank's slots out rank-major; dp4 gives
    each rank two rows of one slot, model 2 one row of two slots."""
    results, _ = ranks
    for r in results:
        assert r["backend"] == "gloo"
        assert r["global_slots"] == [["cpu", "cpu"], ["cpu", "cpu"]]
        assert r["dp4"]["shape"] == {"data": 4, "model": 1}
        assert r["dp4"]["ranks"] == [[0], [0], [1], [1]]
        assert r["dp4"]["local"] == {"data": 2, "model": 1}
        assert r["tp"]["shape"] == {"data": 2, "model": 2}
        assert r["tp"]["ranks"] == [[0, 0], [1, 1]]
        assert r["tp"]["local"] == {"data": 1, "model": 2}


def test_dp2_tp2_over_two_ranks_matches_jax(ranks):
    """(i): the head split over each rank's two slots, the batch over the
    ranks; the ranks hold the same fit, and it is JAX's."""
    (r0, r1), _ = ranks
    for r in (r0, r1):
        assert r["tp"]["sharded"] and r["tp"]["shards"] == [[6, 2], [6, 2]]
    # the flat buffer: every leaf and shard's gradient and the loss
    assert r0["tp"]["flat_bytes"] == (36 + 24 + 4 + 1) * 4
    _assert_tree(r0["tp"]["params"], r1["tp"]["params"], RANK_TOL)
    np.testing.assert_allclose(r0["tp"]["losses"], r1["tp"]["losses"],
                               **RANK_TOL)

    x, y, params0, epochs = tp_fit_reference()

    def predict(p, xb):
        h = jnp.tanh(jnp.asarray(xb) @ p["body"])
        return h @ p["head"]["kernel"] + p["head"]["bias"]

    def rule(path, leaf):
        if path.endswith("head/kernel"):
            return JP(None, "model")
        if path.endswith("head/bias"):
            return JP("model")
        return JP()

    opt = optax.sgd(0.1)
    step = jtrain.make_train_step(
        predict, _ce, opt, mesh=jget_mesh(num_devices=4, model_parallel=2),
        cache=False, param_specs=rule, params_template=params0)
    params, opt_state = step.put_state(params0, opt.init(params0))
    losses = []
    for _ in range(epochs):
        for off in range(0, len(x), worker.TP_BATCH):
            bx, by = step.put_batch(x[off:off + worker.TP_BATCH],
                                    y[off:off + worker.TP_BATCH])
            params, opt_state, lval = step(params, opt_state, bx, by)
        losses.append(float(lval))
    gathered = jax.jit(lambda p: p, out_shardings=step.replicated)(params)
    want = jax.tree_util.tree_map(np.asarray, gathered)
    np.testing.assert_allclose(r0["tp"]["losses"], losses, **JAX_TP_TOL)
    for r in (r0, r1):
        _assert_tree(r["tp"]["params"], want, JAX_TP_TOL)


def _arrays(parts, local, steps, shuffle):
    def batches(epoch):
        return _global_batches([list(jtrain._epoch_batches(
            xr, yr, local, epoch, shuffle, 0, num_steps=steps))
            for xr, yr in parts])
    return batches


def test_fits_on_dp4_match_the_jax_oracle(ranks):
    """(ii): dp = 4 groups over two ranks: each rank draws max(4 // 2,
    8 // 2) = 4 rows a step and splits them over its two groups; steps
    from the all-gathered rows; rank 0 alone checkpoints."""
    (r0, r1), tmp = ranks
    parts, params, _, _ = dist_worker.shards()
    local = dist_worker.GLOBAL_BATCH // 2
    steps = -(-16 // dist_worker.GLOBAL_BATCH)
    for r in (r0, r1):
        assert r["arrays"]["groups"] == 2.0
        assert r["arrays"]["steps"] == steps * dist_worker.EPOCHS
        assert r["arrays"]["modes"] == ["train.step_mode.eager"]
    for mode in ("arrays", "stream"):
        np.testing.assert_allclose(r0[mode]["losses"], r1[mode]["losses"],
                                   **RANK_TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(r0[mode]["fitted"][k],
                                       r1[mode]["fitted"][k], **RANK_TOL)

    want_losses, want = _oracle(_arrays(parts, local, steps, True), params)
    np.testing.assert_allclose(r0["arrays"]["losses"], want_losses,
                               **LOSS_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(r0["arrays"]["fitted"][k], want[k],
                                   **PARAM_TOL)

    def stream(epoch):
        per_rank = []
        for rank, (xr, yr) in enumerate(parts):
            chunks, off = [], 0
            for size in dist_worker.stream_chunks(rank):
                chunks.append((xr[off:off + size], yr[off:off + size]))
                off += size
            per_rank.append(list(jtrain._stream_epoch_batches(
                chunks, local, num_steps=dist_worker.STREAM_STEPS)))
        return _global_batches(per_rank)

    want_losses, want = _oracle(stream, params)
    np.testing.assert_allclose(r0["stream"]["losses"], want_losses,
                               **LOSS_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(r0["stream"]["fitted"][k], want[k],
                                   **PARAM_TOL)
    assert sorted(os.listdir(tmp / "ckpt")) == [
        f"epoch_{e:06d}" for e in range(1, dist_worker.EPOCHS + 1)]


def _jax_stats_fit(batches, params, stats, dtype):
    """JAX's step with statistics on one process's dp4 mesh over the
    global batches: (losses per epoch, params, stats)."""
    opt = optax.sgd(0.1)
    step = jtrain.make_train_step_with_stats(
        _jbn_train, _ce, opt, mesh=jget_mesh(num_devices=4), cache=False)
    cast = lambda t: {k: v.astype(dtype) for k, v in t.items()}  # noqa
    p, s, o = step.put_state(cast(params), cast(stats),
                             opt.init(cast(params)))
    epoch_losses = []
    for epoch in range(dist_worker.EPOCHS):
        losses = []
        for bx, by in batches(epoch):
            bx, by = step.put_batch(bx.astype(dtype), by)
            p, s, o, lval = step(p, s, o, bx, by)
            losses.append(float(lval))
        epoch_losses.append(float(np.mean(losses)))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
    return epoch_losses, host(p), host(s)


@pytest.mark.parametrize("name, dtype, loss_tol, tol", [
    ("stats", np.float32, LOSS_TOL, PARAM_TOL),
    ("stats64", np.float64, F64_TOL, F64_TOL),
])
def test_batch_stats_across_ranks_and_groups_match_jax(ranks, name, dtype,
                                                       loss_tol, tol):
    """(iii): each BatchNorm's sums meet over the rank's two groups, then
    across the ranks (one collective a BatchNorm, from one thread of each
    rank), so μ and σ² are the global batch's; both ranks hold the same
    statistics."""
    (r0, r1), _ = ranks
    parts, _, bn_params, bn_stats = dist_worker.shards()
    local = dist_worker.GLOBAL_BATCH // 2
    steps = -(-16 // dist_worker.GLOBAL_BATCH)
    with jax.enable_x64(dtype == np.float64):
        want_losses, want, want_stats = _jax_stats_fit(
            _arrays(parts, local, steps, False), bn_params, bn_stats, dtype)
    for r in (r0, r1):
        assert r[name]["groups"] == 2.0
        np.testing.assert_allclose(r[name]["losses"], want_losses,
                                   **loss_tol)
        for k in want:
            np.testing.assert_allclose(r[name]["fitted"]["params"][k],
                                       want[k], **tol)
        for k in want_stats:
            np.testing.assert_allclose(r[name]["fitted"]["batch_stats"][k],
                                       want_stats[k], **tol)
    for k in bn_stats:
        np.testing.assert_allclose(r0[name]["fitted"]["batch_stats"][k],
                                   r1[name]["fitted"]["batch_stats"][k],
                                   **RANK_TOL)
    assert not np.allclose(r0[name]["fitted"]["batch_stats"]["mean"],
                           bn_stats["mean"])
    if name == "stats":
        mode, why = r0["stats"]["cuda_mode"]
        assert mode == "eager" and "of each of 2 ranks" in why


def test_split_checkpoint_resumes_every_ranks_shards(ranks):
    """(iv): rank 0 alone writes; every rank loads the whole leaves into
    its own shards (and Adam's moments into shard-shaped state) and goes
    on as the uninterrupted step."""
    (r0, r1), tmp = ranks
    assert r0["resume"]["wrote"] and not r1["resume"]["wrote"]
    assert os.listdir(tmp / "split_ckpt") == ["epoch_000001"]
    for r in (r0, r1):
        assert r["resume"]["loaded"]
        assert r["resume"]["moments"] == [[6, 2], [6, 2]]
        _assert_tree(r["resume"]["resumed"], r["resume"]["whole"],
                     dict(rtol=1e-5, atol=1e-6))
        np.testing.assert_allclose(r["resume"]["gathered"],
                                   r["resume"]["resumed"]["head"]["kernel"],
                                   rtol=0, atol=0)
    _assert_tree(r0["resume"]["resumed"], r1["resume"]["resumed"], RANK_TOL)


def test_estimator_batch_stats_on_the_groups_default_mesh(ranks):
    """``ImageFileEstimator(trainBatchStats=True)`` in each rank over its
    images: the fit's default mesh is every rank's slots, each rank runs
    its two groups (a module copy each), and the fitted net and its
    statistics are JAX's one-process fit over the images in order."""
    (r0, r1), tmp = ranks
    from sparkdl_tpu.estimators import ImageFileEstimator as JaxEstimator
    from sparkdl_tpu.frame import DataFrame as JaxDataFrame
    from tests.test_torch_image_file_estimator import _columns

    paths = sorted(str(p) for p in (tmp / "images").iterdir())
    mine = [worker.rank_images(paths, r) for r in range(2)]
    assert sorted(mine[0] + mine[1]) == paths and mine[0][:4] == paths[:4]
    jmf, _ = _bn_twins(0)
    jest = JaxEstimator(modelFunction=jmf, **_est_kw(
        imageLoader=worker.load8, fitParams={"epochs": 1, "shuffle": False},
        trainBatchStats=True))
    jfit = jest.fit(JaxDataFrame(_columns(paths)))
    want = _bn_state_dict(jax.tree_util.tree_map(
        np.asarray, jfit.getModelFunction().variables))
    for r in (r0, r1):
        np.testing.assert_allclose(r["estimator"]["losses"],
                                   jfit.trainLosses, rtol=1e-4)
        for k, v in r["estimator"]["state"].items():
            np.testing.assert_allclose(v, want[k].numpy(), **MAP_TOL,
                                       err_msg=k)
    _assert_tree(r0["estimator"]["state"], r1["estimator"]["state"],
                 RANK_TOL)


def _tp4(ranks):
    return [r["tp4"] for r in ranks[0]]


def test_model_axis_across_ranks_and_unequal_slots_raise(ranks):
    """(v): a row of four slots over both ranks (dp1 x tp4): each rank
    holds two shards of the head, the SGD step is JAX's one-process dp1 x
    tp4 step and the ranks agree, while both fits raise on that mesh,
    naming JAX's replica contract and ROADMAP.md §C; ranks asking for 2
    and 3 slots raise the same ValueError and leave no group."""
    (r0, r1), _ = ranks
    tp4 = _tp4(ranks)
    for k, r in enumerate(tp4):
        assert r["mesh"] == {"data": 1, "model": 4}
        assert r["ranks"] == [[0, 0, 1, 1]]
        assert r["local"] == {"shape": {"data": 1, "model": 2},
                              "rows": [0], "row_ranks": [[0, 1]],
                              "positions": [2 * k, 2 * k + 1]}
        lay = r["sgd"]["layout"]
        assert lay["row"] == [0, 1] and lay["column"] == [k]
        # one data row: a column group of one rank, no all-reduce at all
        assert r["sgd"]["flat_bytes"] is None
    model_ranks.check_split_head(tp4, 4, "sgd")
    model_ranks.check_refusals(tp4)
    for r in (r0, r1):
        assert r["group_left"]
    assert r0["unequal"] == r1["unequal"]
    assert "the ranks hold [2, 3] slots" in r0["unequal"]


def test_dp1_tp4_adam_gradients_and_resume_across_ranks(ranks):
    """(v): Adam on dp1 x tp4 (moments per shard, reported under the whole
    mesh's sharding), each shard's first gradient its slice of JAX's, and
    the split Adam step checkpointed by rank 0 and resumed on both."""
    tp4 = _tp4(ranks)
    model_ranks.check_split_head(tp4, 4, "adam")
    for r in tp4:
        assert r["adam"]["moments"] == [[6, 1], [6, 1]]
        assert r["adam"]["mu_spec"] == [None, "model"]
        assert r["adam"]["mu_owners"] == [[0, 0, 1, 1]]
    model_ranks.check_shard_gradients(tp4, 4)
    model_ranks.check_resume(tp4, 4, ranks[1])


def test_dp1_tp4_batch_stats_through_a_split_conv_match_jax(ranks):
    """(v): ``make_train_step_with_stats`` with the conv split over four
    slots of two ranks: JAX's losses, params and statistics."""
    model_ranks.check_stats(_tp4(ranks), 4)


def test_group_loss_keeps_its_own_type(ranks):
    """(vi): bf16 params, dp2 x tp2 over the two ranks: with float32
    logits the step's loss is float32 and JAX's one-process loss series
    (the flat buffer in the gradients' bf16 had rounded it to bf16, 3e-3
    from JAX's on the first step); with bf16 logits it stays bf16."""
    results, _ = ranks
    x, y, params0, _ = tp_fit_reference()

    def rule(path, leaf):
        got = model_ranks.worker.tp_rule_names(path)
        return JP() if got is None else JP(*got)

    for name, logits in (("float32", jnp.float32),
                         ("bfloat16", jnp.bfloat16)):
        def predict(p, xb, logits=logits):
            h = jnp.tanh(jnp.asarray(xb, jnp.bfloat16) @ p["body"])
            return (h @ p["head"]["kernel"] + p["head"]["bias"]).astype(
                logits)

        opt = optax.sgd(0.1)
        p0 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), params0)
        step = jtrain.make_train_step(
            predict, _ce, opt,
            mesh=jget_mesh(num_devices=4, model_parallel=2), cache=False,
            param_specs=rule, params_template=p0)
        params, opt_state = step.put_state(p0, opt.init(p0))
        losses = []
        for off in range(0, len(x), worker.TP_BATCH):
            bx, by = step.put_batch(x[off:off + worker.TP_BATCH],
                                    y[off:off + worker.TP_BATCH])
            params, opt_state, lval = step(params, opt_state, bx, by)
            losses.append(float(lval))
        assert str(lval.dtype) == name
        for r in results:
            got = r["loss_type"][name]
            assert got["dtypes"] == [f"torch.{name}"]
            tol = JAX_TP_TOL if name == "float32" else dict(rtol=1e-2)
            np.testing.assert_allclose(got["losses"], losses, **tol)
        np.testing.assert_allclose(results[0]["loss_type"][name]["losses"],
                                   results[1]["loss_type"][name]["losses"],
                                   rtol=0, atol=0)


# -- without a group -----------------------------------------------------------


@pytest.fixture
def fake_group(monkeypatch):
    """A group of two ranks as the collectives-free code sees it: rank 0
    of 2, each with the slots ``distributed._SLOTS`` names."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr(distributed, "_SLOTS", None)
    return monkeypatch


def test_slot_codes_and_the_meshes_they_give(fake_group):
    """``local_slots`` as an int, a list (a device may repeat) or None;
    what a host cannot give is flagged; the global mesh is rank-major and
    ``local_rows`` keeps this rank's rows, refusing rows across ranks and
    unequal rows."""
    codes = distributed._slot_codes
    assert codes(None, 1) == [distributed._DEFAULT_SLOT]
    assert codes(3, 1) == [distributed._DEFAULT_SLOT] * 3
    assert codes(["cpu", "cpu"], 0) == [distributed._CPU_SLOT] * 2
    for bad in (0, [], ["meta"]):
        assert codes(bad, 0) is None
    if not torch.cuda.is_available():
        assert codes(["cuda:0"], 0) is None
    cpu = torch.device("cpu")
    # no slots gathered: one default slot a rank, as before
    assert mesh_lib.get_mesh().shape == {"data": 2, "model": 1}
    fake_group.setattr(distributed, "_SLOTS",
                       np.full((2, 2), distributed._CPU_SLOT))
    assert distributed.global_slots() == [[cpu, cpu], [cpu, cpu]]
    four = mesh_lib.get_mesh()
    assert four.ranks.ravel().tolist() == [0, 0, 1, 1]
    local = mesh_lib.local_rows(four)
    assert local.shape == {"data": 2, "model": 1}
    assert local.ranks.ravel().tolist() == [0, 0]
    assert mesh_lib.local_rows(mesh_lib.get_mesh(
        model_parallel=2)).shape == {"data": 1, "model": 2}
    # a row over both ranks: this rank's two slots of it; a fit refuses it
    across = mesh_lib.local_rows(mesh_lib.get_mesh(model_parallel=4))
    assert across.shape == {"data": 1, "model": 2}
    assert across.row_ranks == ((0, 1),) and across.positions == (0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §C"):
        train.resolve_fit_mesh(mesh_lib.get_mesh(model_parallel=4))
    # a mesh of this rank's slots only: the ranks' rows are [2, 0]
    with pytest.raises(ValueError, match=r"ranks \[2, 0\] data rows"):
        mesh_lib.local_rows(mesh_lib.get_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="same number of whole rows"):
        train.resolve_fit_mesh(mesh_lib.get_mesh(num_devices=3))


def test_group_sums_add_the_ranks_once_from_group_zero():
    """With ``cross`` every group gets the rank's sum through one call from
    group 0's thread, and the gradient flows back through it to every
    group's part."""
    calls = []

    def cross(t):  # a second rank holding the same parts: twice the sum
        calls.append(threading.current_thread().name)
        return t * 2

    sums = GroupSums(2, cross)
    parts = [torch.tensor([1.0, 2.0], requires_grad=True),
             torch.tensor([3.0, 5.0], requires_grad=True)]
    out = [None, None]

    def run(g):
        out[g] = sums.all_sum(g, parts[g])

    threads = [threading.Thread(target=run, args=(g,), name=f"group-{g}")
               for g in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["group-0"]
    for o in out:
        assert o.tolist() == [8.0, 14.0]
    (out[0].sum() + out[1].sum()).backward()
    for p in parts:
        assert p.grad.tolist() == [4.0, 4.0]


def test_flat_buffer_takes_the_gradients_type():
    """The flat buffer a group all-reduces is in the gradients' type: a
    float64 loss (float64 one-hot labels) beside float32 gradients does
    not widen them (the buffer stays float32, the loss travels at its own
    type in a one-element tensor beside it); float64 gradients carry the
    float64 loss in the buffer's last element.  ``unpack`` gives the loss
    back at its own type."""
    for dtype in (torch.float32, torch.float64):
        w = torch.ones(3, 2, dtype=dtype, requires_grad=True)
        step = train.make_train_step(
            lambda p, xb: torch.softmax(xb @ p["w"], -1),
            "categorical_crossentropy", torch.optim.SGD([w], lr=0.1),
            {"w": w})
        x = torch.ones(4, 3, dtype=dtype)
        y = torch.eye(2, dtype=torch.float64)[[0, 1, 0, 1]]
        lval = step.forward_backward(x, y)
        assert lval.dtype == torch.float64
        flat = step.pack(lval)
        assert flat.dtype == dtype
        if dtype == torch.float32:
            assert flat.numel() == 6
            assert step._loss.dtype == torch.float64
            assert float(step._loss[0]) == float(lval)
        else:
            assert flat.numel() == 7 and step._loss is None
            assert float(flat[-1]) == float(lval)
        out = step.unpack()
        assert out.dtype == torch.float64 and float(out) == float(lval)
