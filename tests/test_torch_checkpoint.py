"""The port's checkpoints (``sparkdl_tpu_torch/checkpoint.py``) and the
fit's resume (``parallel/train.py``) on the CPU.

The layout and cadence are the JAX package's (``epoch_<k>`` directories,
``due`` / ``latest`` / the single-writer rule); the files are
``torch.save`` trees loaded with ``weights_only=True``, not orbax
directories.  A fit interrupted after some epochs and started again with
the same ``checkpoint_dir`` ends where the uninterrupted fit ends, bit for
bit on the CPU: the params, the optimizer's state and the BatchNorm
statistics come back exactly and the batches are drawn per epoch.
"""

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.checkpoint import TrainCheckpointer as JaxCheckpointer
from sparkdl_tpu_torch import checkpoint
from sparkdl_tpu_torch.param.converters import NamedOptimizer
from sparkdl_tpu_torch.parallel import train


def test_cadence_and_latest_follow_the_jax_package(tmp_path):
    for every in (1, 2, 3):
        port = checkpoint.TrainCheckpointer(str(tmp_path / f"p{every}"),
                                            every)
        ref = JaxCheckpointer(str(tmp_path / f"j{every}"), every)
        assert [port.due(e) for e in range(1, 10)] == \
            [ref.due(e) for e in range(1, 10)]
    ck = checkpoint.TrainCheckpointer(str(tmp_path / "run"), 2)
    assert ck.latest() is None and ck.restore_latest() is None
    assert ck.maybe_save(1, {"x": 1}) is None  # not due
    for e in (2, 4):
        assert ck.maybe_save(e, {"x": np.full(3, e, np.float32)})
    (tmp_path / "run" / "epoch_junk").mkdir()
    (tmp_path / "run" / "epoch_000009.tmp").mkdir()  # an unfinished save
    assert ck.latest() == (4, str(tmp_path / "run" / "epoch_000004"))
    epoch, state = ck.restore_latest()
    assert epoch == 4 and torch.equal(state["x"], torch.full((3,), 4.0))


def test_save_restore_tree_round_trip(tmp_path):
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": torch.ones(3, dtype=torch.float64)},
            "opt": [{"step": 3, "lr": 0.1, "betas": (0.9, 0.99)}, None],
            "name": "x"}
    path = checkpoint.save_pytree(str(tmp_path / "t"), tree)
    back = checkpoint.restore_pytree(path)
    assert torch.equal(back["params"]["w"], torch.from_numpy(
        tree["params"]["w"]))
    assert back["params"]["b"].dtype == torch.float64
    assert back["opt"] == tree["opt"] and back["name"] == "x"
    with pytest.raises(FileExistsError):
        checkpoint.save_pytree(path, tree, force=False)
    # weights_only: a pickled object that is not plain data is refused
    torch.save({"f": _Opaque()}, str(tmp_path / "t" / "tree.pt"))
    with pytest.raises(Exception, match="[Ww]eights only"):
        checkpoint.restore_pytree(path)


class _Opaque:
    pass


def test_single_writer_rule(monkeypatch):
    assert checkpoint.TrainCheckpointer.is_writer()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    assert not checkpoint.TrainCheckpointer.is_writer()


def _data():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(40) % 3]
    w0 = rng.normal(0, 0.1, (6, 3)).astype(np.float32)
    return x, y, w0


def _predict(p, xb):
    return torch.softmax(xb @ p["w"] + p["b"], -1)


def _train(v, xb):
    """A BatchNorm-statistics step: normalize by the batch, update a
    running mean with momentum 0.9 (as a train_fn returns it)."""
    mean = xb.mean(0)
    new = {"mean": 0.9 * v["batch_stats"]["mean"] + 0.1 * mean.detach()}
    return _predict(v["params"], xb - mean), new


@pytest.mark.parametrize("stats", [False, True], ids=["params", "stats"])
@pytest.mark.parametrize("every", [1, 2])
def test_interrupted_fit_resumes_to_the_uninterrupted_result(tmp_path, stats,
                                                             every):
    x, y, w0 = _data()
    params = {"w": w0, "b": np.zeros(3, np.float32)}
    kw = dict(optimizer=NamedOptimizer("adam"), batch_size=16, seed=3,
              checkpoint_every_epochs=every)
    if stats:
        kw.update(train_fn=_train, stats={"mean": np.zeros(6, np.float32)})
    with sparkdl_tpu_torch.default_device("cpu"):
        whole, whole_losses = train.fit_data_parallel(
            _predict, params, x, y, epochs=4, **kw)
        ck = str(tmp_path / "ck")
        # interrupted after epoch 2 (a checkpoint there for both cadences)
        _, first = train.fit_data_parallel(_predict, params, x, y, epochs=2,
                                           checkpoint_dir=ck, **kw)
        resumed, rest = train.fit_data_parallel(
            _predict, params, x, y, epochs=4, checkpoint_dir=ck, **kw)
    assert first + rest == whole_losses and len(rest) == 2
    flat = (lambda t: {**t["params"], **t["batch_stats"]}) if stats \
        else (lambda t: t)
    for k, v in flat(whole).items():
        np.testing.assert_array_equal(flat(resumed)[k], v, err_msg=k)
    saved = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert saved == [f"epoch_{e:06d}" for e in range(1, 5)
                     if e % every == 0]
