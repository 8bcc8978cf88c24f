"""The port's streaming fit (``parallel/train.py fit_data_parallel_stream``
and ``ImageFileEstimator.fit(source)``) held against the JAX package's on
the CPU.

``_stream_epoch_batches`` gives JAX's batches, batch for batch; the stream
fit of a linear model under SGD gives the port's in-memory fit's losses
(``shuffle=False``) and JAX's stream fit's losses and weights within rtol
1e-5; consumed chunks are garbage while later ones are drawn (O(chunk +
batch) residency, with ``steps_per_execution`` 1 and 4); the estimator's
stream fit over record batches of the fixture images gives JAX's
``_fit_stream`` (a Keras CNN, and ``trainBatchStats`` on a BatchNorm
module); a checkpointed stream fit resumes to the uninterrupted one.
JAX's fits run on the tests' 8-device CPU mesh with batches that are
multiples of 8, so both draw the same batches.
"""

import gc
import weakref

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax

import sparkdl_tpu_torch
from sparkdl_tpu.estimators import ImageFileEstimator as JaxEstimator
from sparkdl_tpu.estimators import KerasImageFileEstimator as JaxKeras
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu_torch.estimators import (ImageFileEstimator,
                                          KerasImageFileEstimator)
from sparkdl_tpu_torch.parallel import train
from sparkdl_tpu_torch.utils.metrics import Metrics
from tests.test_torch_image_file_estimator import (  # noqa: F401 fixtures
    LOSS_TOL, TENSOR_TOL, _assert_fitted_keras_equal, _bn_state_dict,
    _bn_twins, _columns, _keras_kw, files, keras_path, load8)

FIT_TOL = dict(rtol=1e-5, atol=1e-6)   # stream vs in-memory, port vs JAX


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _chunks_of(x, y, sizes):
    off = 0
    for s in sizes:
        yield x[off:off + s], y[off:off + s]
        off += s


def _sgd(lr):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


def _ppredict(p, xb):
    return xb @ p["w"]


def _jpredict(p, xb):
    import jax.numpy as jnp

    return jnp.asarray(xb) @ p["w"]


@pytest.mark.parametrize("n, sizes, batch, num_steps", [
    (22, [5, 9, 3, 5], 8, None),          # tail wrapped with head rows
    (16, [16], 4, 2),                     # truncated to a pinned count
    (16, [16], 8, 5),                     # extended to a pinned count
    (3, [3], 8, None),                    # shorter than one batch
    (3, [2, 1], 8, 3),                    # shorter, and pinned
    (20, [0, 7, 0, 13], 6, None),         # empty chunks on the way
], ids=["tail", "truncate", "extend", "short", "short-pinned", "empties"])
def test_stream_epoch_batches_equal_jax(n, sizes, batch, num_steps):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.float32)
    got = list(train._stream_epoch_batches(_chunks_of(x, y, sizes), batch,
                                           num_steps=num_steps))
    want = list(jtrain._stream_epoch_batches(_chunks_of(x, y, sizes), batch,
                                             num_steps=num_steps))
    assert len(got) == len(want) > 0
    if num_steps is not None:
        assert len(got) == num_steps
    if n < batch and num_steps is not None:
        # the port's one repair: JAX repeats the 3 rows before the wrap
        assert [len(bx) for bx, _ in want] == [batch] + [n] * (num_steps - 1)
        want = [want[0]] * num_steps
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == (batch, 2) and gy.shape == (batch,)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_stream_fit_matches_in_memory_and_jax(rng):
    w_true = rng.normal(size=(5, 1)).astype(np.float32)
    x = rng.normal(size=(32, 5)).astype(np.float32)
    y = x @ w_true
    p0 = {"w": np.zeros((5, 1), np.float32)}

    def source():
        return _chunks_of(x, y, [8, 8, 8, 8])

    in_mem, losses_mem = train.fit_data_parallel(
        _ppredict, dict(p0), x, y, optimizer=_sgd(0.1), loss="mse",
        batch_size=8, epochs=4, shuffle=False)
    streamed, losses = train.fit_data_parallel_stream(
        _ppredict, dict(p0), source, optimizer=_sgd(0.1), loss="mse",
        batch_size=8, epochs=4)
    assert len(losses) == 4
    np.testing.assert_allclose(losses, losses_mem, rtol=1e-5)
    np.testing.assert_allclose(streamed["w"], in_mem["w"], **FIT_TOL)
    import optax

    jw, jlosses = jtrain.fit_data_parallel_stream(
        _jpredict, dict(p0), source, optimizer=optax.sgd(0.1), loss="mse",
        batch_size=8, epochs=4)
    np.testing.assert_allclose(losses, jlosses, **FIT_TOL)
    np.testing.assert_allclose(streamed["w"], np.asarray(jw["w"]), **FIT_TOL)


@pytest.mark.parametrize("n, chunk, batch", [(44, 10, 16), (3, 3, 8)],
                         ids=["ragged-tail", "shorter-than-a-batch"])
def test_stream_fit_wraps_like_jax(n, chunk, batch):
    """The ragged tail and a stream shorter than one batch are wrapped up
    to the full batch, as JAX's stream fit does (not the in-memory fit's
    clamp of the batch to the row count)."""
    r = np.random.default_rng(5)
    x = r.normal(size=(n, 6)).astype(np.float32)
    y = x @ r.normal(size=(6, 1)).astype(np.float32)

    def source():
        for off in range(0, n, chunk):
            yield x[off:off + chunk], y[off:off + chunk]

    import optax

    kw = dict(loss="mse", batch_size=batch, epochs=3)
    pw, pl = train.fit_data_parallel_stream(
        _ppredict, {"w": np.zeros((6, 1), np.float32)}, source,
        optimizer=_sgd(0.05), **kw)
    jw, jl = jtrain.fit_data_parallel_stream(
        _jpredict, {"w": np.zeros((6, 1), np.float32)}, source,
        optimizer=optax.sgd(0.05), **kw)
    np.testing.assert_allclose(pl, jl, **FIT_TOL)
    np.testing.assert_allclose(pw["w"], np.asarray(jw["w"]), **FIT_TOL)


@pytest.mark.parametrize("spe", [1, 4])
def test_stream_fit_releases_consumed_chunks(rng, spe):
    """O(chunk) residency: by the time chunk i is drawn, chunk i-3 is
    garbage; the fit never accumulates the stream."""
    x = rng.normal(size=(80, 4)).astype(np.float32)
    y = x @ rng.normal(size=(4, 1)).astype(np.float32)
    refs = []

    def source():
        refs.clear()

        def gen():
            for i in range(10):
                cx = x[i * 8:(i + 1) * 8].copy()
                cy = y[i * 8:(i + 1) * 8].copy()
                refs.append(weakref.ref(cx))
                if i >= 3:
                    gc.collect()
                    alive = [j for j, r in enumerate(refs[:i - 2])
                             if r() is not None]
                    assert not alive, (f"chunks {alive} alive when "
                                       f"drawing chunk {i}")
                yield cx, cy

        return gen()

    _, losses = train.fit_data_parallel_stream(
        _ppredict, {"w": np.zeros((4, 1), np.float32)}, source,
        optimizer=_sgd(0.05), loss="mse", batch_size=8, epochs=2,
        steps_per_execution=spe)
    assert len(losses) == 2 and len(refs) == 10


def test_stream_fit_steps_per_execution_parity():
    """Groups of 4 steps per loss fetch: the same loss series and weights
    as one, the wrapped ragged tail included."""
    r = np.random.default_rng(5)
    x = r.normal(size=(44, 6)).astype(np.float32)
    y = x @ r.normal(size=(6, 1)).astype(np.float32)

    def source():
        for off in range(0, len(x), 10):
            yield x[off:off + 10], y[off:off + 10]

    def fit(spe):
        return train.fit_data_parallel_stream(
            _ppredict, {"w": np.zeros((6, 1), np.float32)}, source,
            optimizer=_sgd(0.05), loss="mse", batch_size=16, epochs=3,
            steps_per_execution=spe)

    (w1, l1), (w4, l4) = fit(1), fit(4)
    assert l1 == pytest.approx(l4, rel=1e-5)
    np.testing.assert_allclose(w1["w"], w4["w"], rtol=1e-5, atol=1e-7)


def test_stream_fit_skips_empty_leading_chunks_and_refuses_no_rows():
    x = np.ones((8, 2), np.float32)
    y = np.ones((8, 1), np.float32)
    empty = (x[:0], y[:0])

    def lead():
        return iter([empty, empty, (x, y)])

    _, losses = train.fit_data_parallel_stream(
        lambda p, xb: xb @ p["w"], {"w": np.zeros((2, 1), np.float32)},
        lead, optimizer=_sgd(0.1), loss="mse", batch_size=8)
    assert len(losses) == 1
    for src in (lambda: iter(()), lambda: iter([empty, empty])):
        with pytest.raises(ValueError, match="epoch_source yielded no rows"):
            train.fit_data_parallel_stream(
                lambda p, xb: xb @ p["w"],
                {"w": np.zeros((2, 1), np.float32)}, src,
                optimizer=_sgd(0.1), loss="mse", batch_size=8)


def test_stream_fit_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((8, 2), np.float32)
    with sparkdl_tpu_torch.default_device(None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.fit_data_parallel_stream(
                lambda p, xb: xb @ p["w"],
                {"w": np.zeros((2, 1), np.float32)},
                lambda: iter([(x, x[:, :1])]), loss="mse")


class CrashAfterEpochs(Metrics):
    """A preemption: raises once ``crash_after`` epoch losses are recorded
    (before that epoch's checkpoint is saved)."""

    def __init__(self, crash_after):
        super().__init__()
        self.crash_after = crash_after
        self.epochs_seen = 0

    def record_time(self, name, value):
        super().record_time(name, value)
        if name == "epoch_loss":
            self.epochs_seen += 1
            if self.crash_after is not None and \
                    self.epochs_seen >= self.crash_after:
                raise RuntimeError("simulated preemption")


def test_checkpointed_stream_fit_resumes_to_the_uninterrupted_fit(
        rng, tmp_path):
    x = rng.normal(size=(40, 4)).astype(np.float32)
    y = x @ rng.normal(size=(4, 1)).astype(np.float32)

    def source():
        return _chunks_of(x, y, [16, 16, 8])

    kw = dict(optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05,
                                                   momentum=0.9),
              loss="mse", batch_size=16, epochs=4)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="preemption"):
        train.fit_data_parallel_stream(
            _ppredict, {"w": np.zeros((4, 1), np.float32)}, source,
            checkpoint_dir=ck, metrics=CrashAfterEpochs(2), **kw)
    resumed, rest = train.fit_data_parallel_stream(
        _ppredict, {"w": np.zeros((4, 1), np.float32)}, source,
        checkpoint_dir=ck, **kw)
    full, losses = train.fit_data_parallel_stream(
        _ppredict, {"w": np.zeros((4, 1), np.float32)}, source, **kw)
    assert len(rest) == 3  # resumed after epoch 1's checkpoint
    np.testing.assert_allclose(rest, losses[1:], rtol=1e-6)
    np.testing.assert_allclose(resumed["w"], full["w"], rtol=1e-6,
                               atol=1e-7)


# -- the estimator -------------------------------------------------------------

def _record_batches(paths, labels, size):
    pulls = []

    def source():
        pulls.append(0)
        for off in range(0, len(paths), size):
            yield pa.record_batch({"uri": pa.array(paths[off:off + size]),
                                   "label": pa.array(labels[off:off + size])})

    return source, pulls


@pytest.mark.parametrize("n_files", [16, 13], ids=["even", "ragged"])
def test_keras_estimator_fit_stream_matches_jax(files, keras_path, n_files):
    """``KerasImageFileEstimator.fit(source)`` (inherited ``_fit_stream``)
    over record batches of 6: one pass over the source per epoch, and
    JAX's stream fit's losses and fitted tensors."""
    cols = _columns(files[:n_files])
    kw = _keras_kw(keras_path, kerasOptimizer="sgd",
                   kerasFitParams={"epochs": 2})
    jsrc, _ = _record_batches(cols["uri"], cols["label"], 6)
    jm = JaxKeras(**kw).fit(jsrc)
    src, pulls = _record_batches(cols["uri"], cols["label"], 6)
    pm = KerasImageFileEstimator(**kw).fit(src)
    assert len(pulls) == 2
    assert len(pm.trainLosses) == 2
    np.testing.assert_allclose(pm.trainLosses, jm.trainLosses, **LOSS_TOL)
    _assert_fitted_keras_equal(pm, jm)


def test_estimator_fit_stream_with_train_batch_stats(files):
    """``trainBatchStats`` through ``_fit_stream``: the statistics move, as
    JAX's stream fit moves them, and the fit equals the port's in-memory
    fit over the same rows in the same order."""
    from sparkdl_tpu_torch.frame import DataFrame

    jmf, mf = _bn_twins(0)
    cols = _columns(files)
    kw = dict(inputCol="uri", outputCol="preds", labelCol="label",
              imageLoader=load8, optimizer="sgd", batchSize=8,
              loss="categorical_crossentropy", trainBatchStats=True)
    src, _ = _record_batches(cols["uri"], cols["label"], 6)
    jm = JaxEstimator(modelFunction=jmf, fitParams={"epochs": 2},
                      **kw).fit(src)
    pm = ImageFileEstimator(modelFunction=mf, fitParams={"epochs": 2},
                            **kw).fit(src)
    mem = ImageFileEstimator(modelFunction=mf,
                             fitParams={"epochs": 2, "shuffle": False},
                             **kw).fit(DataFrame(cols))
    np.testing.assert_allclose(pm.trainLosses, jm.trainLosses, **LOSS_TOL)
    np.testing.assert_allclose(pm.trainLosses, mem.trainLosses, rtol=1e-5)
    got = pm.getModelFunction().module.state_dict()
    want = _bn_state_dict(jax.tree_util.tree_map(
        np.asarray, jm.getModelFunction().variables))
    for k, v in want.items():
        if k != "bn.num_batches_tracked":
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       **TENSOR_TOL, err_msg=k)
    start = mf.module.state_dict()
    assert not torch.equal(got["bn.running_mean"], start["bn.running_mean"])


def test_estimator_fit_stream_steps_per_epoch_and_execution(files):
    """``fitParams`` carries ``steps_per_epoch`` (the stream pinned) and
    ``steps_per_execution`` (the same losses)."""
    _, mf = _bn_twins(1)
    cols = _columns(files)
    kw = dict(inputCol="uri", outputCol="preds", labelCol="label",
              modelFunction=mf, imageLoader=load8, optimizer="sgd",
              batchSize=8, loss="categorical_crossentropy")
    src, _ = _record_batches(cols["uri"], cols["label"], 6)
    losses = {}
    for name, fp in (("base", {"epochs": 2}),
                     ("spe", {"epochs": 2, "steps_per_execution": 3}),
                     ("pinned", {"epochs": 2, "steps_per_epoch": 1})):
        steps = []
        real = train._StepRunner.run_epoch

        def logged(runner, batches):
            out = real(runner, batches)
            steps.append(len(out))
            return out

        train._StepRunner.run_epoch = logged
        try:
            losses[name] = ImageFileEstimator(fitParams=fp, **kw).fit(
                src).trainLosses
        finally:
            train._StepRunner.run_epoch = real
        assert steps == ([1, 1] if name == "pinned" else [2, 2])
    np.testing.assert_allclose(losses["spe"], losses["base"], rtol=1e-6)
    assert losses["pinned"] != losses["base"]
