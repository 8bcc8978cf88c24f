"""The port's head fit and estimators (sparkdl_tpu_torch/parallel/train.py,
sparkdl_tpu_torch/estimators/) held against the JAX package's on the CPU.

The LogisticRegression fits run on the seeded blobs of
``tests/test_estimators.py``: 120 rows and a batch of 32, multiples of 8,
so that JAX's fit on the tests' 8-device CPU mesh (which rounds the batch
to a multiple of the data axis) draws the same batches as the port's fit
on one device.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import sparkdl_tpu_torch
import sparkdl_tpu.parallel.train as jax_train
from sparkdl_tpu.estimators import (BinaryClassificationEvaluator as
                                    JaxBinaryEvaluator)
from sparkdl_tpu.estimators import LogisticRegression as JaxLR
from sparkdl_tpu.estimators import (MulticlassClassificationEvaluator as
                                    JaxMulticlassEvaluator)
from sparkdl_tpu.frame import DataFrame as JaxDataFrame
from sparkdl_tpu_torch.estimators import (BinaryClassificationEvaluator,
                                          LogisticRegression,
                                          MulticlassClassificationEvaluator)
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.parallel import train

# f32 Adam on both sides, the batch mean and the update in another order.
FIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    n = 120
    centers = np.asarray([[2.0, 0.0], [-2.0, 1.0], [0.0, -2.5]], np.float32)
    y = np.arange(n) % 3
    x = centers[y] + rng.normal(0, 0.4, size=(n, 2)).astype(np.float32)
    return {"features": [list(map(float, r)) for r in x],
            "label": y.astype(np.int64)}


@pytest.mark.parametrize("kw", [dict(), dict(standardization=False),
                                dict(regParam=0.1)],
                         ids=["standardized", "raw", "l2"])
def test_logistic_regression_matches_jax(blobs, kw):
    kw = dict(kw, maxIter=5, batchSize=32)
    jm = JaxLR(**kw).fit(JaxDataFrame(blobs))
    with sparkdl_tpu_torch.default_device("cpu"):
        pm = LogisticRegression(**kw).fit(DataFrame(blobs))
    assert pm.numClasses == jm.numClasses == 3
    for k in ("w", "b"):
        np.testing.assert_allclose(pm.weights[k], np.asarray(jm.weights[k]),
                                   **FIT_TOL)
    got = pm.transform(DataFrame(blobs))
    want = jm.transform(JaxDataFrame(blobs))
    np.testing.assert_allclose(got.column_to_numpy("probability"),
                               want.column_to_numpy("probability"), **FIT_TOL)
    np.testing.assert_array_equal(got.column_to_numpy("prediction"),
                                  want.column_to_numpy("prediction"))
    assert MulticlassClassificationEvaluator().evaluate(got) > 0.9


@pytest.mark.parametrize("n,batch,shuffle,num_steps", [
    (3, 8, True, None),      # smaller than the batch: modular wrap
    (20, 8, True, None),     # ragged last batch
    (16, 8, False, None),
    (5, 4, True, 4),         # pinned step count
])
def test_epoch_batches_match_jax(n, batch, shuffle, num_steps):
    x = np.arange(n, dtype=np.float32)[:, None]
    y = np.arange(n)
    for epoch in (0, 3):
        got = list(train._epoch_batches(x, y, batch, epoch, shuffle, 7,
                                        num_steps=num_steps))
        want = list(jax_train._epoch_batches(x, y, batch, epoch, shuffle, 7,
                                             num_steps=num_steps))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.shape == (batch, 1)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_steps_per_execution_same_loss_series():
    """Groups of 3 steps with one loss fetch each give the per-step loss
    series of 1-step groups bit for bit, and the same fitted params."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(56, 6)).astype(np.float32)
    y = (np.arange(56) % 4).astype(np.int64)

    def run(spe):
        w = torch.tensor(rng_w, requires_grad=True)
        opt = torch.optim.Adam([w], lr=0.05)
        step = train.make_train_step(lambda p, xb: xb @ p["w"],
                                     train.softmax_cross_entropy, opt,
                                     {"w": w})
        series = train._StepRunner(step, spe, torch.device("cpu"),
                                   "eager").run_epoch(
            train._epoch_batches(x, y, 8, 0, True, 0))
        return series, w.detach().numpy()

    rng_w = rng.normal(0, 0.01, (6, 4)).astype(np.float32)
    s1, w1 = run(1)
    s3, w3 = run(3)
    assert len(s1) == 7 and s1 == s3
    np.testing.assert_array_equal(w1, w3)
    with sparkdl_tpu_torch.default_device("cpu"):
        f1, l1 = train.fit_data_parallel(
            lambda p, xb: xb @ p["w"], {"w": rng_w}, x, y,
            loss=train.softmax_cross_entropy, batch_size=8, epochs=2)
        f3, l3 = train.fit_data_parallel(
            lambda p, xb: xb @ p["w"], {"w": rng_w}, x, y,
            loss=train.softmax_cross_entropy, batch_size=8, epochs=2,
            steps_per_execution=3)
    assert l1 == l3 and len(l1) == 2
    np.testing.assert_array_equal(f1["w"], f3["w"])


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    probs = rng.dirichlet(np.ones(4), size=6).astype(np.float32)
    labels = rng.integers(0, 4, 6)
    onehot = np.eye(4, dtype=np.float32)[labels]
    binary = rng.integers(0, 2, (6, 4)).astype(np.float32)
    cases = {"categorical_crossentropy": (probs, onehot),
             "sparse_categorical_crossentropy": (probs, labels),
             "binary_crossentropy": (probs, binary),
             "mse": (probs, onehot), "mae": (probs, onehot)}
    assert sorted(train.LOSSES) == sorted(jax_train.LOSSES) == sorted(cases)
    for name, (p, t) in cases.items():
        got = train.resolve_loss(name)(torch.from_numpy(p),
                                       torch.from_numpy(t))
        want = np.asarray(jax_train.resolve_loss(name)(p, t))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss"):
        train.resolve_loss("nope")


def test_fit_raises_on_parts_not_ported(blobs, monkeypatch):
    """(The name is the one this test had while multi-process input was
    not ported.)  Both fits take ``mesh=``: this process's mesh fits as no
    mesh does; a mesh of two devices in one process and a weight spec
    that really splits are the documented deviations; in a process group
    the stream fit requires ``steps_per_epoch`` before any collective."""
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(4)
    x = rng.normal(size=(24, 3)).astype(np.float32)
    y = (np.arange(24) % 2).astype(np.int64)
    w = rng.normal(0, 0.1, (3, 2)).astype(np.float32)
    kw = dict(loss=train.softmax_cross_entropy, batch_size=8, epochs=2,
              optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))

    def predict(p, xb):
        return xb @ p["w"]

    with sparkdl_tpu_torch.default_device("cpu"):
        base = train.fit_data_parallel(predict, {"w": w}, x, y, **kw)
        on_mesh = train.fit_data_parallel(predict, {"w": w}, x, y,
                                          mesh=mesh_lib.get_mesh(), **kw)
        assert base[1] == on_mesh[1]
        np.testing.assert_array_equal(base[0]["w"], on_mesh[0]["w"])
        two = mesh_lib.get_mesh(devices=["cpu", "cpu"])
        with pytest.raises(NotImplementedError, match="one card per process"):
            train.fit_data_parallel(predict, {"w": w}, x, y, mesh=two, **kw)
        wt = torch.tensor(w, requires_grad=True)
        split = mesh_lib.get_mesh(devices=["cpu", "cpu"], model_parallel=2)
        with pytest.raises(NotImplementedError, match="one card per process"):
            train.make_train_step(
                predict, "mse", torch.optim.SGD([wt], lr=0.1), {"w": wt},
                mesh=split,
                param_specs=lambda path, leaf: mesh_lib.P(None, "model"))
        # a spec naming an axis of size 1 splits nothing: taken
        step = train.make_train_step(
            predict, "mse", torch.optim.SGD([wt], lr=0.1), {"w": wt},
            mesh=mesh_lib.get_mesh(),
            param_specs=lambda path, leaf: mesh_lib.P(None, "model"))
        assert step.param_shardings["w"].spec == mesh_lib.P(None, "model")
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
        with pytest.raises(ValueError, match="requires steps_per_epoch"):
            train.fit_data_parallel_stream(predict, {"w": w},
                                           lambda: iter([(x, y)]), **kw)


def test_fit_without_cuda_raises(blobs, monkeypatch):
    """The new entry point follows the device rule: no card and no CPU
    asked for raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sparkdl_tpu_torch.set_default_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogisticRegression(maxIter=1).fit(DataFrame(blobs))


@pytest.mark.parametrize("metric", ["accuracy", "f1", "weightedPrecision",
                                    "weightedRecall"])
def test_multiclass_evaluator_matches_jax(metric):
    rng = np.random.default_rng(9)
    cols = {"label": rng.integers(0, 4, 40),
            "prediction": rng.integers(0, 5, 40)}
    got = MulticlassClassificationEvaluator(metricName=metric).evaluate(
        DataFrame(cols))
    want = JaxMulticlassEvaluator(metricName=metric).evaluate(
        JaxDataFrame(cols))
    assert got == want and 0 < got < 1


def test_binary_evaluator_matches_jax_with_ties():
    rng = np.random.default_rng(10)
    scores = rng.integers(0, 5, 30) / 4.0  # many ties
    cols = {"label": (np.arange(30) % 2).astype(np.int64),
            "probability": [[1 - s, s] for s in scores]}
    got = BinaryClassificationEvaluator().evaluate(DataFrame(cols))
    want = JaxBinaryEvaluator().evaluate(JaxDataFrame(cols))
    assert got == want and 0 < got < 1
    assert BinaryClassificationEvaluator().isLargerBetter()


@pytest.fixture
def tinted_frame():
    """Two classes of four 75x75 images each, tinted apart, with labels."""
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    rng = np.random.default_rng(3)
    bases = np.asarray([[200, 40, 40], [40, 40, 200]], np.float32)
    labels = np.repeat([0, 1], 4)
    imgs = [np.clip(bases[k] + rng.normal(0, 40, (75, 75, 3)), 0, 255
                    ).astype(np.uint8) for k in labels]
    df = DataFrame(structsToArrow([imageArrayToStruct(im) for im in imgs]))
    return df.withColumn("label", pa.array(labels.astype(np.int64)))


def test_featurizer_lr_pipeline_fits_and_transforms(tinted_frame,
                                                    monkeypatch):
    """``Pipeline([DeepImageFeaturizer("InceptionV3"),
    LogisticRegression()])`` through the port's stages on the CPU, with
    the registry's InceptionV3 narrowed to a 75x75 input (widths full)."""
    import dataclasses

    import sparkdl_tpu_torch.transformers.named_image as ni
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.transformers.base import Pipeline, PipelineModel

    narrow = dataclasses.replace(get_model_spec("InceptionV3"),
                                 input_size=(75, 75))
    monkeypatch.setattr(ni, "get_model_spec", lambda name: narrow)
    monkeypatch.setattr(ni, "_ENGINE_CACHE", ni.new_engine_cache())
    monkeypatch.setattr(ni, "_MODEL_CACHE", {})
    monkeypatch.delenv("SPARKDL_FUSED_HEADS", raising=False)
    monkeypatch.delenv("SPARKDL_S2D_STEM", raising=False)
    pipe = Pipeline(stages=[
        ni.DeepImageFeaturizer(inputCol="image", outputCol="features",
                               modelName="InceptionV3", batchSize=4),
        LogisticRegression(maxIter=10, batchSize=8)])
    with sparkdl_tpu_torch.default_device("cpu"):
        model = pipe.fit(tinted_frame)
        out = model.transform(tinted_frame)
    assert isinstance(model, PipelineModel)
    feats = out.column_to_numpy("features")
    assert feats.shape == (8, 2048) and np.isfinite(feats).all()
    probs = out.column_to_numpy("probability")
    assert probs.shape == (8, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert MulticlassClassificationEvaluator().evaluate(out) == 1.0
