"""The port's tuning (``estimators/tuning.py``) held against the JAX
package's on the CPU: ``ParamGridBuilder``, ``CrossValidator`` and
``TrainValidationSplit`` over a ``KerasImageFileEstimator`` fitting a small
Keras CNN (written by Keras here), and the CV model's persistence.

24 PNG files in two classes; each of the 3 folds holds 8 rows and fits on
16 with a batch of 8 (multiples of 8, as JAX's 8-device CPU mesh needs to
draw the same batches).  The grid is config 5's: optimizer {adam, sgd} x
fitParams {1 epoch, 2 epochs}.  The evaluator is accuracy over the
argmax of the predicted probabilities.
"""

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.estimators import CrossValidator as JaxCV
from sparkdl_tpu.estimators import KerasImageFileEstimator as JaxKeras
from sparkdl_tpu.estimators import \
    MulticlassClassificationEvaluator as JaxEvaluator
from sparkdl_tpu.estimators import ParamGridBuilder as JaxGrid
from sparkdl_tpu.estimators import TrainValidationSplit as JaxTVS
from sparkdl_tpu.estimators.tuning import _kfold_indices as jax_kfold
from sparkdl_tpu.frame import DataFrame as JaxDataFrame
from sparkdl_tpu_torch.estimators import (CrossValidator, CrossValidatorModel,
                                          KerasImageFileEstimator,
                                          MulticlassClassificationEvaluator,
                                          ParamGridBuilder,
                                          TrainValidationSplit)
from sparkdl_tpu_torch.estimators.tuning import _kfold_indices
from sparkdl_tpu_torch.frame import DataFrame

# the refit best model's probabilities: f32 fits of 1-2 epochs
PROBS_TOL = dict(rtol=1e-4, atol=1e-5)
N_ROWS = 24


def load8(uri):
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((8, 8))
    return np.asarray(img, dtype=np.float32) / 255.0


@pytest.fixture(scope="module")
def columns(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(7)
    paths, labels = [], []
    for i in range(N_ROWS):
        c = int(rng.integers(0, 2))
        base = np.asarray([190, 60, 60] if c else [60, 60, 190])
        img = np.clip(base + rng.normal(0, 60, (12, 12, 3)), 0, 255)
        p = str(d / f"img_{i:02d}.png")
        Image.fromarray(img.astype(np.uint8)).save(p)
        paths.append(p)
        labels.append(c)
    return {"uri": paths, "label": labels,
            "onehot": [[1.0 - c, float(c)] for c in labels]}


@pytest.fixture(scope="module")
def keras_path(tmp_path_factory):
    import keras
    from keras import layers as kl

    keras.utils.set_random_seed(3)
    model = keras.Sequential([
        kl.Input((8, 8, 3)),
        kl.Conv2D(4, 3, padding="same", activation="relu"),
        kl.BatchNormalization(),
        kl.Dropout(0.2),
        kl.AveragePooling2D(2),
        kl.GlobalMaxPooling2D(),
        kl.Dense(2, activation="softmax")])
    path = str(tmp_path_factory.mktemp("keras") / "cnn.keras")
    model.save(path)
    return path


def _setup(pkg, keras_path):
    est_cls, grid_cls, ev_cls = pkg
    est = est_cls(inputCol="uri", outputCol="preds", labelCol="onehot",
                  modelFile=keras_path, imageLoader=load8,
                  kerasLoss="categorical_crossentropy", batchSize=8)
    # the JAX KerasImageFileEstimator has no parallelism default (its
    # fitMultiple raises KeyError without one); the port's is 1
    est.set(est.parallelism, 1)
    grid = (grid_cls().addGrid(est.optimizer, ["adam", "sgd"])
            .addGrid(est.fitParams, [{"epochs": 1}, {"epochs": 2}]).build())
    ev = ev_cls(labelCol="label", predictionCol="preds")
    return est, grid, ev


PORT = (KerasImageFileEstimator, ParamGridBuilder,
        MulticlassClassificationEvaluator)
JAX = (JaxKeras, JaxGrid, JaxEvaluator)


def test_param_grid_and_folds_match_jax(keras_path):
    est, grid, _ = _setup(PORT, keras_path)
    jest, jgrid, _ = _setup(JAX, keras_path)
    assert [{p.name: v for p, v in m.items()} for m in grid] == \
        [{p.name: v for p, v in m.items()} for m in jgrid]
    assert len(grid) == 4
    base = ParamGridBuilder().baseOn({est.batchSize: 8}).addGrid(
        est.optimizer, ["sgd"]).build()
    assert [{p.name: v for p, v in m.items()} for m in base] == \
        [{"batchSize": 8, "optimizer": "sgd"}]
    with pytest.raises(TypeError, match="Param"):
        ParamGridBuilder().addGrid("optimizer", ["sgd"])
    for n, k, seed in ((24, 3, 0), (23, 4, 5)):
        for a, b in zip(_kfold_indices(n, k, seed), jax_kfold(n, k, seed)):
            np.testing.assert_array_equal(a, b)


def test_cross_validator_matches_jax(columns, keras_path, tmp_path):
    """avgMetrics and the chosen grid point equal JAX's; the best model
    refit on all 24 rows predicts as JAX's; the CV model saves and loads
    bit for bit."""
    est, grid, ev = _setup(PORT, keras_path)
    jest, jgrid, jev = _setup(JAX, keras_path)
    jcv = JaxCV(estimator=jest, estimatorParamMaps=jgrid, evaluator=jev,
                numFolds=3, seed=11).fit(JaxDataFrame(columns))
    with sparkdl_tpu_torch.default_device("cpu"):
        cv = CrossValidator(estimator=est, estimatorParamMaps=grid,
                            evaluator=ev, numFolds=3, seed=11).fit(
            DataFrame(columns))
        out = cv.transform(DataFrame(columns)).column_to_numpy("preds")
        cv.save(str(tmp_path / "cv"))
        back = CrossValidatorModel.load(str(tmp_path / "cv"))
        again = back.transform(DataFrame(columns)).column_to_numpy("preds")
    assert len(cv.avgMetrics) == 4
    assert cv.avgMetrics == pytest.approx(jcv.avgMetrics, abs=1e-12)
    best = int(np.argmax(cv.avgMetrics))
    assert best == int(np.argmax(jcv.avgMetrics))
    assert len(cv.bestModel.trainLosses) == [1, 2, 1, 2][best]
    want = jcv.transform(JaxDataFrame(columns)).column_to_numpy("preds")
    np.testing.assert_allclose(out, want, **PROBS_TOL)
    np.testing.assert_array_equal(again, out)
    assert back.avgMetrics == cv.avgMetrics


def test_train_validation_split_matches_jax(columns, keras_path):
    est, grid, ev = _setup(PORT, keras_path)
    jest, jgrid, jev = _setup(JAX, keras_path)
    jtvs = JaxTVS(estimator=jest, estimatorParamMaps=jgrid, evaluator=jev,
                  trainRatio=2 / 3, seed=4).fit(JaxDataFrame(columns))
    with sparkdl_tpu_torch.default_device("cpu"):
        tvs = TrainValidationSplit(estimator=est, estimatorParamMaps=grid,
                                   evaluator=ev, trainRatio=2 / 3,
                                   seed=4).fit(DataFrame(columns))
    assert tvs.avgMetrics == pytest.approx(jtvs.avgMetrics, abs=1e-12)
    assert int(np.argmax(tvs.avgMetrics)) == int(np.argmax(jtvs.avgMetrics))
    with pytest.raises(ValueError, match="empty split"):
        TrainValidationSplit(estimator=est, estimatorParamMaps=grid,
                             evaluator=ev, trainRatio=1.0).fit(
            DataFrame(columns))


def test_parallelism_is_forwarded_and_fits_sequentially(columns, keras_path):
    """CrossValidator(parallelism=k) sets the estimator's parallelism; on
    one device its maps still fit one after another, with the sequential
    run's results."""
    est, grid, ev = _setup(PORT, keras_path)
    cv = CrossValidator(estimator=est, estimatorParamMaps=grid[:2],
                        evaluator=ev, numFolds=2, parallelism=3)
    assert cv._effective_estimator().getOrDefault(est.parallelism) == 3
    sub = {k: v[:16] for k, v in columns.items()}
    with sparkdl_tpu_torch.default_device("cpu"):
        par = cv.fit(DataFrame(sub))
        cv.parallelism = 1
        seq = cv.fit(DataFrame(sub))
    assert par.avgMetrics == seq.avgMetrics
    for k, v in seq.bestModel.getModelFunction().module.state_dict().items():
        assert torch.equal(
            par.bestModel.getModelFunction().module.state_dict()[k], v)
    with pytest.raises(ValueError, match="numFolds"):
        CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=ev,
                       numFolds=1).fit(DataFrame(sub))
