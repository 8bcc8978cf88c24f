"""Classifier head for transfer learning (port of
``sparkdl_tpu/estimators/classification.py``).

The reference's north-star recipe pairs ``DeepImageFeaturizer`` with a Spark
ML classifier (``LogisticRegression`` in the README's flowers example).
This is the port's logistic-regression head with the pyspark.ml column
contract (featuresCol/labelCol/predictionCol/probabilityCol): fitted with
Adam on the default mesh, as JAX's head is (``parallel/train.py``
``fit_data_parallel``: every visible card unless the CPU was asked for,
each global batch split over the mesh's data groups), applied on the
host.  A fitted model saves its ``(w, b)``
through ``sparkdl_tpu_torch.persistence`` (``model.save(path)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa
import torch

from sparkdl_tpu_torch.param.params import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import HasLabelCol
from sparkdl_tpu_torch.parallel.train import (fit_data_parallel,
                                              softmax_cross_entropy)
from sparkdl_tpu_torch.transformers.base import Estimator, Model
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _HasClassifierCols(HasLabelCol):
    featuresCol = Param("undefined", "featuresCol",
                        "input column of feature vectors",
                        typeConverter=TypeConverters.toString)
    predictionCol = Param("undefined", "predictionCol",
                          "output column of predicted class indices",
                          typeConverter=TypeConverters.toString)
    probabilityCol = Param("undefined", "probabilityCol",
                           "output column of class probabilities",
                           typeConverter=TypeConverters.toString)

    def getFeaturesCol(self):
        return self.getOrDefault(self.featuresCol)

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)

    def getProbabilityCol(self):
        return self.getOrDefault(self.probabilityCol)


def _predict(p, xb):
    return xb @ p["w"] + p["b"]  # logits


class LogisticRegression(Estimator, _HasClassifierCols):
    """Multinomial logistic regression fitted with Adam on the default
    mesh."""

    maxIter = Param("undefined", "maxIter", "training epochs",
                    typeConverter=TypeConverters.toInt)
    regParam = Param("undefined", "regParam", "L2 regularization strength",
                     typeConverter=TypeConverters.toFloat)
    learningRate = Param("undefined", "learningRate", "adam learning rate",
                         typeConverter=TypeConverters.toFloat)
    batchSize = Param("undefined", "batchSize", "train batch size",
                      typeConverter=TypeConverters.toInt)
    seed = Param("undefined", "seed", "shuffle/init seed",
                 typeConverter=TypeConverters.toInt)
    standardization = Param(
        "undefined", "standardization",
        "standardize features (zero mean / unit variance) before fitting, "
        "folding the scaler back into the returned linear weights — the "
        "pyspark.ml.LogisticRegression default, and what makes tiny- or "
        "wildly-scaled feature columns (e.g. deep-CNN featurizer outputs) "
        "trainable at a fixed learning rate",
        typeConverter=TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, featuresCol: str = "features", labelCol: str = "label",
                 predictionCol: str = "prediction",
                 probabilityCol: str = "probability",
                 maxIter: int = 50, regParam: float = 0.0,
                 learningRate: float = 0.05, batchSize: int = 256,
                 seed: int = 0, standardization: bool = True):
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         probabilityCol="probability", maxIter=50,
                         regParam=0.0, learningRate=0.05, batchSize=256,
                         seed=0, standardization=True)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, featuresCol: Optional[str] = None,
                  labelCol: Optional[str] = None,
                  predictionCol: Optional[str] = None,
                  probabilityCol: Optional[str] = None,
                  maxIter: Optional[int] = None,
                  regParam: Optional[float] = None,
                  learningRate: Optional[float] = None,
                  batchSize: Optional[int] = None,
                  seed: Optional[int] = None,
                  standardization: Optional[bool] = None):
        return self._set(**self._input_kwargs)

    def _fit(self, dataset) -> "LogisticRegressionModel":
        x = dataset.column_to_numpy(self.getFeaturesCol()).astype(np.float32)
        y = np.asarray(dataset.column_to_numpy(self.getLabelCol()),
                       dtype=np.int64)
        if x.ndim != 2:
            raise ValueError(f"featuresCol must hold vectors; got shape "
                             f"{x.shape}")
        num_classes = int(y.max()) + 1
        mu = np.zeros((x.shape[1],), np.float32)
        sigma = np.ones((x.shape[1],), np.float32)
        if self.getOrDefault(self.standardization):
            mu = x.mean(axis=0)
            sd = x.std(axis=0)
            # constant features train a zero coefficient either way; leave
            # them unscaled so the fold-back below cannot blow up on ~0 std
            sigma = np.where(sd < 1e-7, 1.0, sd).astype(np.float32)
            x = (x - mu) / sigma
        rng = np.random.default_rng(self.getOrDefault(self.seed))
        params = {
            "w": (rng.normal(0, 0.01, (x.shape[1], num_classes))
                  .astype(np.float32)),
            "b": np.zeros((num_classes,), np.float32),
        }
        reg = self.getOrDefault(self.regParam)
        lr = self.getOrDefault(self.learningRate)

        # L2 added to the gradient before Adam (optax's
        # chain(add_decayed_weights(reg), adam(lr)); AdamW would decay the
        # weights after the Adam update instead)
        def optimizer(tensors):
            return torch.optim.Adam(tensors, lr=lr, weight_decay=reg)

        fitted, losses = fit_data_parallel(
            _predict, params, x, y,
            optimizer=optimizer, loss=softmax_cross_entropy,
            batch_size=self.getOrDefault(self.batchSize),
            epochs=self.getOrDefault(self.maxIter),
            seed=self.getOrDefault(self.seed))
        logger.info("LogisticRegression fit: %d classes, final loss %.4f",
                    num_classes, losses[-1] if losses else float("nan"))
        if self.getOrDefault(self.standardization):
            # Fold the scaler into the head so the fitted model stays a
            # pure linear (w, b): ((x-mu)/sigma) @ w + b = x @ w' + b'.
            w = fitted["w"]
            fitted = {
                "w": (w / sigma[:, None]).astype(np.float32),
                "b": (fitted["b"] - (mu / sigma) @ w).astype(np.float32),
            }
        model = LogisticRegressionModel(weights=fitted,
                                        numClasses=num_classes)
        model._set(featuresCol=self.getFeaturesCol(),
                   labelCol=self.getLabelCol(),
                   predictionCol=self.getPredictionCol(),
                   probabilityCol=self.getProbabilityCol())
        return model


class LogisticRegressionModel(Model, _HasClassifierCols):
    """Fitted head: adds prediction + probability columns, on the host."""

    def __init__(self, weights=None, numClasses: int = 0):
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         probabilityCol="probability")
        self.weights = weights
        self.numClasses = numClasses

    def _persist(self, path):
        return ({"numClasses": int(self.numClasses)},
                {"weights": {k: torch.from_numpy(np.asarray(v))
                             for k, v in self.weights.items()}}, {})

    @classmethod
    def _restore(cls, extra, tensors, pickles, path):
        return cls(weights={k: t.numpy() for k, t in
                            tensors["weights"].items()},
                   numClasses=int(extra["numClasses"]))

    def _transform(self, dataset):
        x = dataset.column_to_numpy(self.getFeaturesCol()).astype(np.float32)
        logits = x @ self.weights["w"] + self.weights["b"]
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        pred = p.argmax(axis=1)
        out = dataset.withColumn(
            self.getPredictionCol(), pa.array(pred.astype(np.int64)))
        return out.withColumn(
            self.getProbabilityCol(),
            pa.array([[float(v) for v in row] for row in p],
                     type=pa.list_(pa.float32())))
