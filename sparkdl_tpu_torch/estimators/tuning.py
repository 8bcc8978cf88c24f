"""Hyperparameter tuning: ParamGridBuilder / CrossValidator (port of
``sparkdl_tpu/estimators/tuning.py``).

The reference's tuning story (``KerasImageFileEstimator`` +
``CrossValidator`` + ``ParamGridBuilder``) relies on pyspark.ml.tuning;
here it is rebuilt with the same string-addressable param-grid contract.
Folds come from the same numpy permutation as the JAX package's
(``_kfold_indices``), so both packages fit the same rows per fold; each
fold's maps go through the estimator's ``fitMultiple``, which loads the
data once and shares it across maps.  ``parallelism=k`` is handed to an
estimator that has the param, whose ``fitMultiple`` then fits the maps
concurrently on k slices of the device mesh.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.estimators.evaluation import Evaluator
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.param.params import Param, keyword_only
from sparkdl_tpu_torch.transformers.base import Estimator, Model
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ParamGridBuilder:
    """Builds [{Param: value}] grids — pyspark.ml.tuning.ParamGridBuilder
    contract (addGrid/baseOn/build)."""

    def __init__(self):
        self._grid: Dict[Param, List[Any]] = {}
        self._base: Dict[Param, Any] = {}

    def addGrid(self, param: Param, values: Sequence[Any]
                ) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError(
                f"addGrid expects a Param, got {type(param).__name__}")
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        if len(args) == 1 and isinstance(args[0], dict):
            self._base.update(args[0])
        else:
            for param, value in args:
                self._base[param] = value
        return self

    def build(self) -> List[Dict[Param, Any]]:
        keys = list(self._grid.keys())
        maps = []
        for combo in itertools.product(*(self._grid[k] for k in keys)):
            m = dict(self._base)
            m.update(dict(zip(keys, combo)))
            maps.append(m)
        return maps or [dict(self._base)]


def _kfold_indices(n: int, k: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    return [order[i::k] for i in range(k)]


def _take_rows(df: DataFrame, idx: np.ndarray) -> DataFrame:
    return DataFrame(df.table.take(np.sort(idx)))


class CrossValidatorModel(Model):
    """The best model refit on the full data, and each map's metric."""

    def __init__(self, bestModel: Model, avgMetrics: List[float]):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics)

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)

    def _persist(self, path):
        from sparkdl_tpu_torch import persistence

        names = persistence.save_nested([self.bestModel], path)
        return ({"bestModel": names[0],
                 "avgMetrics": [float(m) for m in self.avgMetrics]},
                None, {})

    @classmethod
    def _restore(cls, extra, tensors, pickles, path):
        from sparkdl_tpu_torch import persistence

        best = persistence.load_stage(
            os.path.join(path, "stages", extra["bestModel"]))
        return cls(best, extra.get("avgMetrics", []))


class CrossValidator(Estimator):
    """K-fold model selection over a param grid.

    pyspark.ml.tuning.CrossValidator contract: ``estimator``,
    ``estimatorParamMaps`` (from ParamGridBuilder), ``evaluator``,
    ``numFolds``; ``fit`` returns a CrossValidatorModel holding the best
    model refit on the full data plus per-map average metrics.
    """

    @keyword_only
    def __init__(self, estimator: Optional[Estimator] = None,
                 estimatorParamMaps: Optional[List[Dict]] = None,
                 evaluator: Optional[Evaluator] = None,
                 numFolds: int = 3, seed: int = 0, parallelism: int = 1):
        super().__init__()
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps
        self.evaluator = evaluator
        self.numFolds = int(numFolds)
        self.seed = int(seed)
        # pyspark.ml.tuning parity: how many param-map fits may run
        # concurrently; forwarded to the estimator's own `parallelism`
        # param when it has one
        self.parallelism = int(parallelism)

    def _effective_estimator(self) -> Estimator:
        est = self.estimator
        if (self.parallelism > 1 and hasattr(est, "hasParam")
                and est.hasParam("parallelism")):
            return est.copy({est.getParam("parallelism"): self.parallelism})
        return est

    def _fit(self, dataset) -> CrossValidatorModel:
        est, maps, ev = (self._effective_estimator(),
                         self.estimatorParamMaps, self.evaluator)
        if est is None or not maps or ev is None:
            raise ValueError(
                "CrossValidator requires estimator, estimatorParamMaps and "
                "evaluator")
        n = len(dataset)
        if self.numFolds < 2:
            raise ValueError("numFolds must be >= 2")
        folds = _kfold_indices(n, self.numFolds, self.seed)
        metrics = np.zeros(len(maps), dtype=np.float64)
        for f, val_idx in enumerate(folds):
            train_idx = np.concatenate(
                [folds[i] for i in range(self.numFolds) if i != f])
            train_df = _take_rows(dataset, train_idx)
            val_df = _take_rows(dataset, val_idx)
            for m, (_, model) in zip(
                    range(len(maps)), est.fitMultiple(train_df, maps)):
                metric = ev.evaluate(model.transform(val_df))
                metrics[m] += metric / self.numFolds
                logger.info("fold %d map %d: %.4f", f, m, metric)
        best = int(np.argmax(metrics) if ev.isLargerBetter()
                   else np.argmin(metrics))
        logger.info("best param map %d (avg metric %.4f); refitting on full "
                    "data", best, metrics[best])
        best_model = est.fit(dataset, maps[best])
        return CrossValidatorModel(best_model, list(metrics))


class TrainValidationSplit(Estimator):
    """Single-split variant (pyspark.ml.tuning.TrainValidationSplit)."""

    @keyword_only
    def __init__(self, estimator: Optional[Estimator] = None,
                 estimatorParamMaps: Optional[List[Dict]] = None,
                 evaluator: Optional[Evaluator] = None,
                 trainRatio: float = 0.75, seed: int = 0,
                 parallelism: int = 1):
        super().__init__()
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps
        self.evaluator = evaluator
        self.trainRatio = float(trainRatio)
        self.seed = int(seed)
        self.parallelism = int(parallelism)

    _effective_estimator = CrossValidator._effective_estimator

    def _fit(self, dataset) -> CrossValidatorModel:
        est, maps, ev = (self._effective_estimator(),
                         self.estimatorParamMaps, self.evaluator)
        if est is None or not maps or ev is None:
            raise ValueError(
                "TrainValidationSplit requires estimator, estimatorParamMaps "
                "and evaluator")
        n = len(dataset)
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(n)
        cut = int(n * self.trainRatio)
        if cut == 0 or cut == n:
            raise ValueError(f"trainRatio {self.trainRatio} leaves an empty "
                             f"split for {n} rows")
        train_df = _take_rows(dataset, order[:cut])
        val_df = _take_rows(dataset, order[cut:])
        metrics = []
        for _, model in est.fitMultiple(train_df, maps):
            metrics.append(ev.evaluate(model.transform(val_df)))
        metrics = np.asarray(metrics)
        best = int(np.argmax(metrics) if ev.isLargerBetter()
                   else np.argmin(metrics))
        best_model = est.fit(dataset, maps[best])
        return CrossValidatorModel(best_model, list(metrics))
