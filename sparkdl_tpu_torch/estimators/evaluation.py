"""Evaluators (port of ``sparkdl_tpu/estimators/evaluation.py``).

The reference leaned on pyspark.ml's evaluators inside ``CrossValidator``
(README tuning example).  These provide the same contract
(``evaluate(dataset) -> float``, ``isLargerBetter``) over the port's
DataFrame, on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sparkdl_tpu_torch.param.params import Param, Params, TypeConverters, keyword_only


class Evaluator(Params):
    def evaluate(self, dataset) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class MulticlassClassificationEvaluator(Evaluator):
    """accuracy / weightedPrecision / weightedRecall / f1 over prediction vs
    label columns."""

    labelCol = Param("undefined", "labelCol", "true label column",
                     typeConverter=TypeConverters.toString)
    predictionCol = Param("undefined", "predictionCol",
                          "predicted label column",
                          typeConverter=TypeConverters.toString)
    metricName = Param("undefined", "metricName",
                       "accuracy|f1|weightedPrecision|weightedRecall",
                       typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, labelCol: str = "label",
                 predictionCol: str = "prediction",
                 metricName: str = "accuracy"):
        super().__init__()
        self._setDefault(labelCol="label", predictionCol="prediction",
                         metricName="accuracy")
        self._set(**self._input_kwargs)

    def evaluate(self, dataset) -> float:
        y = np.asarray(dataset.column_to_numpy(
            self.getOrDefault(self.labelCol)), dtype=np.int64)
        p = np.asarray(dataset.column_to_numpy(
            self.getOrDefault(self.predictionCol)))
        if p.ndim == 2:
            # probability/score vectors (e.g. ImageFileModel output):
            # argmax to class indices
            p = np.argmax(p, axis=-1)
        p = p.astype(np.int64)
        metric = self.getOrDefault(self.metricName)
        if metric == "accuracy":
            return float((y == p).mean())
        classes = np.unique(np.concatenate([y, p]))
        precisions, recalls, f1s, weights = [], [], [], []
        for c in classes:
            tp = float(((p == c) & (y == c)).sum())
            fp = float(((p == c) & (y != c)).sum())
            fn = float(((p != c) & (y == c)).sum())
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            precisions.append(prec)
            recalls.append(rec)
            f1s.append(f1)
            weights.append(float((y == c).sum()))
        w = np.asarray(weights) / max(1.0, sum(weights))
        if metric == "weightedPrecision":
            return float(np.dot(w, precisions))
        if metric == "weightedRecall":
            return float(np.dot(w, recalls))
        if metric == "f1":
            return float(np.dot(w, f1s))
        raise ValueError(f"Unknown metricName {metric!r}")


class BinaryClassificationEvaluator(Evaluator):
    """areaUnderROC over a positive-class score column vs binary labels."""

    labelCol = Param("undefined", "labelCol", "true {0,1} label column",
                     typeConverter=TypeConverters.toString)
    rawPredictionCol = Param(
        "undefined", "rawPredictionCol",
        "positive-class score column (float, higher = more positive); a "
        "probability-vector column uses the last element",
        typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, labelCol: str = "label",
                 rawPredictionCol: str = "probability"):
        super().__init__()
        self._setDefault(labelCol="label", rawPredictionCol="probability")
        self._set(**self._input_kwargs)

    def evaluate(self, dataset) -> float:
        y = np.asarray(dataset.column_to_numpy(
            self.getOrDefault(self.labelCol)), dtype=np.int64)
        s = dataset.column_to_numpy(self.getOrDefault(self.rawPredictionCol))
        s = np.asarray(s, dtype=np.float64)
        if s.ndim == 2:
            s = s[:, -1]
        # AUC via rank statistic (ties get average rank)
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(s) + 1)
        sorted_s = s[order]
        i = 0
        while i < len(s):
            j = i
            while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            if j > i:
                ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
            i = j + 1
        n_pos = int((y == 1).sum())
        n_neg = int((y == 0).sum())
        if not n_pos or not n_neg:
            raise ValueError("AUC needs both positive and negative examples")
        return float(
            (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0)
            / (n_pos * n_neg))
