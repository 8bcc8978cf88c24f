"""Estimator layer (port of ``sparkdl_tpu.estimators``): the
logistic-regression head of the transfer-learning recipe and the
evaluators.  The image-file estimator and tuning are not ported yet
(ROADMAP.md queue A item 6)."""

from sparkdl_tpu_torch.estimators.classification import (
    LogisticRegression, LogisticRegressionModel)
from sparkdl_tpu_torch.estimators.evaluation import (
    BinaryClassificationEvaluator, Evaluator,
    MulticlassClassificationEvaluator)

__all__ = [
    "BinaryClassificationEvaluator", "Evaluator", "LogisticRegression",
    "LogisticRegressionModel", "MulticlassClassificationEvaluator",
]
