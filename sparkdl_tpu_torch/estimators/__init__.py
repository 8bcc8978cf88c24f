"""Estimator layer (port of ``sparkdl_tpu.estimators``): the
logistic-regression head of the transfer-learning recipe, the image-file
estimators that fine-tune a model over the device mesh (one card, or one
card per rank of a ``torch.distributed`` group), the tuning estimators and
the evaluators; ``ImageFileEstimator.fit`` also takes a re-iterable
RecordBatch source (the streaming fit)."""

from sparkdl_tpu_torch.estimators.classification import (
    LogisticRegression, LogisticRegressionModel)
from sparkdl_tpu_torch.estimators.evaluation import (
    BinaryClassificationEvaluator, Evaluator,
    MulticlassClassificationEvaluator)
from sparkdl_tpu_torch.estimators.image_file_estimator import (
    ImageFileEstimator, ImageFileModel, KerasImageFileEstimator)
from sparkdl_tpu_torch.estimators.tuning import (CrossValidator,
                                                 CrossValidatorModel,
                                                 ParamGridBuilder,
                                                 TrainValidationSplit)

__all__ = [
    "BinaryClassificationEvaluator", "CrossValidator", "CrossValidatorModel",
    "Evaluator", "ImageFileEstimator", "ImageFileModel",
    "KerasImageFileEstimator", "LogisticRegression",
    "LogisticRegressionModel", "MulticlassClassificationEvaluator",
    "ParamGridBuilder", "TrainValidationSplit",
]
