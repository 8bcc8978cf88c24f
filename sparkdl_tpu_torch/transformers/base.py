"""Stage base classes: Transformer / Estimator / Pipeline (port of
``sparkdl_tpu/transformers/base.py``).

Re-creates the Spark ML Pipeline stage contract the reference builds every
user-facing class on (``pyspark.ml.Transformer``/``Estimator`` — the
reference's stages in ``python/sparkdl/transformers/`` and
``python/sparkdl/estimators/`` all subclass these), over our Arrow-backed
DataFrame instead of Spark's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.param.params import Param, Params, keyword_only


class Transformer(Params):
    """A stage mapping DataFrame -> DataFrame (pyspark.ml.Transformer
    contract: ``transform(dataset, params=None)``)."""

    def transform(self, dataset, params: Optional[Dict] = None):
        if params:
            return self.copy(params).transform(dataset)
        return self._transform(dataset)

    def transformStream(self, batches: Iterable, params: Optional[Dict] = None):
        """Partition-at-a-time transform: lazily map an iterator of Arrow
        ``RecordBatch``es to output ``RecordBatch``es.

        This is the unbounded-dataset path — the analog of the reference's
        per-partition executor loop (SURVEY.md §3.1): each input batch is
        transformed independently and yielded before the next is pulled, so
        peak memory is O(batch), not O(dataset).  Compose with the lazy
        readers (``imageIO.iterFileBatches`` / ``iterImageBatches``) and
        chain stages via ``PipelineModel.transformStream``."""
        if params:
            yield from self.copy(params).transformStream(batches)
            return
        from sparkdl_tpu_torch.frame import DataFrame

        for rb in batches:
            out = self._transform(DataFrame(rb))
            yield from out.table.to_batches()

    def _transform(self, dataset):
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


class Estimator(Params):
    """A stage learning a Model from a DataFrame (pyspark.ml.Estimator
    contract: ``fit(dataset, params=None)`` where params may be a single
    param map or a list of maps — the latter returns one model per map,
    which is what CrossValidator drives)."""

    def fit(self, dataset, params: Optional[Any] = None):
        if isinstance(params, (list, tuple)):
            return [m for _, m in self.fitMultiple(dataset, list(params))]
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def fitMultiple(self, dataset, paramMaps: Sequence[Dict]
                    ) -> Iterable[Tuple[int, Model]]:
        """Yield ``(index, model)`` per param map.  Subclasses override to
        fan out across mesh slices (the reference fanned out one Spark task
        per map — ``keras_image_file_estimator.py — _fitInParallel``)."""
        for i, pm in enumerate(paramMaps):
            yield i, self.copy(pm)._fit(dataset)

    def _fit(self, dataset) -> Model:
        raise NotImplementedError


class PipelineModel(Model):
    """Chain of fitted transformers."""

    def __init__(self, stages: List[Transformer]):
        super().__init__()
        self.stages = list(stages)

    def _transform(self, dataset):
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset

    def transformStream(self, batches, params: Optional[Dict] = None):
        """Lazily chain every stage's ``transformStream``: batch k flows
        through the whole pipeline before batch k+1 is read."""
        if params:
            yield from self.copy(params).transformStream(batches)
            return
        for stage in self.stages:
            batches = stage.transformStream(batches)
        yield from batches

    def _persist(self, path):
        from sparkdl_tpu_torch import persistence

        return {"stages": persistence.save_nested(self.stages, path)}, None, {}

    @classmethod
    def _restore(cls, extra, tensors, pickles, path):
        from sparkdl_tpu_torch import persistence

        return cls(persistence.load_nested(path, extra["stages"]))


class Pipeline(Estimator):
    """Sequential pipeline of stages (pyspark.ml.Pipeline semantics: fitting
    runs estimators in order, feeding each stage the output of the previous
    fitted prefix)."""

    stages = Param("undefined", "stages", "pipeline stages (in order)")

    @keyword_only
    def __init__(self, stages: Optional[List] = None):
        super().__init__()
        self._set(**self._input_kwargs)

    def setStages(self, value: List):
        return self._set(stages=value)

    def getStages(self) -> List:
        return self.getOrDefault(self.stages)

    def _fit(self, dataset) -> PipelineModel:
        fitted: List[Transformer] = []
        stages = self.getStages()
        # Transformers after the last estimator need no data pass.
        last_est = max((i for i, s in enumerate(stages)
                        if isinstance(s, Estimator)), default=-1)
        for i, stage in enumerate(stages):
            if isinstance(stage, Transformer):
                fitted.append(stage)
                if i <= last_est:
                    dataset = stage.transform(dataset)
            elif isinstance(stage, Estimator):
                model = stage.fit(dataset)
                fitted.append(model)
                if i < last_est:
                    dataset = model.transform(dataset)
            else:
                raise TypeError(
                    f"Pipeline stage {i} is neither Transformer nor "
                    f"Estimator: {type(stage).__name__}")
        return PipelineModel(fitted)
