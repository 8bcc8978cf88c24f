"""Image-file estimator: fine-tuning and the tuning fan-out (port of
``sparkdl_tpu/estimators/image_file_estimator.py``).

The user's images are loaded once on the host (threaded, cached per URI
in a byte-bounded LRU, ``SPARKDL_DECODE_CACHE_MB``) and each fit runs
through ``parallel.train.fit_data_parallel`` on the default mesh (every
visible card unless the CPU was asked for, as JAX's fit takes every local
chip), with its steps captured as CUDA graphs on a card; each data group
of the mesh runs its rows through its own copy of the module.  In a
``torch.distributed`` group each rank fits on its own shard of the rows
(``parallel.distributed.shard_files``), over its own data groups where it
holds several slots, and the ranks all-reduce every step.  ``fitMultiple`` shares the loaded arrays across param maps and,
with ``parallelism > 1``, fits them concurrently on slices of the mesh,
as JAX's does.  ``fit(source)`` with a callable source of record
batches streams instead (``_fit_stream``): nothing is loaded ahead.

Which tensors a fit trains is what the JAX fit trains:

  * a model without BatchNorm running statistics (a converted Keras
    model, whose moving statistics live in its own BatchNormalization
    layers): every tensor of the JAX package's variable tree, so a Keras
    model's ``moving_mean`` / ``moving_variance`` are trained BY GRADIENT
    with the rest, as the JAX fit does (a Keras ``fit`` would update them
    as batch statistics instead);
  * a module with running statistics (a zoo model, ``from_module``): its
    parameters, with the statistics frozen and the module in eval mode,
    through its unfused route (the fused kernels have no backward);
    ``trainBatchStats=True`` runs ``ModelFunction.train_fn`` instead, with
    flax's BatchNorm update.

A fit never changes the estimator's model: it trains copies of the tensors
(``graph.function.apply_with`` runs the model's ``fn`` with them) and
returns a new module in eval mode, its parameters without
``requires_grad``, on the CPU, which ``transform`` runs through the engine.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from sparkdl_tpu_torch.graph.function import (ModelFunction, apply_with,
                                              batch_stat_names)
from sparkdl_tpu_torch.models.layers import current_data_group
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.params import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import (CanLoadImage, HasBatchSize,
                                            HasInputCol, HasLabelCol,
                                            HasOutputCol)
from sparkdl_tpu_torch.parallel.train import (fit_data_parallel,
                                              fit_data_parallel_stream,
                                              group_devices,
                                              resolve_fit_mesh)
from sparkdl_tpu_torch.transformers.base import Estimator, Model
from sparkdl_tpu_torch.utils.cache import ByteBoundedLRU
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def variable_names(module: nn.Module) -> List[str]:
    """The names of the tensors the JAX package's variable tree holds for
    a model without BatchNorm running statistics: every parameter, and the
    moving statistics of each converted Keras BatchNormalization layer
    (buffers here, variables there).  Constants such as a Rescaling's
    per-channel scale are not variables."""
    from sparkdl_tpu_torch.graph.keras_convert import keras_batchnorm_names

    return [n for n, _ in module.named_parameters()] + \
        keras_batchnorm_names(module)


class ImageFileEstimator(Estimator, HasInputCol, HasLabelCol, HasOutputCol,
                         HasBatchSize, CanLoadImage):
    """Fine-tune a model on images loaded from a URI column.

    Params mirror the reference's (``kerasOptimizer``/``kerasLoss``/
    ``kerasFitParams`` become ``optimizer``/``loss``/``fitParams``; the
    Keras-named aliases live on :class:`KerasImageFileEstimator`).
    """

    modelFunction = Param(
        "undefined", "modelFunction",
        "trainable ModelFunction (fn(module, x) -> predictions)",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    optimizer = Param(
        "undefined", "optimizer",
        "optimizer factory (params -> torch.optim.Optimizer), zero-arg "
        "factory, or name (adam/sgd/rmsprop/...; optax's defaults)",
        typeConverter=SparkDLTypeConverters.toOptimizer)

    loss = Param(
        "undefined", "loss",
        "loss name (categorical_crossentropy/...) or callable (pred, y)->[B]",
        typeConverter=SparkDLTypeConverters.toLoss)

    fitParams = Param(
        "undefined", "fitParams",
        "fit settings: {'epochs': int, 'shuffle': bool, 'seed': int, "
        "'checkpoint_dir': str, 'checkpoint_every_epochs': int, "
        "'steps_per_execution': int}",
        typeConverter=TypeConverters.toDict)

    trainBatchStats = Param(
        "undefined", "trainBatchStats",
        "update BatchNorm statistics during the fit (flax's train-mode "
        "BatchNorm).  Default False: statistics stay frozen (inference-mode "
        "fine-tuning).  Requires a model with a train-mode apply "
        "(ModelFunction.train_fn, e.g. from_module on a BatchNorm module)",
        typeConverter=TypeConverters.toBoolean)

    parallelism = Param(
        "undefined", "parallelism",
        "max param maps fitted concurrently by fitMultiple: the device "
        "mesh is carved into min(parallelism, maps, devices) equal slices, "
        "one thread each (CrossValidator(parallelism=) reaches it); one "
        "device, or a multi-process run, fits the maps sequentially",
        typeConverter=TypeConverters.toInt)

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 labelCol: Optional[str] = None,
                 modelFunction=None,
                 imageLoader=None,
                 optimizer=None,
                 loss: Optional[Any] = None,
                 fitParams: Optional[Dict] = None,
                 batchSize: Optional[int] = None,
                 trainBatchStats: Optional[bool] = None,
                 parallelism: Optional[int] = None):
        super().__init__()
        self._setDefault(batchSize=32, fitParams={},
                         loss="categorical_crossentropy",
                         trainBatchStats=False, parallelism=1)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol: Optional[str] = None,
                  outputCol: Optional[str] = None,
                  labelCol: Optional[str] = None,
                  modelFunction=None,
                  imageLoader=None,
                  optimizer=None,
                  loss: Optional[Any] = None,
                  fitParams: Optional[Dict] = None,
                  batchSize: Optional[int] = None,
                  trainBatchStats: Optional[bool] = None,
                  parallelism: Optional[int] = None):
        return self._set(**self._input_kwargs)

    def getTrainBatchStats(self) -> bool:
        return bool(self.getOrDefault(self.trainBatchStats))

    # -- param access ------------------------------------------------------
    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)

    def getOptimizer(self):
        if self.isDefined(self.optimizer) and self.isSet(self.optimizer):
            return self.getOrDefault(self.optimizer)
        return None

    def getLoss(self):
        return self.getOrDefault(self.loss)

    def getFitParams(self) -> Dict:
        return dict(self.getOrDefault(self.fitParams))

    # -- validation (reference: _validateParams) ---------------------------
    def _validateParams(self):
        missing = []
        for p in ("inputCol", "labelCol", "outputCol", "imageLoader"):
            if not self.isDefined(self.getParam(p)) or not self.isSet(
                    self.getParam(p)):
                missing.append(p)
        try:
            self.getModelFunction()
        except KeyError:
            missing.append("modelFunction")
        if missing:
            raise ValueError(
                f"{type(self).__name__} requires params {missing} to be set")
        return True

    # -- data loading (reference: _getNumpyFeaturesAndLabels) --------------
    @staticmethod
    def _stack_labels(labels) -> np.ndarray:
        y = np.asarray(labels)
        if y.dtype == object:  # one-hot rows as lists
            y = np.asarray([np.asarray(v, dtype=np.float32) for v in labels])
        return y

    def _decode_uris(self, uris, loader) -> list:
        """Threaded decode of a URI list to arrays."""
        with ThreadPoolExecutor(min(16, max(2, len(uris)))) as ex:
            return list(ex.map(lambda u: np.asarray(loader(u)), uris))

    def _load_numpy(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        """Decode the URI column to a stacked float32 batch + labels.

        Decoded images are cached per URI on the estimator, so a
        CrossValidator's k folds x m maps + final refit pay ONE decode pass
        over the dataset.  The cache is keyed by the imageLoader and shared
        by ``copy()``d estimators (``Params.copy`` shallow-copies
        ``__dict__``), and bounded: a byte-capped LRU, default 2048 MB,
        ``SPARKDL_DECODE_CACHE_MB`` (0 disables caching)."""
        uris = dataset.table.column(self.getInputCol()).to_pylist()
        labels = dataset.table.column(self.getLabelCol()).to_pylist()
        loader = self.getImageLoader()
        cap = int(float(os.environ.get("SPARKDL_DECODE_CACHE_MB", "2048"))
                  * 1_000_000)
        cache = self.__dict__.get("_decode_cache")
        if cache is None or cache[0] is not loader or cache[1].cap_bytes != cap:
            cache = (loader, ByteBoundedLRU(cap))
            self.__dict__["_decode_cache"] = cache
        lru = cache[1]
        unique = list(dict.fromkeys(uris))
        local = {u: lru.get(u) for u in unique}
        missing = [u for u in unique if local[u] is None]
        if missing:
            for u, arr in zip(missing, self._decode_uris(missing, loader)):
                local[u] = arr
                lru.put(u, arr)
        x = np.stack([local[u] for u in uris]).astype(np.float32)
        return x, self._stack_labels(labels)

    def clearDecodeCache(self) -> None:
        """Drop cached decoded images."""
        self.__dict__.pop("_decode_cache", None)

    # -- fitting -----------------------------------------------------------
    def _common_fit_kwargs(self) -> Dict:
        fp = self.getFitParams()
        return dict(
            optimizer=self.getOptimizer(),
            loss=self.getLoss(),
            batch_size=self.getBatchSize(),
            epochs=int(fp.get("epochs", 1)),
            checkpoint_dir=fp.get("checkpoint_dir"),
            checkpoint_every_epochs=int(fp.get("checkpoint_every_epochs", 1)))

    def _fit_with_runner(self, runner, common: Dict,
                         mesh=None) -> "ImageFileModel":
        """Shared fit logic: ``runner(fn, params, **kw) -> (fitted,
        losses)`` binds the data; this method picks the tensors to train
        (see the module docstring), fits copies of them on ``mesh``
        (default: the fit's default mesh) and assembles the fitted model.
        Each data group of the mesh runs its rows through a module of its
        own on its device (``models.layers.current_data_group`` names the
        group), whose trained tensors the fit passes in."""
        mf = self.getModelFunction()
        mesh = resolve_fit_mesh(mesh)
        devices = group_devices(mesh)
        module = copy.deepcopy(mf.module).to(devices[0])
        tensors = dict(module.named_parameters())
        tensors.update(module.named_buffers())
        stat_names = batch_stat_names(module)
        common = dict(common, mesh=mesh)
        modules = [module]

        def replicate():
            # after the train/eval mode is set: the groups' own modules
            modules[1:] = [copy.deepcopy(module).to(d) for d in devices[1:]]

        def group_module():
            group = current_data_group()
            return modules[group[0] if group is not None else 0]

        def predict(p, x):
            return apply_with(mf.fn, group_module(), p, x)

        if self.getTrainBatchStats():
            if mf.train_fn is None or not stat_names:
                raise ValueError(
                    "trainBatchStats=True requires a model with a "
                    "train-mode apply and BatchNorm running statistics "
                    "(e.g. ModelFunction.from_module on a BatchNorm module)")

            def train(v, x):
                return apply_with(mf.train_fn, group_module(),
                                  {**v["params"], **v["batch_stats"]}, x)

            replicate()
            # the generators a train-mode forward draws from (stochastic
            # depth): registered with the captured step, or eager on a CPU
            # one (parallel.train.step_mode)
            gens = [m.generator for mod in modules for m in mod.modules()
                    if isinstance(getattr(m, "generator", None),
                                  torch.Generator)]
            fitted, losses = runner(
                predict, {n: t for n, t in module.named_parameters()},
                train_fn=train, generators=gens,
                stats={n: tensors[n] for n in stat_names}, **common)
            fitted = {**fitted["params"], **fitted["batch_stats"]}
        else:
            # frozen statistics (a module that has them): its parameters
            # train in eval mode; else every variable the JAX tree holds
            module.eval()
            replicate()
            names = ([n for n, _ in module.named_parameters()] if stat_names
                     else variable_names(module))
            fitted, losses = runner(predict, {n: tensors[n] for n in names},
                                    **common)
        del modules[1:]
        module = module.cpu().eval()
        with torch.no_grad():
            for n, t in module.state_dict(keep_vars=True).items():
                if n in fitted:
                    t.copy_(torch.from_numpy(np.asarray(fitted[n])))
        module.requires_grad_(False)
        fitted_mf = ModelFunction(fn=mf.fn, module=module,
                                  train_fn=mf.train_fn,
                                  input_names=mf.input_names,
                                  output_names=mf.output_names)
        model = ImageFileModel(modelFunction=fitted_mf, trainLosses=losses)
        model._set(inputCol=self.getInputCol(),
                   outputCol=self.getOutputCol(),
                   imageLoader=self.getImageLoader(),
                   batchSize=self.getBatchSize())
        # Keras-backed estimators record the source file, so persistence
        # can rebuild the model's structure from it
        if self.hasParam("modelFile") and self.isSet(
                self.getParam("modelFile")):
            model.modelFile = self.getOrDefault(self.getParam("modelFile"))
        return model

    def _fit_on_arrays(self, x: np.ndarray, y: np.ndarray,
                       mesh=None) -> "ImageFileModel":
        fp = self.getFitParams()
        common = self._common_fit_kwargs()
        common.update(shuffle=bool(fp.get("shuffle", True)),
                      seed=int(fp.get("seed", 0)),
                      # k optimizer steps per loss fetch (Keras
                      # steps_per_execution; fit_data_parallel docstring)
                      steps_per_execution=int(
                          fp.get("steps_per_execution", 1)))

        def runner(fn, params, **kw):
            return fit_data_parallel(fn, params, x, y, **kw)

        return self._fit_with_runner(runner, common, mesh)

    def _fit(self, dataset) -> "ImageFileModel":
        self._validateParams()
        if callable(dataset) and not hasattr(dataset, "table"):
            return self._fit_stream(dataset)
        x, y = self._load_numpy(dataset)
        return self._fit_on_arrays(x, y)

    # -- streaming fit (larger-than-RAM datasets) ---------------------------
    def _decode_record_batch(self, rb) -> Tuple[np.ndarray, np.ndarray]:
        """One {inputCol, labelCol} RecordBatch -> (x_chunk, y_chunk).  No
        per-URI cache here: the dataset may not fit in memory."""
        uris = rb.column(rb.schema.get_field_index(
            self.getInputCol())).to_pylist()
        labels = rb.column(rb.schema.get_field_index(
            self.getLabelCol())).to_pylist()
        arrays = self._decode_uris(uris, self.getImageLoader())
        return np.stack(arrays).astype(np.float32), self._stack_labels(labels)

    def _fit_stream(self, source) -> "ImageFileModel":
        """Fit from a re-iterable epoch source, for datasets larger than
        host memory: ``source() -> iterator of pyarrow RecordBatches``
        holding the URI and label columns (``imageIO.iterFileBatches``
        style readers).  Each epoch iterates the source again and decodes
        one record batch at a time, through
        ``parallel.train.fit_data_parallel_stream`` on the estimator's
        device.  ``fitParams`` may carry ``steps_per_epoch`` (required in
        a process group) and ``steps_per_execution``; ``shuffle`` and
        ``seed`` do not apply (the stream's order is the order)."""
        fp = self.getFitParams()
        common = self._common_fit_kwargs()
        common.update(steps_per_epoch=(int(fp["steps_per_epoch"])
                                       if "steps_per_epoch" in fp else None),
                      steps_per_execution=int(
                          fp.get("steps_per_execution", 1)))

        def chunks():
            for rb in source():
                yield self._decode_record_batch(rb)

        def runner(fn, params, **kw):
            return fit_data_parallel_stream(fn, params, chunks, **kw)

        return self._fit_with_runner(runner, common)

    def fitMultiple(self, dataset, paramMaps):
        """One model per param map, in map order.  The data is loaded ONCE
        and reused across maps.  Maps sharing one ``checkpoint_dir`` get a
        ``map_<i>`` subdirectory each.

        With ``parallelism > 1`` the device mesh (the default mesh's
        devices) is carved into k = min(parallelism, maps, devices) equal
        slices (k lowered until it divides the devices) and the maps fit
        concurrently, one thread per slice, each fit data-parallel over its
        slice, as the JAX package fans maps out.  Slices are leased from a
        queue, so a freed thread takes a free slice.  A multi-process run
        warns and fits sequentially (collectives across ranks cannot be
        interleaved across threads), and so does one device."""
        self._validateParams()
        x, y = self._load_numpy(dataset)
        maps = list(paramMaps)

        def map_estimator(i):
            est = self.copy(maps[i])
            fp = est.getFitParams()
            if len(maps) > 1 and fp.get("checkpoint_dir"):
                fp["checkpoint_dir"] = os.path.join(
                    str(fp["checkpoint_dir"]), f"map_{i:03d}")
                est._set(fitParams=fp)
            return est

        import queue

        import sparkdl_tpu_torch
        from sparkdl_tpu_torch.parallel import distributed
        from sparkdl_tpu_torch.parallel import mesh as mesh_lib

        want = max(1, int(self.getOrDefault(self.parallelism)))
        if distributed.process_count() > 1 and want > 1:
            logger.warning("fitMultiple parallelism=%d ignored in a "
                           "multi-process run (collectives across ranks "
                           "cannot be interleaved across threads); fitting "
                           "sequentially", want)
            want = 1
        devs = (list(mesh_lib.get_mesh().devices.flat)
                if want > 1 and len(maps) > 1 else [])
        k = min(want, len(maps), len(devs))
        while k > 1 and len(devs) % k:  # equal slices only
            k -= 1
        if k <= 1:
            for i in range(len(maps)):
                yield i, map_estimator(i)._fit_on_arrays(x, y)
            return
        per = len(devs) // k
        logger.info("fitMultiple fan-out: %d maps over %d mesh slices of "
                    "%d device(s)", len(maps), k, per)
        free: "queue.Queue" = queue.Queue()
        for g in range(k):
            free.put(mesh_lib.get_mesh(devices=devs[g * per:(g + 1) * per]))
        where = sparkdl_tpu_torch._default()

        def work(i):
            mesh = free.get()
            try:
                with sparkdl_tpu_torch.default_device(where):
                    return map_estimator(i)._fit_on_arrays(x, y, mesh=mesh)
            finally:
                free.put(mesh)

        with ThreadPoolExecutor(k) as ex:
            for i, model in enumerate(ex.map(work, range(len(maps)))):
                yield i, model


class ImageFileModel(Model, HasInputCol, HasOutputCol, HasBatchSize,
                     CanLoadImage):
    """Fitted model: applies the trained ModelFunction to images loaded from
    the URI column (the role the returned ``KerasImageFileTransformer``
    played in the reference)."""

    modelFunction = Param(
        "undefined", "modelFunction", "fitted ModelFunction",
        typeConverter=SparkDLTypeConverters.toModelFunction)

    def __init__(self, modelFunction=None, trainLosses=None):
        super().__init__()
        self._setDefault(batchSize=32)
        if modelFunction is not None:
            self._set(modelFunction=modelFunction)
        self.trainLosses = list(trainLosses or [])
        self.modelFile = None

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)

    def _persist(self, path):
        """The fitted tensors always; the structure from ``modelFile`` when
        it is a path (the JAX package's "from-modelFile" route), else the
        ModelFunction's own state (``persistence.modelfunction_state``:
        a converted Keras model as its config, any other as pickles)."""
        from sparkdl_tpu_torch.persistence import (modelfunction_state,
                                                   module_tensors)

        mf = self.getModelFunction()
        extra: Dict[str, Any] = {
            "trainLosses": [float(l) for l in self.trainLosses]}
        pickles: Dict[str, Any] = {}
        if isinstance(self.modelFile, str):
            extra["modelFile"] = self.modelFile
            extra["modelFunction"] = "from-modelFile"
            tensors = module_tensors(mf.module)
        else:
            extra["modelFunction"], tensors, payload = modelfunction_state(mf)
            if payload:
                pickles["modelFunction"] = payload
        if self.isSet(self.getParam("imageLoader")):
            pickles["imageLoader"] = self.getImageLoader()
        return extra, tensors, pickles

    @classmethod
    def _restore(cls, extra, tensors, pickles, path):
        from sparkdl_tpu_torch.persistence import (load_module_tensors,
                                                   modelfunction_from_state)

        if "modelFile" in extra:
            base = ModelFunction.from_keras(extra["modelFile"])
            load_module_tensors(base.module, tensors)
            mf = base
        else:
            mf = modelfunction_from_state(extra["modelFunction"], tensors,
                                          pickles.get("modelFunction"))
        mf.module.requires_grad_(False)
        model = cls(modelFunction=mf, trainLosses=extra.get("trainLosses"))
        model.modelFile = extra.get("modelFile")
        if "imageLoader" in pickles:
            model._set(imageLoader=pickles["imageLoader"])
        return model

    def _transform(self, dataset):
        from sparkdl_tpu_torch.transformers.image_file import \
            ImageFileTransformer

        # One persistent transformer per fitted model: repeated transforms
        # (every CrossValidator evaluation) reuse its engine, so the
        # weights stay on the card and the forward stays captured.  Keyed
        # by the params it was built from: ``Params.copy()`` shallow-copies
        # __dict__, so a copy with another outputCol (or a later set*)
        # must not reuse a transformer built for the old columns.  Holding
        # mf and the loader in the entry keeps their ids from being reused.
        mf = self.getModelFunction()
        loader = self.getImageLoader()
        key = (self.getInputCol(), self.getOutputCol(), self.getBatchSize(),
               id(mf), id(loader))
        cached = self.__dict__.get("_transformer_cache")
        if cached is not None and cached[0] == key:
            t = cached[1]
        else:
            t = ImageFileTransformer(
                inputCol=self.getInputCol(), outputCol=self.getOutputCol(),
                modelFunction=mf, imageLoader=loader,
                batchSize=self.getBatchSize())
            self.__dict__["_transformer_cache"] = (key, t, mf, loader)
        return t.transform(dataset)


class KerasImageFileEstimator(ImageFileEstimator):
    """Reference-parity flavor: Keras param names + ``modelFile`` input
    (``KerasImageFileEstimator(kerasOptimizer=..., kerasLoss=...,
    kerasFitParams=..., modelFile=...)``).  ``modelFile`` is what
    ``ModelFunction.from_keras`` reads: a ``.h5`` / ``.keras`` path or an
    in-memory ``KerasFile``."""

    modelFile = Param(
        "undefined", "modelFile",
        "saved Keras model (.h5/.keras path, or a KerasFile) to fine-tune")

    @keyword_only
    def __init__(self, inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None,
                 labelCol: Optional[str] = None,
                 modelFile=None,
                 imageLoader=None,
                 kerasOptimizer=None,
                 kerasLoss: Optional[Any] = None,
                 kerasFitParams: Optional[Dict] = None,
                 batchSize: Optional[int] = None):
        Estimator.__init__(self)
        self._setDefault(batchSize=32, fitParams={},
                         loss="categorical_crossentropy",
                         trainBatchStats=False, parallelism=1)
        kw = dict(self._input_kwargs)
        # Map keras-named params onto the native ones.
        for keras_name, name in (("kerasOptimizer", "optimizer"),
                                 ("kerasLoss", "loss"),
                                 ("kerasFitParams", "fitParams")):
            value = kw.pop(keras_name, None)
            if value is not None:
                kw[name] = value
        self._set(**kw)

    def getModelFile(self):
        return self.getOrDefault(self.modelFile)

    def getModelFunction(self):
        if not self.isSet(self.modelFunction):
            self._set(modelFunction=ModelFunction.from_keras(
                self.getModelFile()))
        return self.getOrDefault(self.modelFunction)

    def _validateParams(self):
        if not self.isSet(self.modelFunction) and not self.isSet(
                self.getParam("modelFile")):
            raise ValueError(
                "KerasImageFileEstimator requires modelFile (or "
                "modelFunction) to be set")
        return super()._validateParams()
