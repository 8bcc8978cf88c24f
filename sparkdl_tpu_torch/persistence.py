"""Stage persistence: save/load for pipeline stages and fitted models (port
of ``sparkdl_tpu/persistence.py``).

Layout per stage directory:

  <path>/metadata.json   — {package, class, uid, params (JSON-able),
                            extra, version}
  <path>/tensors.pt      — ``torch.save`` of the stage's tensors (a dict of
                            name -> tensor), loaded with ``weights_only=True``
  <path>/payload.pkl     — pickled callables (loaders, fns), when present
  <path>/stages/<k>_*/   — nested stages (PipelineModel, CrossValidatorModel)

Stages customize via two hooks:

  ``_persist(self, path) -> (extra: dict, tensors: dict | None,
  pickles: dict)``
  ``cls._restore(cls, extra, tensors, pickles, path) -> stage``

The default implementation persists all explicitly-set JSON-able params and
refuses (loudly) to silently drop non-serializable ones a subclass didn't
handle.  Callables go through pickle — module-level functions round-trip;
lambdas and closures fail at SAVE time with a clear error.  A
ModelFunction is stored as its ``fn``, its ``train_fn`` (when it pickles)
and its module's structure (pickled, with the tensors left on the meta
device) plus the module's tensors in ``tensors.pt``; one converted from Keras (``graph/keras_convert.py``)
stores its model config as JSON instead, and a stage with a ``modelFile``
rebuilds it from the file.

**Compatibility:** a directory written by one package is not read by the
other.  The port writes ``"package": "sparkdl_tpu_torch"`` into the
metadata and refuses a directory without it (the JAX package's, whose
variables are an orbax checkpoint); the JAX package does not read the
port's ``tensors.pt``.

**Trust model:** ``load_stage`` imports the class named in
``metadata.json`` and unpickles ``payload.pkl`` — loading a directory you
did not write is arbitrary code execution (see the :func:`load_stage`
warning).  ``tensors.pt`` is loaded with ``weights_only=True``.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import pickle
import shutil
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_FORMAT_VERSION = 1
_PACKAGE = "sparkdl_tpu_torch"


def module_tensors(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` by name, on the CPU
    (non-persistent buffers too)."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return {k: t.detach().cpu() for k, t in out.items()}


def load_module_tensors(module: nn.Module,
                        tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``tensors`` (:func:`module_tensors` of a module of the same
    structure) into ``module``'s parameters and buffers; raises when the
    names differ."""
    have = dict(module.named_parameters())
    have.update(module.named_buffers())
    if set(have) != set(tensors):
        raise ValueError(f"saved tensors {sorted(set(tensors) ^ set(have))[:5]}"
                         f" do not match the saved module")
    with torch.no_grad():
        for k, t in have.items():
            t.copy_(tensors[k])
    return module


def _module_from(skeleton: nn.Module, tensors: Dict[str, torch.Tensor]
                 ) -> nn.Module:
    """``skeleton`` (tensors on the meta device) on the CPU, filled from
    ``tensors`` (:func:`module_tensors` of the saved module)."""
    return load_module_tensors(skeleton.to_empty(device="cpu"),
                               tensors).eval()


def persistable_train_fn(mf):
    """``mf.train_fn`` if it survives pickling, else None (with a warning),
    as in the JAX package: the restored stage then only loses the ability
    to re-fit with ``trainBatchStats=True``."""
    fn = getattr(mf, "train_fn", None)
    if fn is None:
        return None
    try:
        pickle.dumps(fn)
    except Exception:  # whatever pickling raises for a closure
        logger.warning(
            "modelFunction.train_fn is not picklable (closure?); the "
            "restored stage will have train_fn=None and cannot re-fit "
            "with trainBatchStats=True")
        return None
    return fn


def _is_keras_built(mf) -> bool:
    from sparkdl_tpu_torch.graph.function import _CallModule
    from sparkdl_tpu_torch.graph.keras_convert import KerasModel

    return (isinstance(mf.module, KerasModel)
            and isinstance(mf.fn, _CallModule) and not mf.fn.kwargs)


def modelfunction_state(mf):
    """``(extra, tensors, pickles)`` of a ModelFunction: a Keras-built one
    as its model config (JSON) and ``state_dict``; any other as its
    ``fn`` and module structure (pickled, tensors on the meta device) and
    its module's tensors.  The inverse is :func:`modelfunction_from_state`."""
    if _is_keras_built(mf):
        return ({"keras_config": mf.module.model_config},
                mf.module.state_dict(), {})
    skeleton = copy.deepcopy(mf.module).to("meta")
    payload = {"fn": mf.fn, "module": skeleton,
               "train_fn": persistable_train_fn(mf),
               "input_names": list(mf.input_names),
               "output_names": list(mf.output_names)}
    return {}, module_tensors(mf.module), payload


def modelfunction_from_state(extra: Dict, tensors, payload: Optional[Dict]):
    """Rebuild a ModelFunction from :func:`modelfunction_state`'s parts."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.graph.keras_convert import KerasModel

    if "keras_config" in extra:
        module = KerasModel(extra["keras_config"])
        module.load_state_dict(tensors)
        return ModelFunction.from_module(
            module, input_names=tuple(module.input_names),
            output_names=tuple(module.output_names))
    return ModelFunction(fn=payload["fn"],
                         module=_module_from(payload["module"], tensors),
                         train_fn=payload.get("train_fn"),
                         input_names=tuple(payload["input_names"]),
                         output_names=tuple(payload["output_names"]))


def _is_jsonable(v) -> bool:
    if isinstance(v, (str, int, float, bool, type(None))):
        return True
    if isinstance(v, (list, tuple)):
        return all(_is_jsonable(i) for i in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _is_jsonable(val)
                   for k, val in v.items())
    return False


def save_stage(stage, path: str, overwrite: bool = False) -> str:
    """Write ``stage`` under ``path`` (a directory)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(
                f"{path} exists; pass overwrite=True to replace it")
        shutil.rmtree(path)

    params: Dict[str, Any] = {}
    unsupported = []
    for p in getattr(stage, "params", []):
        if not stage.isSet(p):
            continue
        value = stage.getOrDefault(p)
        if _is_jsonable(value):
            params[p.name] = value
        else:
            unsupported.append(p.name)

    os.makedirs(path)
    extra, tensors, pickles = stage._persist(path)
    leftover = [n for n in unsupported
                if n not in extra and n not in pickles]
    if leftover:
        raise ValueError(
            f"{type(stage).__name__} cannot persist params {leftover} "
            f"(not JSON-serializable and not handled by the stage's "
            f"_persist hook)")
    blob = None
    if pickles:
        try:
            blob = pickle.dumps(pickles)
        except Exception as e:
            raise ValueError(
                f"{type(stage).__name__} has non-picklable state "
                f"({sorted(pickles)}): {e}. Use module-level functions "
                f"instead of lambdas/closures for loaders and model fns, "
                f"or reconstruct them after load") from e

    meta = {
        "package": _PACKAGE,
        "class": f"{type(stage).__module__}.{type(stage).__qualname__}",
        "uid": getattr(stage, "uid", None),
        "version": _FORMAT_VERSION,
        "params": params,
        "extra": extra,
        "has_tensors": tensors is not None,
        "pickles": sorted(pickles),
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    if tensors is not None:
        torch.save(tensors, os.path.join(path, "tensors.pt"))
    if blob is not None:
        with open(os.path.join(path, "payload.pkl"), "wb") as f:
            f.write(blob)
    return path


def load_stage(path: str):
    """Read a stage previously written by :func:`save_stage`.

    .. warning:: **Trust model — load only directories you wrote.**
       The metadata names a class to import and ``payload.pkl`` is
       unpickled: loading a stage directory from an untrusted source is
       arbitrary code execution, exactly like ``pickle.load`` (and like
       loading untrusted Keras ``.h5``/TF SavedModels).  There is no
       sandbox; treat stage directories as code, not data.
    """
    path = os.path.abspath(path)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if meta.get("package") != _PACKAGE:
        raise ValueError(
            f"{path} was not written by {_PACKAGE} (metadata package "
            f"{meta.get('package')!r}; a directory of the JAX package "
            f"sparkdl_tpu is read by that package only)")
    module_name, _, qualname = meta["class"].rpartition(".")
    cls = importlib.import_module(module_name)
    for part in qualname.split("."):
        cls = getattr(cls, part)

    tensors = None
    if meta.get("has_tensors"):
        tensors = torch.load(os.path.join(path, "tensors.pt"),
                             weights_only=True)
    pickles: Dict[str, Any] = {}
    pkl_path = os.path.join(path, "payload.pkl")
    if os.path.isfile(pkl_path):
        with open(pkl_path, "rb") as f:
            pickles = pickle.load(f)

    stage = cls._restore(meta.get("extra", {}), tensors, pickles, path)
    if meta.get("params"):
        stage._set(**meta["params"])
    return stage


class PersistableModelFunctionMixin:
    """Persistence for stages holding a ``modelFunction`` param (and an
    optional ``imageLoader``): see :func:`modelfunction_state`.  A stage
    whose ``modelFile`` is a path stores no model: it converts the file
    again at first use after load; one whose ``modelFile`` is an in-memory
    ``KerasFile`` stores the converted model, which the loaded stage
    holds."""

    def _persist(self, path: str):
        extra: Dict[str, Any] = {}
        pickles: Dict[str, Any] = {}
        tensors = None
        model_file = (self.getOrDefault(self.getParam("modelFile"))
                      if self.hasParam("modelFile")
                      and self.isSet(self.getParam("modelFile")) else None)
        if model_file is not None and not isinstance(model_file, str):
            # an in-memory KerasFile: the converted model is what is kept
            extra["modelFile"] = "in-memory"
            self.getModelFunction()
        if self.isSet(self.getParam("modelFunction")):
            if isinstance(model_file, str):
                extra["modelFunction"] = "from-modelFile"
            else:
                mf_extra, tensors, payload = modelfunction_state(
                    self.getModelFunction())
                extra["modelFunction"] = mf_extra
                if payload:
                    pickles["modelFunction"] = payload
        if (self.hasParam("imageLoader")
                and self.isSet(self.getParam("imageLoader"))):
            pickles["imageLoader"] = self.getImageLoader()
        return extra, tensors, pickles

    @classmethod
    def _restore(cls, extra: Dict, tensors, pickles: Dict, path: str):
        stage = cls()
        mf_extra = extra.get("modelFunction")
        if isinstance(mf_extra, dict):
            stage._set(modelFunction=modelfunction_from_state(
                mf_extra, tensors, pickles.get("modelFunction")))
        if "imageLoader" in pickles:
            stage._set(imageLoader=pickles["imageLoader"])
        return stage


# -- nested-stage helpers (PipelineModel) ---------------------------------------
def save_nested(stages, path: str) -> list:
    """Write ``stages`` under ``<path>/stages/<idx>_<Class>/``; returns the
    relative dir names in order."""
    names = []
    base = os.path.join(path, "stages")
    os.makedirs(base, exist_ok=True)
    for i, stage in enumerate(stages):
        name = f"{i:03d}_{type(stage).__name__}"
        save_stage(stage, os.path.join(base, name))
        names.append(name)
    return names


def load_nested(path: str, names) -> list:
    return [load_stage(os.path.join(path, "stages", n)) for n in names]
