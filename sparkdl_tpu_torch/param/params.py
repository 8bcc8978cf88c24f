"""Core Param / Params machinery (port of ``sparkdl_tpu/param/params.py``;
``save`` / ``load`` go through ``sparkdl_tpu_torch.persistence``).

Re-designs the contract of ``pyspark.ml.param`` that the reference's config
system (``python/sparkdl/param/`` — C16 in SURVEY.md) is built on, without any
Spark dependency: typed ``Param`` descriptors attached to stage classes,
per-instance value maps, defaults, copy-with-overrides, and string addressing
via ``getParam(name)`` so parameter grids can be built programmatically.
"""

from __future__ import annotations

import copy
import functools
import inspect
from typing import Any, Callable, Dict, Iterable, List, Optional


class Param:
    """A typed parameter descriptor with self-contained documentation.

    Mirrors the role of ``pyspark.ml.param.Param`` used throughout the
    reference (e.g. ``sparkdl/param/shared_params.py``): identified by
    ``(parent, name)``, with an optional ``typeConverter`` that validates and
    normalizes values at ``set`` time.
    """

    def __init__(self, parent: "Params", name: str, doc: str,
                 typeConverter: Optional[Callable[[Any], Any]] = None):
        self.parent = parent.uid if isinstance(parent, Params) else str(parent)
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or TypeConverters.identity

    def _copy_new_parent(self, parent: "Params") -> "Param":
        p = copy.copy(self)
        p.parent = parent.uid
        return p

    def __str__(self):
        return f"{self.parent}__{self.name}"

    def __repr__(self):
        return f"Param(parent={self.parent!r}, name={self.name!r}, doc={self.doc!r})"

    def __hash__(self):
        return hash(str(self))

    def __eq__(self, other):
        return isinstance(other, Param) and str(self) == str(other)


class TypeConverters:
    """Built-in value converters/validators for ``Param.typeConverter``."""

    @staticmethod
    def identity(value):
        return value

    @staticmethod
    def toInt(value):
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to int")
        try:
            iv = int(value)
        except (TypeError, ValueError):
            raise TypeError(f"Could not convert {value!r} to int")
        if float(iv) != float(value):
            raise TypeError(f"Could not losslessly convert {value!r} to int")
        return iv

    @staticmethod
    def toFloat(value):
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to float")
        try:
            return float(value)
        except (TypeError, ValueError):
            raise TypeError(f"Could not convert {value!r} to float")

    @staticmethod
    def toString(value):
        if isinstance(value, str):
            return value
        raise TypeError(f"Could not convert {value!r} to string")

    @staticmethod
    def toBoolean(value):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Could not convert {value!r} to boolean")

    @staticmethod
    def toList(value):
        if isinstance(value, (list, tuple)):
            return list(value)
        raise TypeError(f"Could not convert {value!r} to list")

    @staticmethod
    def toListString(value):
        lst = TypeConverters.toList(value)
        return [TypeConverters.toString(v) for v in lst]

    @staticmethod
    def toListFloat(value):
        lst = TypeConverters.toList(value)
        return [TypeConverters.toFloat(v) for v in lst]

    @staticmethod
    def toDict(value):
        if isinstance(value, dict):
            return dict(value)
        raise TypeError(f"Could not convert {value!r} to dict")

    @staticmethod
    def toCallable(value):
        if callable(value):
            return value
        raise TypeError(f"{value!r} is not callable")


def keyword_only(func):
    """Decorator forcing keyword-only invocation, stashing kwargs.

    Same contract as the reference's ``keyword_only`` (re-exported from
    ``sparkdl/param/__init__.py``): the wrapped ``__init__``/``setParams``
    records its keyword arguments in ``self._input_kwargs`` so the stage can
    forward them to ``_set``.
    """

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(
                f"Method {func.__name__} only takes keyword arguments.")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


_uid_counters: Dict[str, int] = {}


def _gen_uid(cls_name: str) -> str:
    n = _uid_counters.get(cls_name, 0)
    _uid_counters[cls_name] = n + 1
    return f"{cls_name}_{n:04x}"


class Params:
    """Mixin giving a stage typed params, defaults, and string addressing.

    Class attributes of type :class:`Param` are discovered automatically and
    re-parented per instance (matching pyspark.ml semantics the reference
    relies on).  Values live in ``_paramMap``; defaults in ``_defaultParamMap``.
    """

    def __init__(self):
        self.uid = _gen_uid(type(self).__name__)
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        # Re-parent class-level Param descriptors onto this instance so that
        # two instances of the same stage never alias each other's params.
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    # -- discovery ---------------------------------------------------------
    @property
    def params(self) -> List[Param]:
        return sorted(
            (getattr(self, name) for name in dir(self)
             if name != "params" and isinstance(getattr(self, name, None), Param)),
            key=lambda p: p.name)

    def getParam(self, name: str) -> Param:
        """String-addressable lookup — the grid-search contract."""
        p = getattr(self, name, None)
        if isinstance(p, Param):
            return p
        raise ValueError(f"{type(self).__name__} has no param {name!r}")

    def hasParam(self, name: str) -> bool:
        return isinstance(getattr(self, name, None), Param)

    # -- get/set -----------------------------------------------------------
    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            if param.parent != self.uid:
                # Accept a sibling instance's descriptor by name (pyspark
                # tolerates this inside paramMaps built from another copy).
                return self.getParam(param.name)
            return param
        if isinstance(param, str):
            return self.getParam(param)
        raise TypeError(f"Cannot resolve param from {param!r}")

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if value is None:
                continue
            p = self.getParam(name)
            self._paramMap[p] = p.typeConverter(value)
        return self

    def set(self, param, value) -> "Params":
        p = self._resolveParam(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            if value is not None:
                value = p.typeConverter(value)
            self._defaultParamMap[p] = value
        return self

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param):
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(
            f"Param {p.name!r} is not set and has no default on {self.uid}")

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None) -> Dict[Param, Any]:
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            m.update({self._resolveParam(k): v for k, v in extra.items()})
        return m

    # -- copy --------------------------------------------------------------
    def copy(self, extra: Optional[Dict[Param, Any]] = None) -> "Params":
        that = copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        # Params keep pointing at self.uid intentionally (pyspark keeps the
        # uid on copy too), so descriptors still resolve.
        if extra:
            for k, v in extra.items():
                p = that._resolveParam(k)
                that._paramMap[p] = p.typeConverter(v)
        return that

    # -- persistence (Spark ML writable/readable contract) ------------------
    def save(self, path: str, overwrite: bool = False) -> str:
        """Write this stage to ``path``; see sparkdl_tpu_torch.persistence."""
        from sparkdl_tpu_torch import persistence

        return persistence.save_stage(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str) -> "Params":
        from sparkdl_tpu_torch import persistence

        stage = persistence.load_stage(path)
        if not isinstance(stage, cls):
            raise TypeError(
                f"{path} holds a {type(stage).__name__}, not a {cls.__name__}")
        return stage

    def _persist(self, path: str):
        """Hook: (extra metadata dict, tensors dict or None, pickles
        dict).  The default persists nothing beyond JSON-able params."""
        return {}, None, {}

    @classmethod
    def _restore(cls, extra: Dict, tensors, pickles: Dict, path: str):
        """Hook: rebuild an instance from the persisted pieces (params are
        re-applied by the caller afterwards)."""
        return cls()

    def explainParam(self, param) -> str:
        p = self._resolveParam(param)
        value = "undefined"
        if self.hasDefault(p):
            value = f"default: {self._defaultParamMap[p]!r}"
        if self.isSet(p):
            value = f"current: {self._paramMap[p]!r}"
        return f"{p.name}: {p.doc} ({value})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)
