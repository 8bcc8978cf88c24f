"""Named, versioned model registry: the fleet's catalog (port of
``sparkdl_tpu/serving/fleet/registry.py``).

An ENTRY is a named model slot (``"image-featurizer"``): the model form
is resolved exactly once when the entry is created, through the same
``serving.server._resolve_model`` path every
:class:`~sparkdl_tpu_torch.serving.server.Server` uses (a zoo model NAME
routes through ``transformers.named_image.zoo_serving_bundle``, so served
== transformed stays true by construction; a ``ModelFunction`` or a plain
``fn(module, batch)`` with its module is taken as it is).  The resolved
``fn`` object and the v1 ``nn.Module`` are pinned on the entry; every
version shares that fn.

A VERSION is that fn plus one set of weights, as a ``state_dict``,
numbered monotonically per entry (v1, v2, ...).  The port's captured CUDA
graphs read their weights from fixed addresses, so a version is served by
its own module copy (:meth:`FleetEntry.version_module`) and its own
captured engines; the shared fn, the same bucket shapes and the same
precision flags are what the rollout's no-recompile report pins
(``serving.fleet.rollout``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Mapping, Optional

import torch.nn as nn

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _state_dict(weights: Any) -> Mapping[str, Any]:
    """A version's weights, which are a ``state_dict`` (a mapping of
    parameter and buffer names to tensors)."""
    if not isinstance(weights, Mapping):
        raise TypeError(f"a version's weights are a state_dict, not "
                        f"{type(weights).__name__}")
    return weights


class ModelVersion:
    """One immutable (entry, version number, weights) triple; ``variables``
    is the version's ``state_dict``."""

    __slots__ = ("name", "version", "variables", "label")

    def __init__(self, name: str, version: int, variables: Any,
                 label: Optional[str] = None):
        self.name = name
        self.version = int(version)
        self.variables = variables
        self.label = label

    def as_dict(self) -> Dict[str, Any]:
        """JSON-serializable summary (no weights)."""
        return {"name": self.name, "version": self.version,
                "label": self.label}

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"ModelVersion({self.name!r}, v{self.version})"


class HeadVersion:
    """One per-tenant HEAD version of a head fan-out entry: the catalog
    record of a head add or swap.  The weights live on the serving
    :class:`~sparkdl_tpu_torch.parallel.engine.HeadBank`; the catalog keeps
    their content digest."""

    __slots__ = ("name", "tenant", "version", "weights_digest", "label")

    def __init__(self, name: str, tenant: str, version: int,
                 weights_digest: Optional[str],
                 label: Optional[str] = None):
        self.name = name
        self.tenant = tenant
        self.version = int(version)
        self.weights_digest = weights_digest
        self.label = label

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "tenant": self.tenant,
                "version": self.version,
                "weights_digest": self.weights_digest,
                "label": self.label}

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"HeadVersion({self.name!r}, {self.tenant!r}, "
                f"v{self.version})")


class FleetEntry:
    """A named model slot: the ONE resolved fn, the v1 module, and the
    versions (and, for head fan-out entries, per-tenant head versions; the
    backbone never versions through those)."""

    __slots__ = ("name", "featurize", "fn", "module", "default_variables",
                 "engine_overrides", "model_desc", "versions",
                 "_next_version", "heads")

    def __init__(self, name: str, fn, module: nn.Module,
                 engine_overrides: Dict[str, Any], featurize: bool,
                 model_desc: str):
        self.name = name
        self.featurize = bool(featurize)
        self.fn = fn
        self.module = module
        self.default_variables = module.state_dict()
        self.engine_overrides = dict(engine_overrides)
        self.model_desc = model_desc
        self.versions: Dict[int, ModelVersion] = {}
        self._next_version = 1
        #: tenant -> ordered head versions (head fan-out entries only)
        self.heads: Dict[str, List[HeadVersion]] = {}

    def version_module(self, mv: ModelVersion) -> nn.Module:
        """The module serving ``mv``: the entry's own module for its own
        weights (v1's), else a deep copy of it with every fold cache
        (``_folds``) cleared, then ``mv``'s weights loaded.  The copy is
        cleared because ``models.layers.cached_fold`` keeps its sources
        and results, so a deep copy would carry v1's folds and their
        memory.  The entry's module is never written: a zoo entry's is the
        zoo's shared cached module, which the transformers use too."""
        if mv.variables is self.default_variables:
            return self.module
        module = copy.deepcopy(self.module)
        for m in module.modules():
            folds = getattr(m, "_folds", None)
            if isinstance(folds, dict):
                folds.clear()
        module.load_state_dict(mv.variables)
        return module

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "model": self.model_desc,
            "featurize": self.featurize,
            "versions": sorted(self.versions),
        }
        if self.heads:
            out["heads"] = {t: hv[-1].version
                            for t, hv in sorted(self.heads.items()) if hv}
        return out


class ModelRegistry:
    """Thread-safe name -> :class:`FleetEntry` catalog with monotonically
    numbered versions.

    ::

        reg = ModelRegistry()
        v1 = reg.register("clf", fn, module_v1)           # entry + v1
        v2 = reg.register("clf", variables=state_dict_v2)  # same fn, v2

    The first ``register`` of a plain ``fn(module, batch)`` takes the
    module as ``variables`` (the port's form of the JAX package's
    variables); a zoo name or a ``ModelFunction`` carries its own, and a
    ``variables`` given with it is v1's state_dict.  Re-registering an
    existing entry with a NEW model form is refused: versions are
    weights-only by design, and a different fn would fork the program
    identity the no-recompile hot-swap report pins.
    """

    def __init__(self):
        self._entries: Dict[str, FleetEntry] = {}
        self._lock = named_lock("fleet.registry")

    def register(self, name: str, model: Any = None, variables: Any = None,
                 *, featurize: bool = False,
                 label: Optional[str] = None) -> ModelVersion:
        """Create entry ``name`` (first call: ``model`` required) and/or
        append its next :class:`ModelVersion` holding ``variables``
        (default: the entry's resolved weights, e.g. the zoo weights of a
        named zoo entry)."""
        if not name or not isinstance(name, str):
            raise ValueError(f"model name must be a non-empty string, "
                             f"got {name!r}")
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            if model is None:
                raise ValueError(
                    f"unknown model entry {name!r}: the first register() "
                    f"must pass the model (zoo name, ModelFunction, or "
                    f"fn(module, batch))")
            from sparkdl_tpu_torch.graph.function import ModelFunction
            from sparkdl_tpu_torch.serving.server import _resolve_model

            # a plain callable takes its module here; zoo names and
            # ModelFunctions carry their own, and variables given with them
            # are v1's weights
            plain = callable(model) and not isinstance(model, ModelFunction)
            fn, module, overrides = _resolve_model(
                model, variables if plain else None, featurize)
            if plain:
                variables = None
            desc = (model if isinstance(model, str)
                    else type(model).__name__)
            entry = FleetEntry(name, fn, module, overrides, featurize, desc)
            with self._lock:
                if name in self._entries:  # lost a racing register
                    existing = self._entries[name]
                    if existing.fn is not entry.fn:
                        # adopting the winner would catalog OUR weights
                        # under THEIR fn: refuse, like re-register
                        raise ValueError(
                            f"entry {name!r} was concurrently registered "
                            f"with a different model fn; versions carry "
                            f"new WEIGHTS only")
                    entry = existing
                else:
                    self._entries[name] = entry
        elif model is not None:
            raise ValueError(
                f"entry {name!r} already exists; versions carry new "
                f"WEIGHTS only (pass variables=...): a new model fn "
                f"would fork the program and break the no-recompile "
                f"hot-swap contract")
        weights = (entry.default_variables if variables is None
                   else _state_dict(variables))
        with self._lock:
            v = entry._next_version
            entry._next_version = v + 1
            mv = ModelVersion(name, v, weights, label=label)
            entry.versions[v] = mv
        logger.info("registered %s v%d%s", name, v,
                    f" ({label})" if label else "")
        return mv

    def register_head(self, name: str, tenant: str, weights: Any = None,
                      *, label: Optional[str] = None) -> HeadVersion:
        """Append tenant ``tenant``'s next HEAD version under entry
        ``name`` (head fan-out entries).  Head versions are numbered
        monotonically PER TENANT and carry only the weights' digest; the
        entry's backbone fn and version chain are untouched."""
        entry = self.entry(name)
        tenant = str(tenant)
        digest = None
        if weights is not None:
            from sparkdl_tpu_torch.utils.digest import content_digest

            digest = content_digest(weights)
        with self._lock:
            chain = entry.heads.setdefault(tenant, [])
            hv = HeadVersion(name, tenant, len(chain) + 1, digest,
                             label=label)
            chain.append(hv)
        logger.info("registered %s head %s v%d%s", name, tenant,
                    hv.version, f" ({label})" if label else "")
        return hv

    def head_versions(self, name: str, tenant: str) -> List[int]:
        """The registered head-version numbers for ``tenant`` (empty for
        a tenant with no head history)."""
        entry = self.entry(name)
        with self._lock:
            return [hv.version for hv in entry.heads.get(str(tenant), [])]

    def discard(self, name: str, version: int) -> None:
        """Back out a version that never deployed (the fleet's failed
        deploy); the entry goes with its last version, so the name is
        reusable after a failed first deploy."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                return
            entry.versions.pop(int(version), None)
            if not entry.versions:
                del self._entries[name]

    # -- lookup ------------------------------------------------------------
    def entry(self, name: str) -> FleetEntry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"unknown model entry {name!r}; registered: "
                           f"{sorted(self._entries) or 'none'}")
        return entry

    def get(self, name: str, version: Optional[int] = None) -> ModelVersion:
        """Version ``version`` of entry ``name`` (default: latest)."""
        entry = self.entry(name)
        with self._lock:
            if version is None:
                version = max(entry.versions)
            mv = entry.versions.get(int(version))
        if mv is None:
            raise KeyError(f"{name!r} has no version {version}; known: "
                           f"{sorted(entry.versions)}")
        return mv

    def versions(self, name: str) -> List[int]:
        entry = self.entry(name)
        with self._lock:
            return sorted(entry.versions)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def as_dict(self) -> Dict[str, Any]:
        """JSON-serializable catalog summary (``Fleet.varz`` embeds it)."""
        with self._lock:
            entries = list(self._entries.values())
        return {e.name: e.as_dict() for e in entries}
