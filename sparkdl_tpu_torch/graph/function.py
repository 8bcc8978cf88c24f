"""ModelFunction: the composable unit of computation (port of
``sparkdl_tpu/graph/function.py``).

The JAX package's ModelFunction is a jit-traceable ``fn(variables, x)``
plus its variable pytree; here it is ``fn(module, x)`` plus an
``nn.Module`` holding the tensors, which is the contract the engine runs
(``parallel/engine.py``: ``InferenceEngine(fn, module)``).  Composition is
function composition: the composed module holds both modules as
submodules ``f`` and ``g``, as the JAX variables hold ``{"f", "g"}``, and
the engine captures the whole composition as one CUDA graph (the JAX
package's ``jit`` has no counterpart: the engine's capture takes its
place).

``train_fn(module, x) -> (pred, new_stats)`` is the train-mode apply of a
module with BatchNorm running statistics (the JAX package's ``train_fn``
of ``from_flax`` when ``batch_stats`` is present): every BatchNorm follows
flax's arithmetic and update (``models.layers.flax_batch_norm_train``),
and ``new_stats`` maps each statistic's name (:func:`batch_stat_names`)
to its updated tensor.  :func:`apply_with` runs ``fn`` or ``train_fn``
with other tensors in place of the module's (``torch.func.functional_call``),
which is how a fit trains copies of them.

The ``fn`` of every constructor here is an instance of a module-level
class, so a ModelFunction pickles when the callables it wraps do
(``persistence.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from sparkdl_tpu_torch import resolve_device
from sparkdl_tpu_torch.models.layers import BatchNorm, flax_batch_norm_train


class _Unary:
    """``fn(module, x) = f(x)``: a function without tensors."""

    def __init__(self, f: Callable[[Any], Any]):
        self.f = f

    def __call__(self, module, x):
        return self.f(x)


class _CallModule:
    """``fn(module, x) = module(x, **kwargs)``."""

    def __init__(self, kwargs: Optional[dict] = None):
        self.kwargs = dict(kwargs or {})

    def __call__(self, module, x):
        return module(x, **self.kwargs)


def _statistics_bns(module: nn.Module) -> Dict[str, nn.Module]:
    """The BatchNorm submodules of ``module`` that keep running statistics,
    by name."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats and m.running_mean is not None}


def batch_stat_names(module: nn.Module) -> List[str]:
    """The names of ``module``'s BatchNorm running statistics
    (``running_mean`` and ``running_var``): the JAX package's
    ``batch_stats`` collection.  Empty for a module without them (a
    converted Keras model keeps its moving statistics in its own layers,
    which the JAX package holds among the variables it trains)."""
    return [f"{name}.{k}" if name else k
            for name in _statistics_bns(module)
            for k in ("running_mean", "running_var")]


class _TrainApply:
    """``train_fn(module, x) = (module(x, **kwargs), new_stats)`` in train
    mode, every BatchNorm with flax's arithmetic and update (the port's
    ``BatchNorm`` has it; any other BatchNorm module is given it for the
    call), the module's mode restored after."""

    def __init__(self, kwargs: Optional[dict] = None):
        self.kwargs = {k: v for k, v in (kwargs or {}).items()
                       if k != "train"}

    def __call__(self, module, x):
        bns = _statistics_bns(module)
        was = module.training
        patched = []
        module.train()
        try:
            for bn in bns.values():
                if not isinstance(bn, BatchNorm):
                    bn.forward = lambda y, bn=bn: flax_batch_norm_train(bn, y)
                    patched.append(bn)
            pred = module(x, **self.kwargs)
        finally:
            for bn in patched:
                del bn.forward
            module.train(was)
        buffers = dict(module.named_buffers())
        return pred, {k: buffers[k] for k in batch_stat_names(module)}


class _Apply(nn.Module):
    """``forward(x) = fn(inner, x)``: a function of a module, as a module,
    for ``torch.func.functional_call``."""

    def __init__(self, fn: Callable, inner: nn.Module):
        super().__init__()
        self.fn = fn
        self.inner = inner

    def forward(self, x):
        return self.fn(self.inner, x)


def apply_with(fn: Callable, module: nn.Module,
               tensors: Dict[str, torch.Tensor], x):
    """``fn(module, x)`` with ``tensors`` (parameter and buffer names of
    ``module`` -> tensors) in place of the module's own for the call
    (``torch.func.functional_call``); the rest stay.  In-place updates of a
    buffer during the call (BatchNorm statistics) land in the tensor
    given."""
    return torch.func.functional_call(
        _Apply(fn, module), {f"inner.{k}": v for k, v in tensors.items()},
        (x,))


class _Compose:
    """``fn(module, x) = g(module.g, f(module.f, x))``."""

    def __init__(self, f: Callable, g: Callable):
        self.f, self.g = f, g

    def __call__(self, module, x):
        return self.g(module["g"], self.f(module["f"], x))


def _to_tensors(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _to_tensors(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tensors(v, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclass
class ModelFunction:
    """``fn(module, x) -> y`` with the module that holds its tensors.

    ``input_names`` / ``output_names`` keep the reference's feed/fetch
    naming contract: a multi-input function takes a dict keyed by input
    name, a multi-output one returns a dict keyed by output name."""

    fn: Callable[[nn.Module, Any], Any]
    module: nn.Module = field(default_factory=nn.Module)
    input_names: Sequence[str] = ("input",)
    output_names: Sequence[str] = ("output",)
    # Optional train-mode apply: ``train_fn(module, x) -> (pred,
    # new_stats)`` — set for modules with BatchNorm running statistics,
    # which may then update during fine-tuning (estimator trainBatchStats)
    train_fn: Optional[Callable[[nn.Module, Any], Any]] = None

    def __call__(self, x):
        """Apply to ``x`` (numpy arrays or tensors, or a dict of them)
        without autograd, on the entry points' device
        (:func:`~sparkdl_tpu_torch.resolve_device`: the card unless the CPU
        was asked for; it raises without one).  The module is moved there
        in place, as the JAX package's variables live on its default
        backend.  Stages run a ModelFunction through the engine instead
        (``get_cached_engine``), which captures the forward."""
        dev = resolve_device()
        self.module.to(dev)
        with torch.no_grad():
            return self.fn(self.module, _to_tensors(x, dev))

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_callable(cls, fn: Callable[[Any], Any], *,
                      input_names=("input",), output_names=("output",)):
        """Wrap a function without tensors (e.g. a preprocessing step)."""
        return cls(fn=_Unary(fn), module=nn.Module(),
                   input_names=input_names, output_names=output_names)

    @classmethod
    def from_module(cls, module: nn.Module, *,
                    method_kwargs: Optional[dict] = None,
                    input_names=("input",), output_names=("output",)):
        """Bind ``module(x, **method_kwargs)`` (the counterpart of
        ``from_flax``); the module is put in eval mode.  A module with
        BatchNorm running statistics also gets a train-mode apply
        (``train_fn``), as ``from_flax`` does when ``batch_stats`` is
        present."""
        train_fn = (_TrainApply(method_kwargs) if batch_stat_names(module)
                    else None)
        return cls(fn=_CallModule(method_kwargs), module=module.eval(),
                   input_names=input_names, output_names=output_names,
                   train_fn=train_fn)

    @classmethod
    def from_keras(cls, source):
        """Convert a Keras model without Keras (a ``.h5`` / ``.keras``
        path, a ``KerasFile``, or an object with ``to_json()`` and
        per-layer ``get_weights()``); see
        :mod:`sparkdl_tpu_torch.graph.keras_convert`.  Inference only, as
        the JAX converter: no ``train_fn``."""
        from sparkdl_tpu_torch.graph.keras_convert import \
            keras_to_model_function

        return keras_to_model_function(source)

    # -- composition -------------------------------------------------------
    def compose(self, other: "ModelFunction") -> "ModelFunction":
        """``self`` then ``other``: one function over a module holding
        both modules as submodules ``f`` and ``g``."""
        return ModelFunction(
            fn=_Compose(self.fn, other.fn),
            module=nn.ModuleDict({"f": self.module, "g": other.module}),
            input_names=self.input_names, output_names=other.output_names)
