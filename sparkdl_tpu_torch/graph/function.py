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
place).  ``train_fn`` (a train-mode apply for BatchNorm statistics) is not
ported: it belongs with training.

The ``fn`` of every constructor here is an instance of a module-level
class, so a ModelFunction pickles when the callables it wraps do
(``persistence.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from sparkdl_tpu_torch import resolve_device


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
        ``from_flax``); the module is put in eval mode."""
        return cls(fn=_CallModule(method_kwargs), module=module.eval(),
                   input_names=input_names, output_names=output_names)

    @classmethod
    def from_keras(cls, source):
        """Convert a Keras model without Keras (a ``.h5`` / ``.keras``
        path, a ``KerasFile``, or an object with ``to_json()`` and
        per-layer ``get_weights()``); see
        :mod:`sparkdl_tpu_torch.graph.keras_convert`."""
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
