"""Domain-specific type converters.

Port of ``sparkdl_tpu/param/converters.py``: validated conversion of
user-supplied values — zoo-model names, optimizer and loss identifiers,
callables, column-name maps, ModelFunctions — into canonical internal
form, raising ``TypeError`` on anything malformed.

An optimizer is a factory ``params -> torch.optim.Optimizer`` (what
``parallel.train.fit_data_parallel`` calls on the tensors it trains), a
zero-argument factory returning one, or a name.  A name gives optax's
update with optax's defaults, which the JAX package's names construct, not
``torch.optim``'s: ``sgd`` is ``torch.optim.SGD`` so set; ``adam`` and
``adamw`` (optax's weight decay 1e-4), ``rmsprop`` (optax's ε inside the
square root, decay 0.9), ``adagrad`` (ε inside the square root), ``lamb``
and ``lion`` are the small optimizers below, which follow optax's update
step by step.  Every named optimizer's step can be captured in a CUDA
graph (the fits capture their steps): none keeps host-side state (Adam's
and Lamb's step counts are device tensors), and each runs the same code
on the CPU and on the card.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List

import torch

from sparkdl_tpu_torch.param.params import TypeConverters


def _adam_state(state, params):
    """Each param's (step, mu, nu) lists, made at its first step: the step
    count a float32 tensor on the param's device (a loaded state dict's
    count is moved there)."""
    steps, mus, nus = [], [], []
    for p in params:
        st = state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device)
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
        elif st["step"].device != p.device:
            st["step"] = st["step"].to(p.device, torch.float32)
        steps.append(st["step"])
        mus.append(st["mu"])
        nus.append(st["nu"])
    return steps, mus, nus


def _adam_direction(mus, nus, steps, b1: float, b2: float, eps: float):
    """optax's bias-corrected direction per tensor, (μ/(1−b1ᵗ)) /
    (√(ν/(1−b2ᵗ)) + ε), from the device step counts t."""
    bc1 = torch._foreach_pow(b1, steps)
    torch._foreach_neg_(bc1)
    torch._foreach_add_(bc1, 1)
    bc2 = torch._foreach_pow(b2, steps)
    torch._foreach_neg_(bc2)
    torch._foreach_add_(bc2, 1)
    den = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(mus, bc1)
    torch._foreach_div_(u, den)
    return u


def _with_grads(group):
    params = [p for p in group["params"] if p.grad is not None]
    return params, [p.grad for p in params]


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam / optax.adamw: μ ← b1·μ + (1−b1)·g, ν ← b2·ν + (1−b2)·g²,
    u = (μ/(1−b1ᵗ)) / (√(ν/(1−b2ᵗ)) + ε) + ``weight_decay``·p, p ← p −
    lr·u, with the step count t a float32 tensor on the param's device;
    ``torch._foreach_*`` ops over each param group.  One code path on the
    CPU and the card (``torch.optim.Adam``'s ``capturable=True`` path, the
    one a CUDA graph can hold, computes its bias correction otherwise than
    its CPU path)."""

    capturable = True  # no host-side state: a CUDA graph can hold step()

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            steps, mus, nus = _adam_state(self.state, params)
            torch._foreach_add_(steps, 1)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(grads, grads),
                                alpha=1 - b2)
            u = _adam_direction(mus, nus, steps, b1, b2, group["eps"])
            if group["weight_decay"]:
                torch._foreach_add_(u, torch._foreach_mul(
                    params, group["weight_decay"]))
            torch._foreach_add_(params, u, alpha=-group["lr"])


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop: ν ← d·ν + (1−d)·g², p ← p − lr·g/√(ν+ε), ν from 0
    (``torch.optim.RMSprop`` adds ε outside the root)."""

    capturable = True  # no host-side state: a CUDA graph can hold step()

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d, eps = group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                nu = st["nu"]
                nu.mul_(d).add_((1 - d) * g * g)
                p.sub_(group["lr"] * (g * torch.rsqrt(nu + eps)))


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad: s ← s + g² (s from ``initial_accumulator_value``),
    p ← p − lr·g/√(s+ε) where s > 0 (``torch.optim.Adagrad`` adds ε
    outside the root)."""

    capturable = True  # no host-side state: a CUDA graph can hold step()

    def __init__(self, params, lr: float = 1e-2,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["sum_sq"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                s = st["sum_sq"]
                s.add_(g * g)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                                    torch.zeros_like(s))
                p.sub_(group["lr"] * (scale * g))


class Lamb(torch.optim.Optimizer):
    """optax.lamb: Adam's bias-corrected direction u = m̂/(√v̂ + ε), plus
    ``weight_decay``·p, scaled per tensor by the trust ratio ‖p‖/‖u‖ (1
    where either norm is 0), then by −lr; ``torch._foreach_*`` ops over
    each param group, as :class:`OptaxAdam`."""

    capturable = True  # no host-side state: a CUDA graph can hold step()

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            steps, mus, nus = _adam_state(self.state, params)
            torch._foreach_add_(steps, 1)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            g2 = torch._foreach_mul(grads, 1 - b2)
            torch._foreach_mul_(g2, grads)
            torch._foreach_add_(nus, g2)
            u = _adam_direction(mus, nus, steps, b1, b2, group["eps"])
            if group["weight_decay"]:
                torch._foreach_add_(u, torch._foreach_mul(
                    params, group["weight_decay"]))
            pn = torch.stack(torch._foreach_norm(params))
            un = torch.stack(torch._foreach_norm(u))
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            torch._foreach_mul_(u, list(ratio.unbind()))
            torch._foreach_mul_(u, group["lr"])
            torch._foreach_sub_(params, u)


class Lion(torch.optim.Optimizer):
    """optax.lion: u = sign((1−b1)·g + b1·m), then m ← (1−b2)·g + b2·m,
    p ← p − lr·(u + ``weight_decay``·p)."""

    capturable = True  # no host-side state: a CUDA graph can hold step()

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                mu = st["mu"]
                u = torch.sign((1 - b1) * g + b1 * mu)
                mu.mul_(b2).add_((1 - b2) * g)
                p.sub_(group["lr"] * (u + group["weight_decay"] * p))


# name -> params -> Optimizer with optax's defaults (the JAX package's
# name table: sparkdl_tpu/param/converters.py toOptimizer)
_OPTIMIZERS: Dict[str, Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = {
    "adam": lambda p: OptaxAdam(p, lr=1e-3),
    "adamw": lambda p: OptaxAdam(p, lr=1e-3, weight_decay=1e-4),
    "sgd": lambda p: torch.optim.SGD(p, lr=1e-2),
    "rmsprop": lambda p: OptaxRMSprop(p, lr=1e-3),
    "adagrad": lambda p: OptaxAdagrad(p, lr=1e-2),
    "lamb": lambda p: Lamb(p, lr=1e-3),
    "lion": lambda p: Lion(p, lr=1e-4),
}


class NamedOptimizer:
    """``params -> torch.optim.Optimizer`` for an optimizer name, with
    optax's defaults (see the module docstring); pickles by name."""

    def __init__(self, name: str):
        if name not in _OPTIMIZERS:
            raise TypeError(f"Unknown optimizer name {name!r}")
        self.name = name

    def __call__(self, params) -> torch.optim.Optimizer:
        return _OPTIMIZERS[self.name](list(params))

    def __repr__(self) -> str:
        return f"NamedOptimizer({self.name!r})"


def required_positional(fn) -> List[str]:
    """Names of ``fn``'s positional parameters without a default ([] when
    the signature cannot be read)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    return [p.name for p in sig.parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def supported_name_converter(supported):
    """Build a converter accepting only names in ``supported`` (case-insensitive
    resolution to the canonical casing)."""
    canonical = {name.lower(): name for name in supported}

    def _convert(value):
        if not isinstance(value, str):
            raise TypeError(f"Expected a model-name string, got {value!r}")
        key = value.lower()
        if key not in canonical:
            raise TypeError(
                f"{value!r} is not in the supported list {sorted(supported)}")
        return canonical[key]

    return _convert


class SparkDLTypeConverters:
    """Converters for framework-specific param types."""

    supportedNameConverter = staticmethod(supported_name_converter)

    @staticmethod
    def toOptimizer(value) -> Any:
        """Accept a factory ``params -> torch.optim.Optimizer`` (e.g.
        ``torch.optim.Adam`` or a ``functools.partial`` of one), a
        zero-argument factory returning one (called once at fit time), or
        an optimizer name (adam/adamw/sgd/rmsprop/adagrad/lamb/lion, with
        optax's defaults as the JAX package's names have them).  An
        optimizer instance is refused: it is bound to other tensors than
        the ones a fit trains."""
        if isinstance(value, torch.optim.Optimizer):
            raise TypeError(
                "Pass an optimizer factory (params -> Optimizer, e.g. "
                "functools.partial(torch.optim.Adam, lr=1e-3)) or a name, "
                "not an Optimizer bound to other tensors")
        if isinstance(value, str):
            return NamedOptimizer(value.lower())
        if callable(value):
            required = required_positional(value)
            if len(required) > 1:
                raise TypeError(
                    f"Optimizer factory {value!r} requires arguments "
                    f"{required}; pass a factory params -> Optimizer or a "
                    f"zero-arg factory returning one")
            return value
        raise TypeError(f"Could not convert {value!r} to an optimizer")

    @staticmethod
    def toLoss(value) -> Any:
        """Accept a loss callable ``(logits, labels) -> scalar`` or a canonical
        loss-name string."""
        if callable(value):
            return value
        if isinstance(value, str):
            name = value.lower()
            table = {
                "categorical_crossentropy": "categorical_crossentropy",
                "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
                "binary_crossentropy": "binary_crossentropy",
                "mse": "mse",
                "mean_squared_error": "mse",
                "mae": "mae",
                "mean_absolute_error": "mae",
            }
            if name in table:
                return table[name]
            raise TypeError(f"Unknown loss name {value!r}")
        raise TypeError(f"Could not convert {value!r} to a loss")

    @staticmethod
    def toColumnToTensorMap(value):
        """Validate a {column_name: tensor_name} dict (both strings)."""
        if not isinstance(value, dict):
            raise TypeError(f"Expected dict, got {value!r}")
        out = {}
        for k, v in value.items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError(
                    f"Column/tensor mapping must be str->str, got {k!r}: {v!r}")
            out[k] = v
        return out

    @staticmethod
    def toModelFunction(value):
        """Accept a ModelFunction (``sparkdl_tpu_torch.graph``) or raise."""
        from sparkdl_tpu_torch.graph.function import ModelFunction

        if isinstance(value, ModelFunction):
            return value
        raise TypeError(f"Expected a ModelFunction, got {type(value).__name__}")

    toCallable = staticmethod(TypeConverters.toCallable)
