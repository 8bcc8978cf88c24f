"""Seeded weights for a reference model's parameter list, made on the
run's device in two large draws (one normal, one uniform) and sliced into
the named tensors, in float32: the dict the program loads and the
reference reads."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench_port.reference.common import ParamSpec

_NORMAL = {"fan_in", "he", "beta", "mean"}
_GAIN = {"fan_in": 1.0, "he": 2.0}
_UNIFORM = {"gamma", "var"}


def make_weights(specs: List[ParamSpec], generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    sizes = {name: math.prod(shape) for name, shape, _ in specs}
    n_normal = sum(sizes[n] for n, _, k in specs if k in _NORMAL)
    n_uniform = sum(sizes[n] for n, _, k in specs if k in _UNIFORM)
    normal = torch.randn(n_normal, generator=generator, device=device)
    uniform = torch.rand(n_uniform, generator=generator, device=device)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    for name, shape, kind in specs:
        n = sizes[name]
        if kind in _GAIN:
            std = math.sqrt(_GAIN[kind] / math.prod(shape[1:]))
            out[name] = normal[i:i + n].view(shape) * std
            i += n
        elif kind in _NORMAL:
            out[name] = normal[i:i + n].view(shape) * 0.05
            i += n
        elif kind in _UNIFORM:
            out[name] = 0.8 + 0.4 * uniform[j:j + n].view(shape)
            j += n
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r} of {name}")
    return out
