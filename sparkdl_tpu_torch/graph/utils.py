"""Graph-name utilities (the port's own copy of ``sparkdl_tpu/graph/utils.py``).

The ``"op"`` vs ``"op:0"`` tensor-name normalization that feeds and fetches
are wired with (``op_name`` / ``tensor_name`` / ``output_index`` /
``validated_input`` / ``validated_output``).
"""

from __future__ import annotations

from typing import Iterable


def op_name(name: str) -> str:
    """Strip the output slot: ``"dense/BiasAdd:0" -> "dense/BiasAdd"``."""
    if not isinstance(name, str):
        raise TypeError(f"Expected a tensor/op name string, got {name!r}")
    return name.split(":")[0]


def tensor_name(name: str) -> str:
    """Canonical tensor name with output slot: ``"x" -> "x:0"``."""
    if not isinstance(name, str):
        raise TypeError(f"Expected a tensor/op name string, got {name!r}")
    parts = name.split(":")
    if len(parts) == 1:
        return f"{name}:0"
    if len(parts) == 2 and parts[1].isdigit():
        return name
    raise ValueError(f"Invalid tensor name {name!r}")


def output_index(name: str) -> int:
    parts = name.split(":")
    return int(parts[1]) if len(parts) == 2 else 0


def validated_input(name: str, known_ops: Iterable[str]) -> str:
    op = op_name(name)
    if op not in set(known_ops):
        raise ValueError(
            f"Input {name!r} does not reference a graph op; graph has e.g. "
            f"{sorted(set(known_ops))[:10]}")
    return tensor_name(name)


def validated_output(name: str, known_ops: Iterable[str]) -> str:
    op = op_name(name)
    if op not in set(known_ops):
        raise ValueError(
            f"Output {name!r} does not reference a graph op; graph has e.g. "
            f"{sorted(set(known_ops))[:10]}")
    return tensor_name(name)
