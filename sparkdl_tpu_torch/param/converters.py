"""Domain-specific type converters.

Port of ``sparkdl_tpu/param/converters.py``: validated conversion of
user-supplied values — zoo-model names, loss identifiers, callables,
column-name maps, ModelFunctions — into canonical internal form, raising
``TypeError`` on anything malformed.  The optimizer converter belongs to
the training stages this package does not carry yet.
"""

from __future__ import annotations

from typing import Any

from sparkdl_tpu_torch.param.params import TypeConverters


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
