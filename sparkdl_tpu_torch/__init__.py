"""sparkdl_tpu_torch — the PyTorch/CUDA port of sparkdl_tpu.

Module paths mirror ``sparkdl_tpu`` so each port module sits where its JAX
counterpart does.  The package imports ``torch`` and nothing of JAX or of
``sparkdl_tpu``.

Device rule: entry points run on ``cuda`` unless the caller asks for the
CPU, either per call (``device=`` on the engine) or process-wide through
:func:`set_default_device` / the :func:`default_device` context manager.
With no CUDA device and no CPU asked for, :func:`resolve_device` raises
``RuntimeError`` instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]

_state = threading.local()


def _default() -> Optional[torch.device]:
    return getattr(_state, "device", None)


def set_default_device(device: DeviceLike) -> None:
    """Set the device entry points use when no ``device=`` is given
    (``None`` restores the CUDA default).  Thread-local."""
    _state.device = torch.device(device) if device is not None else None


@contextlib.contextmanager
def default_device(device: DeviceLike) -> Iterator[None]:
    """Scope :func:`set_default_device` to a ``with`` block."""
    prev = _default()
    set_default_device(device)
    try:
        yield
    finally:
        _state.device = prev


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    default set by :func:`set_default_device`, else ``cuda`` (in a
    ``torch.distributed`` group, ``cuda:<rank % device_count>``).  Raises
    ``RuntimeError`` when that is a CUDA device and none is present."""
    dev = torch.device(device) if device is not None else _default()
    if dev is None:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or call "
            "sparkdl_tpu_torch.set_default_device('cpu') to run on the CPU")
    if (dev.type == "cuda" and dev.index is None
            and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        # one card per rank of a process group: cuda:<rank % device_count>
        dev = torch.device("cuda", torch.distributed.get_rank()
                           % torch.cuda.device_count())
    return dev


# The public API of the JAX package's ``sparkdl_tpu/__init__.py``, for what
# is ported; imported at first use, so that ``import sparkdl_tpu_torch``
# stays light.
_LAZY = {
    "imageIO": "sparkdl_tpu_torch.image",
    "ImageSchema": "sparkdl_tpu_torch.image",
    "readImages": "sparkdl_tpu_torch.image",
    "DataFrame": "sparkdl_tpu_torch.frame",
    "Row": "sparkdl_tpu_torch.frame",
    "DeepImageFeaturizer": "sparkdl_tpu_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_tpu_torch.transformers.named_image",
    "TFImageTransformer": "sparkdl_tpu_torch.transformers.named_image",
    "KerasImageFileTransformer": "sparkdl_tpu_torch.transformers.image_file",
    "ImageFileTransformer": "sparkdl_tpu_torch.transformers.image_file",
    "KerasTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "ModelTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "TFTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "ModelFunction": "sparkdl_tpu_torch.graph.function",
    "TFInputGraph": "sparkdl_tpu_torch.graph.input",
    "ModelInput": "sparkdl_tpu_torch.graph.input",
    "KerasImageFileEstimator":
        "sparkdl_tpu_torch.estimators.image_file_estimator",
    "ImageFileEstimator": "sparkdl_tpu_torch.estimators.image_file_estimator",
    "ParamGridBuilder": "sparkdl_tpu_torch.estimators.tuning",
    "CrossValidator": "sparkdl_tpu_torch.estimators.tuning",
    "registerKerasImageUDF": "sparkdl_tpu_torch.udf",
    "register_image_udf": "sparkdl_tpu_torch.udf",
    # "streaming" is the module itself, as "imageIO" is
    "streaming": "sparkdl_tpu_torch.streaming",
    "StreamScorer": "sparkdl_tpu_torch.streaming",
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module 'sparkdl_tpu_torch' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(target)
    obj = mod if name in ("imageIO", "streaming") else getattr(mod, name)
    globals()[name] = obj
    return obj


__all__ = sorted(_LAZY) + ["default_device", "resolve_device",
                           "set_default_device", "__version__"]
