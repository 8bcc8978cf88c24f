"""ImageNet preprocessing on uint8 RGB ``[B,H,W,3]`` tensors (port of
``sparkdl_tpu/models/preprocess.py``).

The host ships uint8 batches (4x fewer bytes to the device than float32);
scaling, mean subtraction and channel reordering run on the device.
Semantics match ``keras.applications.imagenet_utils.preprocess_input``:
  * ``tf``     : x/127.5 - 1, RGB order          (Xception)
  * ``caffe``  : RGB->BGR, subtract BGR ImageNet means, no scaling
  * ``torch``  : x/255 then per-channel ImageNet mean/std normalize, RGB
  * ``none``   : float cast only
"""

from __future__ import annotations

import functools

import torch

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN_RGB = (0.485, 0.456, 0.406)
_TORCH_STD_RGB = (0.229, 0.224, 0.225)

PREPROCESS_MODES = ("tf", "caffe", "torch", "none")


@functools.lru_cache(maxsize=None)
def _const(values, device: torch.device) -> torch.Tensor:
    """``values`` as an f32 tensor on ``device``, made once per device: a
    host-to-device copy is not allowed while a CUDA graph is captured, and
    the engine's eager warm-up makes it first."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def preprocess_tf(x: torch.Tensor) -> torch.Tensor:
    """[0,255] RGB -> [-1, 1]."""
    return x.to(torch.float32) / 127.5 - 1.0


def preprocess_caffe(x: torch.Tensor) -> torch.Tensor:
    """[0,255] RGB -> zero-centered BGR (no scaling)."""
    x = x.to(torch.float32).flip(-1)  # RGB -> BGR
    return x - _const(_CAFFE_MEAN_BGR, x.device)


def preprocess_torch(x: torch.Tensor) -> torch.Tensor:
    """[0,255] RGB -> normalized by ImageNet mean/std."""
    x = x.to(torch.float32) / 255.0
    mean = _const(_TORCH_MEAN_RGB, x.device)
    return (x - mean) / _const(_TORCH_STD_RGB, x.device)


def preprocess_none(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


_MODES = {
    "tf": preprocess_tf,
    "caffe": preprocess_caffe,
    "torch": preprocess_torch,
    "none": preprocess_none,
}


def get_preprocess_fn(mode: str):
    try:
        return _MODES[mode]
    except KeyError:
        raise ValueError(
            f"Unknown preprocess mode {mode!r}; supported: {PREPROCESS_MODES}")
