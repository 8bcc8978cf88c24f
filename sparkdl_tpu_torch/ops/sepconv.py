"""Fused separable conv + inference BatchNorm: ``BN(pointwise(depthwise(
relu?(x))))`` (+ optional ReLU) in one pass over device memory.

Port of ``sparkdl_tpu/ops/sepconv.py``: the CUDA kernel in
``csrc/sepconv.cu`` replaces the Pallas kernel ``_fused_sepconv_tpu``
(``_sepconv_kernel``).  The contract carried over is the math and its
rounding points, not the TPU layout: the padded-flat ``[N, (H+2)*Wp, C]``
layout and its ``pltpu.roll`` taps exist only for Mosaic's sublane tiling,
so the port works on plain NHWC and masks the SAME padding in the kernel.

``fused_sepconv`` is the dispatcher: a CPU tensor takes the plain PyTorch
version :func:`sepconv_reference`, a CUDA tensor the kernel (through
:func:`_fused_sepconv_cuda`, which launches it or raises).  The wrapper
counts its launches in ``fused_sepconv.launches`` (a plain int), so a run
can show that the main path went through the kernel.

What bounds the kernel on an H100, and what its design does about that, is
written at the top of ``csrc/sepconv.cu``.

Scope, as on the TPU: 3x3, stride 1, SAME, depth multiplier 1, inference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.ops import build

_NAME = "sparkdl_sepconv"
SOURCES = ("sepconv.cu",)
_configured = set()


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load(_NAME, SOURCES)
    if _NAME not in _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sepconv_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.sepconv_launch.restype = ctypes.c_int
        lib.sepconv_error_string.argtypes = [ctypes.c_int]
        lib.sepconv_error_string.restype = ctypes.c_char_p
        _configured.add(_NAME)
    return lib


def build_log() -> str:
    return build.build_log(_NAME, SOURCES)


def sepconv_reference(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                      scale: torch.Tensor, shift: torch.Tensor,
                      pre_relu: bool, post_relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's rounding
    points: x rounded to bf16 and widened to f32 (ReLU there), depthwise
    3x3 SAME as a grouped conv in f32, its result rounded to bf16, the 1x1
    pointwise on those bf16 values with f32 accumulation, ``y*scale+shift``
    in f32, optional ReLU, bf16 out.

    ``x`` [N,H,W,C]; ``dwk`` [3,3,C]; ``pw`` [C,F]; ``scale``/``shift`` [F]
    (the inference BatchNorm affine: scale = gamma/sqrt(var+eps), shift =
    beta - mean*scale).  Returns bf16 [N,H,W,F].  A bf16 value is exact in
    TF32, so the f32 convolutions give the same sums with TF32 on or off."""
    c = x.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    xt = x.to(bf).to(f32).permute(0, 3, 1, 2)
    if pre_relu:
        xt = torch.relu(xt)
    k = dwk.to(bf).to(f32).permute(2, 0, 1).reshape(c, 1, 3, 3)
    y = F.conv2d(xt, k, padding=1, groups=c)
    y = y.to(bf).to(f32)
    w = pw.to(bf).to(f32).t().reshape(pw.shape[1], c, 1, 1)
    y = F.conv2d(y, w)
    y = y * scale.to(f32).reshape(1, -1, 1, 1) + shift.to(f32).reshape(1, -1, 1, 1)
    if post_relu:
        y = torch.relu(y)
    return y.to(bf).permute(0, 2, 3, 1)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fused_sepconv_cuda(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        pre_relu: bool, post_relu: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  ``x`` bf16 NHWC
    contiguous on a CUDA device, ``dwk`` bf16 [3,3,C], ``pw`` bf16 [C,F],
    ``scale``/``shift`` f32 [F], all contiguous on the same device; C and F
    multiples of 8.  Raises on anything else and when the launch is
    refused."""
    if x.device.type != "cuda":
        raise ValueError(f"_fused_sepconv_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N,H,W,C], got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    f = pw.shape[-1]
    _check("x", x, (n, h, w, c), torch.bfloat16, x.device)
    _check("dwk", dwk, (3, 3, c), torch.bfloat16, x.device)
    _check("pw", pw, (c, f), torch.bfloat16, x.device)
    _check("scale", scale, (f,), torch.float32, x.device)
    _check("shift", shift, (f,), torch.float32, x.device)
    if c % 8 or f % 8:
        raise ValueError(f"the kernel moves 8-channel segments: C={c} and "
                         f"F={f} must be multiples of 8")
    if any(t.data_ptr() % 16 for t in (x, dwk, pw)):
        raise ValueError("x, dwk and pw must start on a 16-byte boundary")
    if n * h * w > 65535 * 64 or n * h * w * max(c, f) >= 2 ** 31:
        raise ValueError(f"shape {(n, h, w, c, f)} exceeds the kernel's "
                         f"index range")
    out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sepconv_launch(
            x.data_ptr(), dwk.data_ptr(), pw.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), n, h, w, c, f, int(pre_relu),
            int(post_relu), stream)
    if rc != 0:
        raise RuntimeError(f"sepconv kernel launch failed: CUDA error {rc} "
                           f"({lib.sepconv_error_string(rc).decode()})")
    fused_sepconv.launches += 1
    return out


def fused_sepconv(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor,
                  pre_relu: bool = False, post_relu: bool = False
                  ) -> torch.Tensor:
    """Fused sepconv + BN on NHWC ``x`` [N,H,W,C] -> bf16 [N,H,W,F].

    ``dwk`` [3,3,C] or keras' [3,3,C,1]; ``pw`` [C,F] or [1,1,C,F].  Casts
    the operands to the kernel's types (as ``_fused_sepconv_tpu`` does),
    then runs the plain version for a CPU tensor and the CUDA kernel for a
    CUDA tensor.  An NCHW tensor in ``channels_last`` memory format,
    permuted to NHWC, is already contiguous: no copy is made for it."""
    if dwk.dim() == 4:
        dwk = dwk.reshape(3, 3, -1)
    if pw.dim() == 4:
        pw = pw.reshape(pw.shape[-2], pw.shape[-1])
    if x.device.type == "cpu":
        return sepconv_reference(x, dwk, pw, scale, shift, pre_relu,
                                 post_relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_sepconv runs on cpu or cuda, not {x.device}")
    bf, f32 = torch.bfloat16, torch.float32
    return _fused_sepconv_cuda(
        x.to(bf).contiguous(), dwk.to(bf).contiguous(), pw.to(bf).contiguous(),
        scale.to(f32).contiguous(), shift.to(f32).contiguous(),
        pre_relu, post_relu)


fused_sepconv.launches = 0
