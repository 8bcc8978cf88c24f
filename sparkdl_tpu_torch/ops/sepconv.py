"""Fused separable conv + inference BatchNorm: ``BN(pointwise(depthwise(
relu?(x))))`` (+ optional ReLU) in one pass over device memory, and the
fused MobileNetV2 inverted-residual tail beside it.

Port of ``sparkdl_tpu/ops/sepconv.py``.  Three CUDA kernels replace its
three Pallas kernels:

  * ``csrc/sepconv.cu``       <- ``_fused_sepconv_tpu`` (B1, whole image)
  * ``csrc/sepconv_tiled.cu`` <- ``_fused_sepconv_tpu_tiled`` (B3, the
    large entry-flow images; 2-D spatial tiles on Hopper)
  * ``csrc/mbconv.cu``        <- ``_fused_mbconv_tpu`` (B2)

The contract carried over is the math and its rounding points, not the TPU
layout: the padded-flat ``[N, (H+2)*Wp, C]`` layout and its ``pltpu.roll``
taps exist only for Mosaic's sublane tiling, so the port works on plain
NHWC and the kernels handle the SAME padding themselves.

``fused_sepconv`` and ``fused_mbconv`` are the dispatchers: a CPU tensor
takes the plain PyTorch version (:func:`sepconv_reference`,
:func:`mbconv_reference`), a CUDA tensor the kernel (through the
``_..._cuda`` wrappers, which launch it or raise).  Each wrapper counts its
launches in a plain int — ``fused_sepconv.launches`` (B1),
``fused_sepconv.tiled_launches`` (B3), ``fused_mbconv.launches`` (B2) — so
a run can show that the main path went through the kernels.

What bounds each kernel on an H100, and what its design does about that,
is written at the top of its source.

Scope, as on the TPU: 3x3, stride 1, SAME, depth multiplier 1, inference.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (library, sources under csrc/, C symbol prefix, launch argtypes)
KERNELS = {
    "sepconv": ("sparkdl_sepconv", ("sepconv.cu",), "sepconv",
                [_P] * 6 + [_I] * 13 + [_P]),
    "sepconv_tiled": ("sparkdl_sepconv_tiled", ("sepconv_tiled.cu",),
                      "sepconv_tiled", [_P] * 6 + [_I] * 7 + [_P]),
    "mbconv": ("sparkdl_mbconv", ("mbconv.cu",), "mbconv",
               [_P] * 6 + [_I] * 5 + [_P]),
}
_configured = set()


def load_library(kernel: str = "sepconv") -> ctypes.CDLL:
    """Build (at first use) and load ``kernel``'s library."""
    name, sources, sym, argtypes = KERNELS[kernel]
    lib = build.load(name, sources)
    if kernel not in _configured:
        launch = getattr(lib, f"{sym}_launch")
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{sym}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _configured.add(kernel)
    return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every kernel's library, one nvcc each, all started together."""
    build.load_all({name: srcs for name, srcs, _, _ in KERNELS.values()})
    return {k: load_library(k) for k in KERNELS}


def build_log(kernel: str = "sepconv") -> str:
    name, sources, _, _ = KERNELS[kernel]
    return build.build_log(name, sources)


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Call ``kernel``'s C launch function on ``device``'s current stream;
    raises when the launch is refused."""
    lib = load_library(kernel)
    sym = KERNELS[kernel][2]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{sym}_launch")(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{sym}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


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


def _check_sepconv_operands(x, dwk, pw, scale, shift, who: str):
    """The operand contract of the two sepconv kernels; returns
    (n, h, w, c, f)."""
    if x.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {x.device}")
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
    return n, h, w, c, f


# The whole-image kernel's launch plan (csrc/sepconv.cu): a block owns 64
# flattened pixels and one of S groups of F tiles; each F tile is 3*NT wide
# (NT per warpgroup, the wgmma N).  Figures of one H100 SXM (sm_90).
_SM_COUNT = 132
_SMEM_BLOCK = 232448          # shared memory one block may use
_STAGES = (4, 3)              # ring stages the kernel takes
_CHUNKS = (64, 32, 16)        # C chunk widths the kernel takes
_N_TILES = (128, 96, 64)      # wgmma N the library instantiates
_WGS = 3                      # warpgroups per block (one block per SM)
# A block's time is modelled as C * (_DW_COST + the F columns it covers):
# on the H100 the depthwise of a pixel-channel costs about as much block
# time as streaming and multiplying 256 output columns of pointwise
# weights, and the two add up (measured per shape class with a sweep of
# plans; PERF.md).
_DW_COST = 256


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _sepconv_smem(w: int, c: int, tn: int, kc: int, stages: int) -> int:
    """Bytes of shared memory of a launch: the resident depthwise tile
    [64][round_up(C, 64)] bf16, then ``stages`` ring stages of the input
    window [64+2W+2][KC], the taps [9][KC] and the pointwise chunk
    [KC][TN].  The kernel's ``smem_bytes_for``."""
    stage = (64 + 2 * w + 2 + 9) * kc + kc * tn
    return 2 * 64 * _round_up(c, 64) + 2 * stages * stage


def _sepconv_plan(n: int, h: int, w: int, c: int, f: int) -> Dict[str, int]:
    """The launch plan of the whole-image kernel for one shape: ``groups``
    (S, the blocks sharing a pixel tile, each computing its pixels'
    depthwise once), ``tiles_per_group``, ``n_tile`` (NT), ``kc`` (C
    chunk), ``stages`` (ring) and ``smem`` bytes, which the kernel takes as
    ints, plus ``blocks`` and ``waves`` (of 132 SMs) for the record.
    Picks the plan with the least modelled time: waves of blocks over 132
    SMs (one block each), a block costing ``_DW_COST`` plus the F columns
    it covers.  Raises ``ValueError`` for a shape no plan fits."""
    why = f"no sepconv plan for shape {(n, h, w, c, f)}:"
    if min(n, h, w, c, f) <= 0 or c % 8 or f % 8:
        raise ValueError(f"{why} sizes must be positive, C and F multiples "
                         f"of 8")
    least = _sepconv_smem(0, c, _WGS * min(_N_TILES), min(_CHUNKS),
                          min(_STAGES))
    if least > _SMEM_BLOCK:
        raise ValueError(f"{why} the resident 64x{c} depthwise tile "
                         f"({_sepconv_smem(0, c, 0, 0, 0)} bytes) and the "
                         f"smallest ring exceed {_SMEM_BLOCK} bytes of shared "
                         f"memory")
    px_tiles = -(-(n * h * w) // 64)
    best = None
    for nt in _N_TILES:
        tn = _WGS * nt
        f_tiles = -(-f // tn)
        for kc in _CHUNKS:
            stages = next((s for s in _STAGES
                           if _sepconv_smem(w, c, tn, kc, s) <= _SMEM_BLOCK),
                          None)
            if stages is None:
                continue
            smem = _sepconv_smem(w, c, tn, kc, stages)
            for groups in range(1, f_tiles + 1):
                tpg = -(-f_tiles // groups)
                if -(-f_tiles // tpg) != groups:
                    continue  # the same split with fewer groups is listed
                blocks = px_tiles * groups
                waves = -(-blocks // _SM_COUNT)
                key = (waves * (_DW_COST + tpg * tn), groups, -nt, -kc)
                if best is None or key < best[0]:
                    best = (key, dict(groups=groups, tiles_per_group=tpg,
                                      n_tile=nt, kc=kc, stages=stages,
                                      smem=smem, blocks=blocks,
                                      waves=waves))
    if best is None:
        raise ValueError(f"{why} the input window of a {w}-pixel row beside "
                         f"the resident depthwise tile exceeds {_SMEM_BLOCK} "
                         f"bytes of shared memory")
    return best[1]


def _fused_sepconv_cuda(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        pre_relu: bool, post_relu: bool) -> torch.Tensor:
    """Launch the whole-image kernel (B1) on the current stream.  ``x``
    bf16 NHWC contiguous on a CUDA device, ``dwk`` bf16 [3,3,C], ``pw``
    bf16 [C,F], ``scale``/``shift`` f32 [F], all contiguous on the same
    device; C and F multiples of 8.  Raises on anything else, on a shape
    no launch plan fits (:func:`_sepconv_plan`) and when the launch is
    refused."""
    n, h, w, c, f = _check_sepconv_operands(x, dwk, pw, scale, shift,
                                            "_fused_sepconv_cuda")
    if scale.data_ptr() % 8 or shift.data_ptr() % 8:
        raise ValueError("scale and shift must start on an 8-byte boundary")
    if n * h * w * max(c, f) >= 2 ** 31:
        raise ValueError(f"shape {(n, h, w, c, f)} exceeds the kernel's "
                         f"index range")
    out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    plan = _sepconv_plan(n, h, w, c, f)
    _launch("sepconv", x.device, x.data_ptr(), dwk.data_ptr(), pw.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, w, c,
            f, int(pre_relu), int(post_relu), plan["groups"],
            plan["tiles_per_group"], plan["n_tile"], plan["kc"],
            plan["stages"], plan["smem"])
    fused_sepconv.launches += 1
    return out


def _fused_sepconv_tiled_cuda(x: torch.Tensor, dwk: torch.Tensor,
                              pw: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, pre_relu: bool,
                              post_relu: bool) -> torch.Tensor:
    """Launch the spatially tiled kernel (B3) on the current stream: the
    same function and operand contract as :func:`_fused_sepconv_cuda`, for
    images of any width (its shared memory does not grow with W)."""
    n, h, w, c, f = _check_sepconv_operands(x, dwk, pw, scale, shift,
                                            "_fused_sepconv_tiled_cuda")
    if n > 65535 or -(-h // 8) * -(-w // 8) > 65535:
        raise ValueError(f"shape {(n, h, w, c, f)} exceeds the kernel's "
                         f"grid")
    out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    _launch("sepconv_tiled", x.device, x.data_ptr(), dwk.data_ptr(),
            pw.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), n, h, w, c, f, int(pre_relu), int(post_relu))
    fused_sepconv.tiled_launches += 1
    return out


def _keras_layouts(dwk: torch.Tensor, pw: torch.Tensor):
    """[3,3,C,1] -> [3,3,C] and [1,1,C,F] -> [C,F] (keras' layouts)."""
    if dwk.dim() == 4:
        dwk = dwk.reshape(3, 3, -1)
    if pw.dim() == 4:
        pw = pw.reshape(pw.shape[-2], pw.shape[-1])
    return dwk, pw


def fused_sepconv(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor,
                  pre_relu: bool = False, post_relu: bool = False,
                  row_tile: Optional[int] = None) -> torch.Tensor:
    """Fused sepconv + BN on NHWC ``x`` [N,H,W,C] -> bf16 [N,H,W,F].

    ``dwk`` [3,3,C] or keras' [3,3,C,1]; ``pw`` [C,F] or [1,1,C,F].
    ``row_tile`` picks the route as ``fused_sepconv_flat``'s does: None
    the whole-image kernel (B1), a value the tiled kernel (B3), whose CUDA
    tile shape is its own.  Casts the operands to the kernels' types (as
    the Pallas callers do), then runs the plain version for a CPU tensor
    (both routes compute the same function) and the CUDA kernel for a
    CUDA tensor.  An NCHW tensor in ``channels_last`` memory format,
    permuted to NHWC, is already contiguous: no copy is made for it."""
    dwk, pw = _keras_layouts(dwk, pw)
    if x.device.type == "cpu":
        return sepconv_reference(x, dwk, pw, scale, shift, pre_relu,
                                 post_relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_sepconv runs on cpu or cuda, not {x.device}")
    bf, f32 = torch.bfloat16, torch.float32
    kernel = _fused_sepconv_cuda if row_tile is None else \
        _fused_sepconv_tiled_cuda
    return kernel(
        x.to(bf).contiguous(), dwk.to(bf).contiguous(), pw.to(bf).contiguous(),
        scale.to(f32).contiguous(), shift.to(f32).contiguous(),
        pre_relu, post_relu)


fused_sepconv.launches = 0
fused_sepconv.tiled_launches = 0


def mbconv_reference(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                     mid_shift: torch.Tensor, shift: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of the mbconv kernel, with its rounding
    points, on FOLDED weights (both BatchNorm scales already in ``dwk`` and
    ``pw``): x and the weights rounded to bf16, depthwise 3x3 SAME as a
    grouped conv in f32, ``clip(y + mid_shift, 0, 6)`` in f32 rounded to
    bf16, the 1x1 product with f32 accumulation, ``+ shift`` in f32, bf16
    out.

    ``x`` [N,H,W,C]; ``dwk`` [3,3,C]; ``pw`` [C,F]; ``mid_shift`` [C];
    ``shift`` [F].  Returns bf16 [N,H,W,F]."""
    c = x.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    xt = x.to(bf).to(f32).permute(0, 3, 1, 2)
    k = dwk.to(bf).to(f32).permute(2, 0, 1).reshape(c, 1, 3, 3)
    y = F.conv2d(xt, k, padding=1, groups=c)
    y = torch.clamp(y + mid_shift.to(f32).reshape(1, -1, 1, 1), 0.0, 6.0)
    y = y.to(bf).to(f32)
    w = pw.to(bf).to(f32).t().reshape(pw.shape[1], c, 1, 1)
    y = F.conv2d(y, w) + shift.to(f32).reshape(1, -1, 1, 1)
    return y.to(bf).permute(0, 2, 3, 1)


def _fused_mbconv_cuda(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                       mid_shift: torch.Tensor, shift: torch.Tensor
                       ) -> torch.Tensor:
    """Launch the mbconv kernel (B2) on the current stream.  ``x`` bf16
    NHWC contiguous on a CUDA device, ``dwk`` bf16 [3,3,C], ``pw`` bf16
    [C,F], ``mid_shift`` f32 [C], ``shift`` f32 [F], all contiguous on the
    same device; C and F multiples of 8.  Raises on anything else and when
    the launch is refused."""
    if x.device.type != "cuda":
        raise ValueError(f"_fused_mbconv_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N,H,W,C], got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    f = pw.shape[-1]
    _check("x", x, (n, h, w, c), torch.bfloat16, x.device)
    _check("dwk", dwk, (3, 3, c), torch.bfloat16, x.device)
    _check("pw", pw, (c, f), torch.bfloat16, x.device)
    _check("mid_shift", mid_shift, (c,), torch.float32, x.device)
    _check("shift", shift, (f,), torch.float32, x.device)
    if c % 8 or f % 8:
        raise ValueError(f"the kernel moves 8-channel segments: C={c} and "
                         f"F={f} must be multiples of 8")
    if any(t.data_ptr() % 16 for t in (x, dwk, pw, mid_shift)):
        raise ValueError("x, dwk, pw and mid_shift must start on a 16-byte "
                         "boundary")
    if n * h * w > 65535 * 64 or n * h * w * max(c, f) >= 2 ** 31:
        raise ValueError(f"shape {(n, h, w, c, f)} exceeds the kernel's "
                         f"index range")
    out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    _launch("mbconv", x.device, x.data_ptr(), dwk.data_ptr(), pw.data_ptr(),
            mid_shift.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, w,
            c, f)
    fused_mbconv.launches += 1
    return out


def fused_mbconv(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                 mid_shift: torch.Tensor, shift: torch.Tensor
                 ) -> torch.Tensor:
    """Fused MobileNetV2 inverted-residual tail on NHWC ``x`` [N,H,W,C] ->
    bf16 [N,H,W,F]: depthwise -> +mid_shift -> relu6 -> 1x1 project ->
    +shift, with the BatchNorm scales already folded into ``dwk`` [3,3,C]
    (or [3,3,C,1]) and ``pw`` [C,F] (or [1,1,C,F]) by the caller
    (``models.layers.fold_bn_into_conv``), as ``fused_mbconv_flat`` takes
    them.  A CPU tensor runs the plain version, a CUDA tensor the kernel."""
    dwk, pw = _keras_layouts(dwk, pw)
    if x.device.type == "cpu":
        return mbconv_reference(x, dwk, pw, mid_shift, shift)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cpu or cuda, not {x.device}")
    bf, f32 = torch.bfloat16, torch.float32
    return _fused_mbconv_cuda(
        x.to(bf).contiguous(), dwk.to(bf).contiguous(), pw.to(bf).contiguous(),
        mid_shift.to(f32).contiguous(), shift.to(f32).contiguous())


fused_mbconv.launches = 0
