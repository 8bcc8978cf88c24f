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
a run can show that the main path went through the kernels; a CUDA-graph
replay credits the launches its capture recorded (:func:`credit_launches`).

What bounds each kernel on an H100, and what its design does about that,
is written at the top of its source.

Scope, as on the TPU: 3x3, stride 1, SAME, depth multiplier 1, inference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (library, sources under csrc/, C symbol prefix, launch argtypes)
KERNELS = {
    "sepconv": ("sparkdl_sepconv", ("sepconv.cu",), "sepconv",
                [_P] * 6 + [_I] * 13 + [_P]),
    "sepconv_tiled": ("sparkdl_sepconv_tiled", ("sepconv_tiled.cu",),
                      "sepconv_tiled", [_P] * 6 + [_I] * 13 + [_P]),
    "mbconv": ("sparkdl_mbconv", ("mbconv.cu",), "mbconv",
               [_P] * 6 + [_I] * 12 + [_P]),
}
_configured = set()
_bound: Dict[str, tuple] = {}   # kernel -> (C launch function, error string)


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
    raises when the launch is refused.  The bound C functions are looked up
    once per kernel, and ``device`` is made current only when it is not
    already (a launch goes to the current device)."""
    fns = _bound.get(kernel)
    if fns is None:
        lib = load_library(kernel)
        sym = KERNELS[kernel][2]
        fns = _bound[kernel] = (getattr(lib, f"{sym}_launch"),
                                getattr(lib, f"{sym}_error_string"))
    launch, error = fns
    # the raw stream handle, without building a torch.cuda.Stream object
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch._C._cuda_getDevice():
        rc = launch(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({error(rc).decode()})")


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


@functools.lru_cache(maxsize=256)
def _sepconv_plan(n: int, h: int, w: int, c: int, f: int) -> Dict[str, int]:
    """The launch plan of the whole-image kernel for one shape: ``groups``
    (S, the blocks sharing a pixel tile, each computing its pixels'
    depthwise once), ``tiles_per_group``, ``n_tile`` (NT), ``kc`` (C
    chunk), ``stages`` (ring) and ``smem`` bytes, which the kernel takes as
    ints, plus ``blocks`` and ``waves`` (of 132 SMs) for the record.
    Picks the plan with the least modelled time: waves of blocks over 132
    SMs (one block each), a block costing ``_DW_COST`` plus the F columns
    it covers.  Raises ``ValueError`` for a shape no plan fits.  The plan
    is cached: do not modify it."""
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


# The tiled kernel's launch plan (csrc/sepconv_tiled.cu): persistent
# blocks, one per SM, each holding one F tile's pointwise slice and walking
# items of 64 pixels (a 2-D tile of one image) through a ring of TMA input
# windows of 64-channel chunks.
_T3_TILES = ((8, 8), (4, 16))   # tile TH x TW the library instantiates
_T3_F_TILES = (256, 128)        # F tiles (products in passes of 128)
_T3_STAGES = 2                  # ring stages (the C side takes 2-6)
_T3_CHUNK = 64                  # channels per window chunk
# A block's time is modelled as the items it walks times an item's cost,
# in SM cycles per 64-pixel item: the depthwise, _T3_DW a channel, the
# epilogue's stores, _T3_EPI an F column, and the products, _T3_MMA a
# channel and F column.  Fitted by least squares to a sweep of every plan
# at Xception's four classes on an H100 (tools/sepconv_tiled_compare.py
# --sweep; PERF.md; within 13% at every swept plan).  The window's halo
# (1.56x the tile at 8x8, 1.69x at 4x16) has no measurable cost there:
# the tile shape that covers the image in fewer items wins.
_T3_DW = 24.1
_T3_EPI = 13.5
_T3_MMA = 0.0057


def _sepconv_tiled_smem(th: int, tw: int, c: int, tf: int,
                        stages: int) -> int:
    """Bytes of shared memory of a launch: ``stages`` ring slots of the
    window [(TH+2)(TW+2)][64] bf16 (each rounded up to 1024 bytes), two A
    tiles [64][KP] (one a consumer warpgroup), the resident pointwise
    slice [KP][TF], the taps [9][KP], scale and shift [TF] f32, three
    mbarriers a stage and 1024 bytes of alignment slack; KP = C rounded up
    to 64.  The kernel's ``smem_bytes_for``."""
    kp = _round_up(c, _T3_CHUNK)
    slot = _round_up((th + 2) * (tw + 2) * _T3_CHUNK * 2, 1024)
    return (stages * slot + 2 * 64 * kp * 2 + kp * tf * 2 + 9 * kp * 2
            + 8 * tf + 24 * stages + 1024)


def _sepconv_tiled_candidate(n: int, h: int, w: int, c: int, f: int,
                             th: int, tw: int, tf: int,
                             stages: int = _T3_STAGES) -> Optional[Dict]:
    """One launch plan with its grid and modelled cost, or None where it
    does not fit shared memory."""
    smem = _sepconv_tiled_smem(th, tw, c, tf, stages)
    if smem > _SMEM_BLOCK:
        return None
    kp = _round_up(c, _T3_CHUNK)
    f_tiles = -(-f // tf)
    grid = f_tiles * max(1, _SM_COUNT // f_tiles)
    walkers = grid // f_tiles
    tiles = n * -(-h // th) * -(-w // tw)
    items = -(-tiles // walkers)
    item_cost = kp * _T3_DW + tf * _T3_EPI + kp * tf * _T3_MMA
    return dict(tile_h=th, tile_w=tw, f_tile=tf, stages=stages, grid=grid,
                smem=smem, f_tiles=f_tiles, tiles=tiles, items=items,
                cost=items * item_cost)


@functools.lru_cache(maxsize=256)
def _sepconv_tiled_plan(n: int, h: int, w: int, c: int, f: int) -> Dict:
    """The launch plan of the tiled kernel (B3) for one shape: ``tile_h``
    x ``tile_w`` (8x8 or 4x16 pixels), ``f_tile`` (TF), ``stages`` (ring),
    ``grid`` (blocks: F tiles x blocks per F tile, one per SM) and ``smem``
    bytes, which the kernel takes as ints, plus ``f_tiles``, ``tiles``
    (spatial), ``items`` (the most one block walks) and the model's
    ``cost`` for the record.  Weighs each tile shape's edge waste (the
    items a block walks), and TF = 256 (the depthwise once per pixel)
    against TF = 128 (twice as many items a block where F > 128).  The
    ring has two stages: in a sweep of every plan on the card (PERF.md)
    deeper rings were no faster at any of Xception's classes.  Raises
    ``ValueError`` for a shape no plan fits.  The plan is cached: do not
    modify it."""
    why = f"no sepconv_tiled plan for shape {(n, h, w, c, f)}:"
    if min(n, h, w, c, f) <= 0 or c % 8 or f % 8:
        raise ValueError(f"{why} sizes must be positive, C and F multiples "
                         f"of 8")
    best = None
    for th, tw in _T3_TILES:
        if n * -(-h // th) * -(-w // tw) >= 2 ** 31:
            continue
        for tf in _T3_F_TILES:
            plan = _sepconv_tiled_candidate(n, h, w, c, f, th, tw, tf)
            if plan is None:
                continue
            key = (plan["cost"], -tf, -th)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"{why} the resident pointwise slice and depthwise "
                         f"tiles of C={c} exceed {_SMEM_BLOCK} bytes of "
                         f"shared memory, or its tiles the kernel's index "
                         f"range")
    return best[1]


def _fused_sepconv_tiled_cuda(x: torch.Tensor, dwk: torch.Tensor,
                              pw: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, pre_relu: bool,
                              post_relu: bool) -> torch.Tensor:
    """Launch the spatially tiled kernel (B3) on the current stream with
    :func:`_sepconv_tiled_plan`'s plan: the same function and operand
    contract as :func:`_fused_sepconv_cuda`, for images of any width (its
    shared memory does not grow with W).  Raises on a shape no plan fits
    and when the launch is refused."""
    n, h, w, c, f = _check_sepconv_operands(x, dwk, pw, scale, shift,
                                            "_fused_sepconv_tiled_cuda")
    if n * h * w * f == 0:
        return torch.empty((n, h, w, f), dtype=torch.bfloat16,
                           device=x.device)
    plan = _sepconv_tiled_plan(n, h, w, c, f)
    out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    _launch("sepconv_tiled", x.device, x.data_ptr(), dwk.data_ptr(),
            pw.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), n, h, w, c, f, int(pre_relu), int(post_relu),
            plan["tile_h"], plan["tile_w"], plan["f_tile"], plan["stages"],
            plan["grid"], plan["smem"])
    fused_sepconv.tiled_launches += 1
    return out


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` and contiguous, as the kernels take it; ``t``
    itself when it already is (``.to`` and ``.contiguous`` cost host time
    even when they return their input)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _refuse_autograd(who: str, *operands: torch.Tensor) -> None:
    """Raise when autograd would record the call: the kernels have no
    backward (nor have the Pallas kernels they port), so a gradient would
    stop at their output without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(
            f"{who} has no backward, and an operand requires grad: run the "
            f"model's unfused route (fused_inference=False, or model.train()"
            f" for batch statistics), or call it under torch.no_grad()")


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
    permuted to NHWC, is already contiguous: no copy is made for it.
    Raises when grad mode is on and an operand requires grad (no
    backward)."""
    _refuse_autograd("fused_sepconv", x, dwk, pw, scale, shift)
    dwk, pw = _keras_layouts(dwk, pw)
    if x.device.type == "cpu":
        return sepconv_reference(x, dwk, pw, scale, shift, pre_relu,
                                 post_relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_sepconv runs on cpu or cuda, not {x.device}")
    bf, f32 = torch.bfloat16, torch.float32
    kernel = _fused_sepconv_cuda if row_tile is None else \
        _fused_sepconv_tiled_cuda
    return kernel(_operand(x, bf), _operand(dwk, bf), _operand(pw, bf),
                  _operand(scale, f32), _operand(shift, f32), pre_relu,
                  post_relu)


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


# The mbconv kernel's launch plan (csrc/mbconv.cu): a block owns 64-pixel
# tiles (flattened over N*H*W, or 8x8 pixels of one image) and one F tile;
# without a split it walks several tiles, the copies of the next running
# under the work of this one; with a split, S blocks of a thread-block
# cluster share one tile and each walks one slice of C.
_MB_F_TILES = (16, 24, 32, 64, 96, 160)  # F tiles (8 * NT) the library has
_MB_CLUSTERS = (1, 2, 4, 8)              # portable cluster sizes
_MB_CHUNKS = (32, 64)                    # C chunk widths it instantiates
_MB_STAGES = (2, 3, 4)                   # cp.async ring stages it takes
_SMEM_SM = 233472                        # shared memory of one SM
_MB_RESIDENT = 4     # blocks an SM holds at once: 128 registers a thread
# The model the plan minimises, in units of one 32-channel chunk of one
# tile: the chunks a block walks in series (a chunk of KC channels costs
# KC/32 + _MB_CHUNK_FIXED), times the waves of blocks, plus per tile
# _MB_EPILOGUE (stores from the fragments) or, under a split of S blocks,
# _MB_SPLIT[0] + _MB_SPLIT[1] * (S - 1) (partial tile, two cluster
# barriers, and the S - 1 other blocks' partials read through distributed
# shared memory).  Ring stages: 2 without a split, 3 with one; a block
# whose tile is one chunk takes one tile (a ring across such tiles was
# slower).  Fitted to a sweep of every plan at MobileNetV2's classes on an
# H100 (tools/mbconv_compare.py --sweep; PERF.md).
_MB_CHUNK_FIXED = 1.5
_MB_EPILOGUE = 0.5
_MB_SPLIT = (2.0, 1.5)


def _mbconv_smem(tile2d: bool, w: int, tf: int, kc: int, stages: int,
                 s: int = 1) -> int:
    """Bytes of shared memory of a launch: the A tile [64][KC+8] and
    ``stages`` ring stages of the chunk's mid_shift [KC] (f32), pointwise
    rows [KC][LDB], taps [9][KC] and input window [WIN][KC], or (S > 1) the
    f32 partial tile [64][LDP] that overwrites them after the walk,
    whichever is larger, then the F tile's shift [TF] (f32).  The kernel's
    ``smem_bytes_for``."""
    ldb = tf + 16 if (tf // 8) % 2 else tf + 8
    ldp = _round_up(tf - 8, 32) + 8
    win = 100 if tile2d else 64 + 2 * w + 2
    main = 2 * 64 * (kc + 8) + stages * 2 * (2 * kc + kc * ldb + 9 * kc
                                             + win * kc)
    return max(main, 4 * 64 * ldp if s > 1 else 0) + 4 * tf


def _mbconv_pixel_tiles(n: int, h: int, w: int, tile2d: bool) -> int:
    if tile2d:
        return n * -(-h // 8) * -(-w // 8)
    return -(-(n * h * w) // 64)


def _mbconv_candidate(n: int, h: int, w: int, c: int, f: int, tile2d: bool,
                      s: int, kc: int, stages: int, spread: bool = False
                      ) -> Optional[Dict]:
    """One launch plan with its grid and modelled cost, or None where the
    kernel does not take it (shared memory, fewer chunks than S, a split
    grid past 65535).  Without a split the blocks fill one wave and walk
    several tiles each, or with ``spread`` take one tile each."""
    tf = next((t for t in _MB_F_TILES if t >= f), _MB_F_TILES[-1])
    f_tiles = -(-f // tf)
    tiles = _mbconv_pixel_tiles(n, h, w, tile2d)
    nk = -(-c // kc)
    smem = _mbconv_smem(tile2d, w, tf, kc, stages, s)
    if s > nk or smem > _SMEM_BLOCK or (s > 1 and tiles > 65535):
        return None
    resident = min(_MB_RESIDENT, _SMEM_SM // (smem + 1024))
    slots = _SM_COUNT * resident
    chunks = -(-nk // s)
    walk = chunks * (kc / 32 + _MB_CHUNK_FIXED)
    if s == 1:
        grid_y = min(tiles, 65535, max(1, slots // f_tiles))
        if spread:
            grid_y = min(tiles, 65535)
        waves = -(-(grid_y * f_tiles) // slots)
        per_block = -(-tiles // grid_y)
        cost = -(-(tiles * f_tiles) // slots) * (walk + _MB_EPILOGUE)
    else:
        grid_y, per_block = tiles, 1
        waves = -(-(tiles * f_tiles * s) // slots)
        cost = waves * (walk + _MB_SPLIT[0] + _MB_SPLIT[1] * (s - 1))
    return dict(tile="2d" if tile2d else "flat", cluster=s, f_tile=tf, kc=kc,
                stages=stages, grid_y=grid_y, smem=smem, chunks=chunks,
                tiles_per_block=per_block, blocks=grid_y * f_tiles * s,
                waves=waves, cost=cost,
                staged=tiles * (100 if tile2d else 64 + 2 * w + 2))


@functools.lru_cache(maxsize=256)
def _mbconv_plan(n: int, h: int, w: int, c: int, f: int,
                 tile: Optional[str] = None) -> Dict:
    """The launch plan of the mbconv kernel (B2) for one shape: ``tile``
    ("flat": 64 pixels flattened over N*H*W; "2d": 8x8 pixels of one
    image), ``cluster`` (S, the blocks that split C), ``f_tile``, ``kc`` (C
    chunk), ``stages`` (ring), ``grid_y`` (blocks per F tile and rank) and
    ``smem`` bytes, which the kernel takes, plus ``chunks`` (the most a
    block walks per tile), ``tiles_per_block``, ``blocks``, ``waves`` and
    the model's ``cost`` for the record.

    The tile kind is the one that stages fewer input pixels for the batch
    (2-D at wide images, flattened at small ones); ``tile`` forces one.
    The rest minimises the model above.  Raises ``ValueError`` for a shape
    no plan fits.  The plan is cached: do not modify it."""
    why = f"no mbconv plan for shape {(n, h, w, c, f)}:"
    if min(n, h, w, c, f) <= 0 or c % 8 or f % 8:
        raise ValueError(f"{why} sizes must be positive, C and F multiples "
                         f"of 8")
    kinds = {"2d": (True,), "flat": (False,), None: (False, True)}[tile]
    best = None
    for tile2d in kinds:
        for s in _MB_CLUSTERS:
            for kc in _MB_CHUNKS:
                want = 2 if s == 1 else 3
                spread = s == 1 and c <= kc
                plan = next((p for p in (
                    _mbconv_candidate(n, h, w, c, f, tile2d, s, kc, st,
                                      spread)
                    for st in range(want, 1, -1)) if p is not None), None)
                if plan is None:
                    continue
                key = (plan["staged"], plan["cost"], s, kc)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"{why} its pixel tiles exceed the kernel's grid, "
                         f"or the input window of a {w}-pixel row exceeds "
                         f"{_SMEM_BLOCK} bytes of shared memory")
    return best[1]


def _check_mbconv_operands(x, dwk, pw, mid_shift, shift):
    """The operand contract of the mbconv kernel; returns (n, h, w, c, f)."""
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
    if any(t.data_ptr() % 16 for t in (x, dwk, pw, mid_shift, shift)):
        raise ValueError("x, dwk, pw, mid_shift and shift must start on a "
                         "16-byte boundary")
    return n, h, w, c, f


def _fused_mbconv_cuda(x: torch.Tensor, dwk: torch.Tensor, pw: torch.Tensor,
                       mid_shift: torch.Tensor, shift: torch.Tensor,
                       plan: Optional[Dict] = None) -> torch.Tensor:
    """Launch the mbconv kernel (B2) on the current stream.  ``x`` bf16
    NHWC contiguous on a CUDA device, ``dwk`` bf16 [3,3,C], ``pw`` bf16
    [C,F], ``mid_shift`` f32 [C], ``shift`` f32 [F], all contiguous on the
    same device; C and F multiples of 8.  ``plan`` defaults to
    :func:`_mbconv_plan`'s.  Raises on anything else, on a shape no plan
    fits and when the launch is refused."""
    n, h, w, c, f = _check_mbconv_operands(x, dwk, pw, mid_shift, shift)
    if n * h * w * max(c, f) >= 2 ** 31:
        raise ValueError(f"shape {(n, h, w, c, f)} exceeds the kernel's "
                         f"index range")
    if n * h * w * f == 0:
        return torch.empty((n, h, w, f), dtype=torch.bfloat16,
                           device=x.device)
    if plan is None:
        plan = _mbconv_plan(n, h, w, c, f)
    out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    _launch("mbconv", x.device, x.data_ptr(), dwk.data_ptr(), pw.data_ptr(),
            mid_shift.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, w,
            c, f, int(plan["tile"] == "2d"), plan["cluster"], plan["f_tile"],
            plan["kc"], plan["stages"], plan["grid_y"], plan["smem"])
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
    them.  A CPU tensor runs the plain version, a CUDA tensor the kernel.
    Raises when grad mode is on and an operand requires grad (no
    backward)."""
    _refuse_autograd("fused_mbconv", x, dwk, pw, mid_shift, shift)
    dwk, pw = _keras_layouts(dwk, pw)
    if x.device.type == "cpu":
        return mbconv_reference(x, dwk, pw, mid_shift, shift)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cpu or cuda, not {x.device}")
    bf, f32 = torch.bfloat16, torch.float32
    return _fused_mbconv_cuda(_operand(x, bf), _operand(dwk, bf),
                              _operand(pw, bf), _operand(mid_shift, f32),
                              _operand(shift, f32))


fused_mbconv.launches = 0


def launch_counts() -> Tuple[int, int, int]:
    """The wrappers' launch counts: (B1, B3, B2)."""
    return (fused_sepconv.launches, fused_sepconv.tiled_launches,
            fused_mbconv.launches)


def credit_launches(counts: Tuple[int, int, int]) -> None:
    """Add ``counts`` (B1, B3, B2) to the wrappers' launch counts.  A
    wrapper's Python runs once, when a CUDA graph is captured, and the
    kernels it enqueued run at every replay: the engine takes a capture's
    counts back (nothing ran) and credits them at each replay, so the counts
    stay launches on the card."""
    b1, b3, b2 = counts
    fused_sepconv.launches += b1
    fused_sepconv.tiled_launches += b3
    fused_mbconv.launches += b2
