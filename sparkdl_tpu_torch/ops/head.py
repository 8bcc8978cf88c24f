"""The head fan-out's head pass: every row through its own tenant's dense
head, gathered out of a stacked bank, in a sum order that does not move
with the batch (kernel H1, ``csrc/head_fanout.cu``).

::

    out[r, c] = bias[idx[r], c] + sum_d feats[r, d] * kernel[idx[r], d, c]

The weights (``kernel`` and ``bias``) are float32 or bfloat16, one type for
both; the features and the output are float32.  A bf16 weight enters its
product widened exactly, so a bf16 pass equals the f32 pass over the
widened weights bit for bit.

Not a port of a TPU kernel: the JAX package runs this head through XLA
(``sparkdl_tpu/parallel/engine.py::dense_head_row`` under
``build_head_fanout_jit``'s vmap).  The port needs a kernel for the fan-out's
contract, a tenant's row out of a mixed-tenant batch bit-identical to its
row through the head alone: a PyTorch reduction over D is split by how many
outputs there are, so its sum order moves with the batch, and the
broadcast ``(f[:, :, None] * W[idx]).sum(1)`` would also write an n x D x C
tensor (262 MB at n = 32, D = 2048, C = 1000).

The order, fixed by D alone (:func:`head_partials`): D is cut into P
partial ranges of L = D / P consecutive d; each partial sums its range in
order from +0.0, the partials are added in order, then the bias; every
product and every addition is rounded on its own.  :func:`head_pass_reference`
does exactly those operations in PyTorch, so it gives the kernel's bits on
the card and on the CPU.

:func:`head_pass` dispatches: a CPU tensor takes the plain version, a CUDA
tensor the kernel (which launches or raises; nothing on the card falls back
to the plain version), a meta tensor the meta path (:func:`_head_pass_meta`:
the operand contract checked, an empty meta output, one kernel node with
:func:`head_pass_cost`'s FLOPs and bytes for the program audit; nothing
launched or counted).  ``head_pass.launches`` counts the kernel's launches
(process-wide, under the kernels' count lock, and per thread:
``sepconv.count_launch``);
it is not part of :func:`~sparkdl_tpu_torch.ops.sepconv.launch_counts`,
whose (B1, B3, B2) triple the engine's captures credit (H1 never runs
inside a captured graph).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from sparkdl_tpu_torch.ops import sepconv as _kernels
from sparkdl_tpu_torch.parallel.shard import gathered


# the weight types H1 takes, by the code its C launch function reads
_WEIGHT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def head_partials(d: int) -> int:
    """P, the number of partial sums over D: the largest of 16, 8, 4, 2, 1
    that divides ``d``."""
    for p in (16, 8, 4, 2):
        if d % p == 0:
            return p
    return 1


# H1's grid: the blocks a plan may spread a pass over (about 2.4 an SM of
# an H100), and its cluster sizes (16 is a non-portable size)
_PLAN_BLOCKS = 320
_CLUSTER_SIZES = (1, 2, 4, 8, 16)


@functools.lru_cache(maxsize=1024)
def _head_plan(n: int, d: int, c: int) -> int:
    """S, the thread-block cluster H1 spreads each (row, 32-column tile)
    over along the partials (``csrc/head_fanout.cu``): the largest of 1,
    2, 4, 8, 16 dividing P whose grid of n x ceil(c / 32) x S blocks stays
    within ``_PLAN_BLOCKS``.  A short pass is spread for latency; a long
    one keeps a block's partials together and streams.  Fitted to
    ``tools/head_compare.py --sweep`` on an H100 (PERF.md, PR 24)."""
    p = head_partials(d)
    cells = n * -(-c // 32)
    fits = [s for s in _CLUSTER_SIZES
            if p % s == 0 and cells * s <= _PLAN_BLOCKS]
    return fits[-1] if fits else 1


def head_pass_cost(n: int, d: int, c: int, distinct: int,
                   weight_bytes: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one H1 launch: ``n`` rows of width ``d`` through
    heads of ``c`` classes, ``distinct`` of the bank's heads read, weights
    of ``weight_bytes`` bytes (4 f32, 2 bf16).  A multiply and an add per
    row and weight; the f32 feature rows, the ``distinct`` heads' kernels
    and biases, the int32 index and the f32 output each moved once.  How
    many heads a pass reads depends on its index: the card's bound counts
    this run's, the audit (which has no index values) counts
    ``min(n, capacity)``."""
    flops = 2.0 * n * d * c
    nbytes = (4.0 * (n * d + n + n * c)
              + float(weight_bytes) * distinct * (d * c + c))
    return flops, nbytes


def head_pass_reference(feats: torch.Tensor, idx: torch.Tensor,
                        kernel: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of H1, in H1's order: ``feats`` (n, D),
    ``idx`` (n,) integer tenant rows of the bank, ``kernel`` (cap, D, C),
    ``bias`` (cap, C) -> (n, C).  One step per d of a partial range for all
    P partials at once (``acc = acc + f * w``, two roundings), the partials
    added in order, then the bias.  Any float dtype; an index outside the
    bank raises ``IndexError``."""
    n, d = feats.shape
    cap, _, c = kernel.shape
    p = head_partials(d)
    length = d // p
    rows = idx.long()
    f = feats.reshape(n, p, length)
    w = kernel.reshape(cap, p, length, c)
    acc = torch.zeros((n, p, c), dtype=torch.result_type(feats, kernel),
                      device=feats.device)
    for j in range(length):
        acc = acc + f[:, :, j, None] * w[rows, :, j, :]
    out = acc[:, 0]
    for q in range(1, p):
        out = out + acc[:, q]
    return out + bias[rows]


def _check_head_operands(feats: torch.Tensor, idx: torch.Tensor,
                         kernel: torch.Tensor, bias: torch.Tensor):
    """The operand contract of H1; returns (n, cap, d, c)."""
    dev = feats.device
    if kernel.dtype not in _WEIGHT_CODES:
        raise TypeError(f"head_pass: kernel is {kernel.dtype}; the kernel "
                        f"takes torch.float32 or torch.bfloat16 weights")
    for name, t, dtype in (("feats", feats, torch.float32),
                           ("idx", idx, torch.int32),
                           ("kernel", kernel, kernel.dtype),
                           ("bias", bias, kernel.dtype)):
        if t.device != dev:
            raise ValueError(f"head_pass: {name} is on {t.device}, feats on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"head_pass: {name} is {t.dtype}; the kernel "
                            f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"head_pass: {name} is not contiguous")
    if feats.dim() != 2 or kernel.dim() != 3 or idx.dim() != 1:
        raise ValueError(f"head_pass: feats {tuple(feats.shape)}, idx "
                         f"{tuple(idx.shape)}, kernel {tuple(kernel.shape)}")
    n, d = feats.shape
    cap, kd, c = kernel.shape
    if kd != d or idx.shape[0] != n or tuple(bias.shape) != (cap, c):
        raise ValueError(f"head_pass: feats {tuple(feats.shape)}, idx "
                         f"{tuple(idx.shape)}, kernel {tuple(kernel.shape)}, "
                         f"bias {tuple(bias.shape)} do not agree")
    if max(n, cap * d * c, n * d, n * c) >= 2 ** 31:
        raise ValueError(f"head_pass: shape {(n, cap, d, c)} exceeds the "
                         f"kernel's index range")
    if cap == 0 and n and c:
        raise ValueError("head_pass: empty bank")
    return n, cap, d, c


def _head_pass_cuda(feats: torch.Tensor, idx: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor
                    ) -> torch.Tensor:
    """Launch H1 on the current stream: ``feats`` (n, D) f32, ``idx`` (n,)
    int32, ``kernel`` (cap, D, C) and ``bias`` (cap, C) both f32 or both
    bf16, contiguous, on one CUDA device; returns (n, C) f32, not
    synchronised.  A row whose index lies outside [0, cap) comes back NaN
    (the kernel reads nothing outside the bank).  Raises on anything else
    and when the launch is refused."""
    n, cap, d, c = _check_head_operands(feats, idx, kernel, bias)
    dev = feats.device
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out
    _kernels._launch("head_fanout", dev, feats.data_ptr(), idx.data_ptr(),
                     kernel.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
                     cap, d, c, head_partials(d), _head_plan(n, d, c),
                     _WEIGHT_CODES[kernel.dtype])
    _kernels.count_launch(head_pass)
    return out


def _head_pass_meta(feats: torch.Tensor, idx: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor
                    ) -> torch.Tensor:
    """The meta path of H1: the operand contract checked as the CUDA path
    checks it, an empty (n, C) f32 meta output, and one kernel node with
    :func:`head_pass_cost` (``min(n, cap)`` heads read).  Launches and
    counts nothing."""
    n, cap, d, c = _check_head_operands(feats, idx, kernel, bias)
    out = torch.empty((n, c), dtype=torch.float32, device="meta")
    _kernels.meta_node("H1", (feats, idx, kernel, bias), out,
                       head_pass_cost(n, d, c, min(n, cap),
                                      kernel.element_size()))
    return out


def head_pass(feats: torch.Tensor, idx: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The dense head pass over a stacked bank (see the module docstring):
    the plain version for a CPU tensor, kernel H1 for a CUDA tensor (f32
    features, f32 or bf16 weights of one type, an int32 index; anything
    else raises, nothing is cast),
    the meta path for a meta tensor.
    No backward: raises when grad mode is on and an operand requires
    grad.  An operand split over a mesh's model slots is gathered first
    (``parallel.shard``)."""
    feats, idx, kernel, bias = gathered(feats, idx, kernel, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (feats, kernel, bias)):
        raise RuntimeError("head_pass has no backward, and an operand "
                           "requires grad: call it under torch.no_grad()")
    if feats.device.type == "cpu":
        return head_pass_reference(feats, idx, kernel, bias)
    if feats.device.type == "meta":
        return _head_pass_meta(feats, idx, kernel, bias)
    if feats.device.type != "cuda":
        raise ValueError(f"head_pass runs on cpu, cuda or meta, not "
                         f"{feats.device}")
    return _head_pass_cuda(feats, idx, kernel, bias)


head_pass.launches = 0
