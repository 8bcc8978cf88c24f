"""The benchmark's fixed arithmetic: published peaks, the roofline bound,
kernel operation and byte counts, CUDA-event timing and rates.  Frozen here so that a change to the program cannot move the
yardstick."""

from __future__ import annotations

from typing import Tuple

# copied from chip_smoke.py (PEAK_*): H100 SXM, NVIDIA's data sheet, dense
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, what sets it): the larger of operations over the
    bf16 peak and bytes over the peak bandwidth.  Copied from
    chip_smoke.py ``bound`` (which returns ms)."""
    ops_s = flops / PEAK_BF16_FLOPS
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def sepconv_cost(n: int, h: int, w: int, c: int, f: int
                 ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused separable-conv launch (kernel B1) on
    [n,h,w,c] -> f: a multiply and an add per depthwise tap and pointwise
    weight; bf16 input, taps, pointwise weights and output read or written
    once, f32 scale and shift.  Copied from the program's
    ``ops/sepconv.py sepconv_cost``."""
    flops = 2.0 * n * h * w * c * (9 + f)
    nbytes = 2.0 * (n * h * w * (c + f) + 9 * c + c * f) + 8.0 * f
    return flops, nbytes


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms of one ``fn()``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (median).  Copied
    from chip_smoke.py ``graph_ms``."""
    import numpy as np
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=None):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def rate(items: float, start: float, last_finish: float) -> float:
    """Work per second over a whole window: every item finished, over the
    time from the window's start to the last finish."""
    return items / (last_finish - start)

