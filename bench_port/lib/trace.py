"""The traced window: ``torch.profiler`` over CPU and CUDA, read back
from its Chrome trace.

The window is the benchmark's own ``record_function`` range
(``WINDOW``); device time is every kernel, copy and memset record inside
it.  The trace is read as the program's ``utils/metrics.py
profiled_kernels`` reads it (an exported Chrome trace, events by ``cat``,
the annotated range giving the window), copied here so that the program
cannot move it.  The file goes to a temporary directory under ``TMPDIR``
and is deleted once read.

A whole measured window (``busy_profiled``) holds about a million kernel
records: it is read for the card's busy time alone, from the profiler's
events in memory, with room set aside for every record.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")

# Kineto stops collecting once its device buffers pass this size (128 MB
# by default, some 600,000 kernel records): room for a whole window.
BUFFER_MB = 2048

Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@dataclass
class Trace:
    """What the window held, times in seconds from its start."""

    window_s: float
    # (start, end, name) of each device record, clipped to the window
    device: List[Tuple[float, float, str]] = field(default_factory=list)
    # (start, end, name, thread) of each host record inside the window
    host: List[Tuple[float, float, str, int]] = field(default_factory=list)

    def busy_s(self) -> float:
        return sum(b - a for a, b in union([(a, b) for a, b, _ in
                                            self.device]))

    def kernels(self, pattern: str) -> List[Tuple[float, float, str]]:
        rx = re.compile(pattern)
        return [d for d in self.device if rx.search(d[2])]

    def top_device_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for a, b, name in self.device:
            total[name] = total.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by what the host was doing: for each of the (at
        most three) threads busiest in the gap, the traced range that
        overlapped the gap most."""
        busy = union([(a, b) for a, b, _ in self.device])
        gaps, t = [], 0.0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            best: Dict[int, Tuple[float, str]] = {}
            for s, e, name, tid in self.host:
                ov = min(e, b) - max(s, a)
                if ov > 0 and (tid not in best or ov > best[tid][0]):
                    best[tid] = (ov, name)
            top = sorted(best.values(), key=lambda v: -v[0])[:3]
            what = " | ".join(name for _, name in top) or "no traced range"
            out.append([f"host: {what}"[:160], b - a])
        return out


def read_chrome_trace(events: list) -> Optional[Trace]:
    """The :class:`Trace` of the ``WINDOW`` range in a Chrome trace's
    ``traceEvents``; None when the trace holds no such range."""
    span = next((e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW), None)
    if span is None:
        return None
    t0 = float(span["ts"])
    t1 = t0 + float(span["dur"])
    tr = Trace(window_s=(t1 - t0) / 1e6)
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= t0 or a >= t1:
            continue
        if cat in DEVICE_CATS:
            tr.device.append(((max(a, t0) - t0) / 1e6,
                              (min(b, t1) - t0) / 1e6, e.get("name", "")))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            tid = e.get("tid", 0)
            tr.host.append(((a - t0) / 1e6, (b - t0) / 1e6,
                            e.get("name", ""),
                            tid if isinstance(tid, int) else hash(tid)))
    return tr


@contextlib.contextmanager
def profiled() -> Iterator[dict]:
    """Profile CPU and CUDA activity; on exit the yielded dict holds the
    window's :class:`Trace` under ``"trace"`` (None without a window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    box: dict = {"trace": None}
    with profile(activities=activities) as prof:
        yield box
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    box["trace"] = read_chrome_trace(events)


@dataclass
class Busy:
    """The card's busy time over a long window: the union of its kernel,
    copy and memset records inside the ``WINDOW`` range, and how many
    device records fell inside the range and before it."""

    window_s: float
    busy_s: float
    records: int
    records_before: int


def on_device(e) -> bool:
    """Whether a profiler event is a kernel, copy or memset on the card:
    Kineto gives the card's records the CUDA device type, and the card's
    copies of annotated ranges are marked as annotations."""
    return e.device_type().name == "CUDA" and not e.is_user_annotation()


def read_busy(events) -> Optional[Busy]:
    """The :class:`Busy` of the ``WINDOW`` range in the profiler's events
    (``kineto_results.events()``); None when there is no such range."""
    span = next((e for e in events if e.is_user_annotation()
                 and e.name() == WINDOW
                 and e.device_type().name == "CPU"), None)
    if span is None:
        return None
    t0, t1 = span.start_ns(), span.end_ns()
    inside: List[Interval] = []
    before = 0
    for e in events:
        if not on_device(e):
            continue
        a, b = e.start_ns(), e.end_ns()
        if b <= t0:
            before += 1
        elif a < t1:
            inside.append((max(a, t0), min(b, t1)))
    busy = sum(b - a for a, b in union(inside))
    return Busy(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
                records=len(inside), records_before=before)


@contextlib.contextmanager
def busy_profiled() -> Iterator[dict]:
    """Profile CPU and CUDA activity with room for every record of a long
    window; on exit the yielded dict holds the window's :class:`Busy`
    under ``"busy"`` (None without a window)."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # PyTorch hands the string to Kineto after "CUSTOM_CONFIG=": the
    # newline puts the buffer's size on a config line of its own
    cfg = _ExperimentalConfig(custom_profiler_config=(
        f"\nACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={BUFFER_MB}"))
    box: dict = {"busy": None}
    with profile(activities=activities, experimental_config=cfg) as prof:
        yield box
    box["busy"] = read_busy(prof.profiler.kineto_results.events())


def window_range():
    """The ``record_function`` range that marks the traced window."""
    from torch.profiler import record_function

    return record_function(WINDOW)
