"""The program's own spans over the traced window.

While the profiler collects, the program records its spans into its
tracer's ring (``sparkdl_tpu_torch.obs.trace``); those it opens on the
thread that started the profiler also appear in the profiler's trace as
ranges of the same name.  This module reads the ring after the window and
lines it up with the window's :class:`~bench_port.lib.trace.Trace` by the
spans both hold, never by the reader's own clock:

* the anchors, in each source: each ``stage.transform``, then the first
  ``stage.pack`` or ``stage.column`` that starts inside it on its thread
  (the first chunk's pack, which the caller's thread runs);
* two anchors pair when they have the same name, at the same place in the
  two sequences, with durations within ``PAIR_TOLERANCE_S``; of the
  shifts between the sequences, the one that pairs the most, and of
  those the one whose offsets spread the least, lines them up;
* the offset is the median of the pairs' start offsets, and none is given
  where fewer than two pair or where their offsets spread over
  ``OFFSET_SPREAD_S``.

Each idle instant of the window (no kernel, copy or memset, the complement
of ``lib/trace.py``'s ``union`` of the device records) is charged to the
first group in ``CHARGE`` that has a span open on any thread at that
instant, or else to ``unnamed``.

A program that keeps no such spans (an empty ring, or none named so)
gives no alignment, and every reader here returns None.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from bench_port.lib.trace import Interval, union

TRANSFORM = "stage.transform"
PACK = "stage.pack"
FIRST_INSIDE = (PACK, "stage.column")
ENGINE_LEAVES = ("engine.pad", "engine.upload", "engine.replay",
                 "engine.capture", "engine.fetch", "engine.trim")
# the idle window's charge, first match wins
CHARGE: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("pack", (PACK,)),
    ("column", ("stage.column",)),
    ("engine", ENGINE_LEAVES),
)
PAIR_TOLERANCE_S = 50e-6
OFFSET_SPREAD_S = 100e-6

# (start, end, name, thread, rows): seconds on its source's clock
Record = Tuple[float, float, str, int, Optional[int]]


@dataclass
class Aligned:
    """The ring on the window's clock: each span's start and end in
    seconds from the window's start, with the pairs it was aligned by."""

    spans: List[Record]
    pairs: int
    spread_s: float
    window_s: float


def ring() -> List[dict]:
    """The program's finished spans, oldest first ([] where the program
    has no tracer)."""
    try:
        from sparkdl_tpu_torch.obs.trace import get_tracer
    except ImportError:
        return []
    return get_tracer().snapshot()


def ring_records(spans: Sequence[dict]) -> List[Record]:
    out = []
    for s in spans:
        a = float(s["ts_us"]) / 1e6
        rows = (s.get("attrs") or {}).get("rows")
        out.append((a, a + float(s["dur_us"]) / 1e6, s["name"],
                    int(s.get("tid") or 0), rows))
    return out


def anchors(records: Sequence[Record]) -> List[Record]:
    """The anchors of one source, in start order: each
    ``stage.transform``, then the first ``FIRST_INSIDE`` span that starts
    inside it on its thread."""
    transforms = sorted((r for r in records if r[2] == TRANSFORM),
                        key=lambda r: r[0])
    inner = sorted((r for r in records if r[2] in FIRST_INSIDE),
                   key=lambda r: r[0])
    out = []
    for t in transforms:
        out.append(t)
        first = next((r for r in inner if r[3] == t[3]
                      and t[0] <= r[0] <= t[1]), None)
        if first is not None:
            out.append(first)
    return out


def offset(trace_anchors: Sequence[Record], ring_anchors: Sequence[Record]
           ) -> Optional[Tuple[float, int, float]]:
    """``(offset, pairs, spread)``: the ring's clock minus the trace's, in
    seconds, from the shift of the two anchor sequences that pairs the
    most (of those, the one whose offsets spread the least); None where
    fewer than two pair or their offsets spread over
    ``OFFSET_SPREAD_S``."""
    best: Optional[Tuple[int, float, List[float]]] = None
    for shift in range(-len(trace_anchors) + 1, len(ring_anchors)):
        offs = []
        for i, t in enumerate(trace_anchors):
            j = i + shift
            if not 0 <= j < len(ring_anchors):
                continue
            r = ring_anchors[j]
            if (r[2] == t[2] and abs((r[1] - r[0]) - (t[1] - t[0]))
                    <= PAIR_TOLERANCE_S):
                offs.append(r[0] - t[0])
        if len(offs) < 2:
            continue
        spread = max(offs) - min(offs)
        if best is None or (len(offs), -spread) > (best[0], -best[1]):
            best = (len(offs), spread, offs)
    if best is None or best[1] > OFFSET_SPREAD_S:
        return None
    pairs, spread, offs = best
    return statistics.median(offs), pairs, spread


def align(trace, spans: Sequence[dict]) -> Optional[Aligned]:
    """The ring ``spans`` (``Tracer.snapshot`` dicts) on the clock of
    ``trace`` (a :class:`~bench_port.lib.trace.Trace`), or None where they
    cannot be lined up."""
    if trace is None or not spans:
        return None
    host = [(a, b, name, tid, None) for a, b, name, tid in trace.host]
    records = ring_records(spans)
    found = offset(anchors(host), anchors(records))
    if found is None:
        return None
    off, pairs, spread = found
    return Aligned(spans=[(a - off, b - off, name, tid, rows)
                          for a, b, name, tid, rows in records],
                   pairs=pairs, spread_s=spread, window_s=trace.window_s)


def window_aligned(w) -> Optional[Aligned]:
    """:func:`align` of the program's ring with the window's trace."""
    return align(w.trace, ring())


def idle(trace) -> List[Interval]:
    """The stretches of the window with nothing on the device."""
    out, t = [], 0.0
    for a, b in union([(a, b) for a, b, _ in trace.device]):
        if a > t:
            out.append((t, min(a, trace.window_s)))
        t = max(t, b)
    if t < trace.window_s:
        out.append((t, trace.window_s))
    return out


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The intersection of two sorted, merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """``xs`` less ``ys`` (sorted, merged interval lists)."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def seconds(xs: List[Interval]) -> float:
    return sum(b - a for a, b in xs)


def charge(trace, aligned: Aligned,
           groups: Sequence[Tuple[str, Sequence[str]]] = CHARGE
           ) -> Dict[str, float]:
    """The window's idle seconds, each charged to the first of ``groups``
    (label, span names) with a span open at that instant on any thread,
    else to ``unnamed``; ``idle`` holds their sum."""
    left = idle(trace)
    out = {"idle": seconds(left)}
    for label, names in groups:
        open_ = union([(a, b) for a, b, name, _, _ in aligned.spans
                       if name in names])
        out[label] = seconds(intersect(left, open_))
        left = subtract(left, open_)
    out["unnamed"] = seconds(left)
    return out


def pack_ms(w) -> Optional[float]:
    """The mean ms of a ``stage.pack`` of the cell's batch of rows that
    lies wholly inside the traced window."""
    aligned = window_aligned(w)
    if aligned is None:
        return None
    rows = w.params.get("batch_size")
    packs = [b - a for a, b, name, _, r in aligned.spans
             if name == PACK and r == rows and a >= 0.0
             and b <= aligned.window_s]
    return statistics.fmean(packs) * 1e3 if packs else None


def idle_in_pack_pct(w) -> Optional[float]:
    """The share of the window's idle seconds charged to ``stage.pack``,
    in % (0 where the device was never idle)."""
    aligned = window_aligned(w)
    if aligned is None:
        return None
    split = charge(w.trace, aligned)
    if split["idle"] <= 0:
        return 0.0
    return split["pack"] / split["idle"] * 100.0
