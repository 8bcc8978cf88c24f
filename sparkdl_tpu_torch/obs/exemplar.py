"""Slow-request exemplars: whole span trees of tail-latency outliers (port
of ``sparkdl_tpu/obs/exemplar.py``).

A p99 says the tail is slow; an exemplar says why: the complete span tree
(request -> micro-batch -> engine call -> engine dispatch) of an actual
slow request, captured at settle time.  The reservoir keeps the K slowest
requests seen (a min-heap: a new request enters only by evicting the
current fastest member), so the common case is one lock-guarded float
compare and the span-tree copy happens only on entry into the top K.

``Server.varz()`` surfaces the reservoir; it is inert (every ``offer``
returns False) while tracing is disabled.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.analysis.lockcheck import named_lock

__all__ = ["ExemplarReservoir"]


class ExemplarReservoir:
    """Top-``k`` slowest traces, each with its captured span tree."""

    def __init__(self, k: int = 4):
        self.k = max(1, int(k))
        self._heap: list = []  # (duration_s, seq, exemplar_dict)
        self._seq = itertools.count()
        self._lock = named_lock("obs.exemplar")

    def offer(self, duration_s: float, trace_id: Optional[str],
              tracer=None) -> bool:
        """Consider one completed request.  Captures its span tree from
        the tracer ring and admits it iff it is among the ``k`` slowest
        seen.  Cheap rejection first: no span copying unless the
        duration beats the current floor."""
        if tracer is None or not getattr(tracer, "enabled", False):
            return False
        if not trace_id:
            return False
        with self._lock:
            if (len(self._heap) >= self.k
                    and duration_s <= self._heap[0][0]):
                return False
        # Capture OUTSIDE the lock (ring scan + dict copies); spans for
        # this trace are all finished by settle time, and the ring is
        # bounded so very old traces may already be evicted — capture
        # whatever survives.
        spans = tracer.trace_spans(trace_id)
        entry = (duration_s, next(self._seq), {
            "trace_id": trace_id,
            "duration_ms": round(duration_s * 1e3, 3),
            "spans": spans,
        })
        with self._lock:
            if len(self._heap) < self.k:
                heapq.heappush(self._heap, entry)
                return True
            if duration_s > self._heap[0][0]:
                heapq.heapreplace(self._heap, entry)
                return True
            return False

    def snapshot(self) -> List[Dict[str, Any]]:
        """Current exemplars, slowest first."""
        with self._lock:
            entries = sorted(self._heap, reverse=True)
        return [dict(e[2]) for e in entries]

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()
