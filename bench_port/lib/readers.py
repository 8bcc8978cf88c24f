"""What the per-layer metric files share: each file under ``metrics/``
names one metric and reads it from a
:class:`~bench_port.lib.harness.Window` through one of these; each returns
None when the window holds nothing to read."""

from __future__ import annotations

from typing import Optional

from bench_port.lib.yardstick import PEAK_BF16_FLOPS, bound


def series_mean_ms(w, name: str) -> Optional[float]:
    vs = w.series.get(name)
    return sum(vs) / len(vs) * 1e3 if vs else None


def counter_share_pct(w, name: str, ran: str) -> Optional[float]:
    """Counter ``name``'s seconds over the window's, in %; 0 where the
    counter never moved though the layer ran (series ``ran`` has
    samples), None where the layer did not run."""
    if not w.series.get(ran):
        return None
    return w.counters.get(name, 0.0) / w.seconds * 100.0


def idle_pct(w) -> Optional[float]:
    tr = w.trace
    if tr is None or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0


def mfu_pct(w) -> Optional[float]:
    """The configuration's FLOPs an image at the cell's cut (its
    ``output``), times the images finished in the window, over its
    seconds, over the bf16 peak, in %."""
    flops = w.config.get("flops_per_image", {}).get(w.params.get("output"))
    if not flops or not w.images or w.seconds <= 0:
        return None
    return flops * w.images / w.seconds / PEAK_BF16_FLOPS * 100.0


def window_rate(w) -> Optional[float]:
    """Images finished in the window over its seconds."""
    if not w.images or w.seconds <= 0:
        return None
    return w.images / w.seconds


def busy_mfu_pct(w) -> Optional[float]:
    """The configuration's FLOPs an image at the cell's cut, times the
    images finished in the window, over the seconds the device was busy
    in the trace, over the bf16 peak, in %."""
    flops = w.config.get("flops_per_image", {}).get(w.params.get("output"))
    tr = w.trace
    if not flops or not w.images or tr is None:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return flops * w.images / busy / PEAK_BF16_FLOPS * 100.0


def kernel_roofline_pct(w, pattern: str, classes_key: str
                        ) -> Optional[float]:
    """A kernel's least time over its device time in the traced window,
    in %.  Its launches are picked by ``pattern``; the configuration's
    ``classes_key`` lists its launch classes in one forward (``launches``,
    ``flops``, ``bytes`` of each), and the least time of the window's
    launches is that of the forwards they make up."""
    tr = w.trace
    classes = w.config.get(classes_key)
    if tr is None or not classes:
        return None
    ks = tr.kernels(pattern)
    busy = sum(b - a for a, b, _ in ks)
    if not ks or busy <= 0:
        return None
    per_forward = sum(c["launches"] for c in classes)
    least = sum(c["launches"] * bound(c["flops"], c["bytes"])[0]
                for c in classes)
    return len(ks) / per_forward * least / busy * 100.0
