"""device_idle_pct (device): the share of the traced window in which no
kernel, copy or memset ran on the card (the union of the profiler's
device records)."""

from bench_port.lib.readers import idle_pct


def read(w):
    return idle_pct(w)
