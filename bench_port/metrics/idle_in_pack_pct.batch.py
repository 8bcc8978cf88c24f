"""idle_in_pack_pct.batch (stage): the share of the traced window's idle
device seconds (no kernel, copy or memset) in which a ``stage.pack`` span
was open on some thread, in %: the card's waits charged to the stage's
pack before any other span (``lib/spans.py``)."""

from bench_port.lib.spans import idle_in_pack_pct


def read(w):
    return idle_in_pack_pct(w)
