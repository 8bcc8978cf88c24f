"""pack_ms.batch (stage): the mean ms of one ``stage.pack`` span (the
stage's ``arrowStructsToBatch`` over one chunk of the cell's batch of
rows) that lies wholly inside the traced window, read from the program's
span ring lined up with the trace (``lib/spans.py``)."""

from bench_port.lib.spans import pack_ms


def read(w):
    return pack_ms(w)
