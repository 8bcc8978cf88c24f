"""pack_ms.host_paced (stage): the mean ms of one ``stage.pack`` span (the
stage's ``arrowStructsToBatch`` over one chunk of the cell's batch of
rows) that lies wholly inside the traced window, read from the program's
span ring lined up with the trace (``lib/spans.py``).  Its cell's
end-to-end rate is the card's, which the pack does not move: ``moves``
names that cell's only end-to-end metric besides ``setup_s``."""

from bench_port.lib.spans import pack_ms


def read(w):
    return pack_ms(w)
