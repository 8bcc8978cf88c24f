"""mfu_pct.device (model step): the configuration's frozen FLOPs an image
times the images finished in the traced window, over the seconds the card
was busy in it, over the H100's bf16 dense peak: the step's share of the
peak while it runs, whatever the host's pace."""

from bench_port.lib.readers import busy_mfu_pct


def read(w):
    return busy_mfu_pct(w)
