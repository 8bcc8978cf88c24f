"""mfu_pct.batch (model step): the configuration's frozen FLOPs an image
times the images finished in the traced window, over its seconds, over
the H100's bf16 dense peak."""

from bench_port.lib.readers import mfu_pct


def read(w):
    return mfu_pct(w)
