"""images_per_s.host_paced (stage): every image of the transforms in the
traced window over its seconds, the rate that the host's pack sets where
the card waits on it.  Kept per layer in the cells whose host-clock rate
spreads too widely between runs to hold an end-to-end bound."""

from bench_port.lib.readers import window_rate


def read(w):
    return window_rate(w)
