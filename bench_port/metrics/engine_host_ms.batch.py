"""engine_host_ms (engine): the mean host time of one dispatch through
the engine (pad, pinned upload, graph replay, output copy enqueued), the
program's ``engine.replay_host`` series over the window."""

from bench_port.lib.readers import series_mean_ms


def read(w):
    return series_mean_ms(w, "engine.replay_host")
