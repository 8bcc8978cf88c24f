"""dispatch_starved_pct.batch (runner): the seconds the pipelined
runner's dispatch thread waited for the prepare thread's next piece (the
program's ``pipeline.dispatch_in_stall_s``), over the window's."""

from bench_port.lib.readers import counter_share_pct


def read(w):
    return counter_share_pct(w, "pipeline.dispatch_in_stall_s",
                             ran="engine.replay_host")
