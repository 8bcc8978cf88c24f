"""How many kernels one forward of Xception runs, read four ways, after
each phase of ``chip_smoke.py`` in its order: the captured graph's own
kernel nodes (read through libcuda), and three readings of one
torch.profiler pass over a replay and over the same engine's eager
forward: ``key_averages()`` (what the smoke's ``profiled_kernels``
reads), the raw ``events()`` list, and the "kernel" events of the
exported trace.

    python3 tools/graph_count_probe.py

Run from the root of a checkout on the machine with the card (~3 min of
command, the kernels' build included).  It runs the smoke's phases in
its order ([build], the kernel phases, [main], [mobilenet], [tiled],
[inception], [zoo2], then [keras]) and after each one from [main] on
prints, for the Xception zoo engine's graph: its kernel nodes, the
engine's captures, and each reading of a replay and of an eager forward,
four passes each (two plain, one after 50 ms of host sleep inside the
profiled window, one after a synchronised small kernel there), with the
first two kernels in the trace and the kernels whose ``key_averages()``
count differs from the first reading; then
``sparkdl_tpu_torch.utils.metrics.profiled_kernels`` (the kernels of a
second call in one profiled window).  A replay of one captured graph
runs its kernel nodes every time, so a reading that moves while the
nodes and the captures stay put is the profiler's; the reading that
stays equal to the nodes is the one to count by.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(fn, lead=None):
    """One torch.profiler pass over ``fn()``: its kernels counted by
    ``key_averages()`` (and by name), by ``events()``, and from the
    exported trace.  ``lead``: what runs in the profiled window before
    ``fn()``: nothing, 50 ms of host sleep ("host"), or one
    synchronised small kernel ("kernel", not counted)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead == "host":
            time.sleep(0.05)
        elif lead == "kernel":
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()

    def kernel(name, device_type):
        return (device_type == DeviceType.CUDA and "Memcpy" not in name
                and "Memset" not in name)

    names = {}
    for e in prof.key_averages():
        if kernel(e.key, e.device_type):
            names[e.key] = names.get(e.key, 0) + e.count
    events = sum(1 for e in prof.events() if kernel(e.name, e.device_type))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = sorted((e for e in trace.get("traceEvents", [])
                      if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    total = sum(names.values())
    if lead == "kernel":    # the lead-in's fill and add, first in time
        for e in kernels[:2]:
            hits = [k for k in names if e["name"].startswith(k[:40])]
            if hits:
                names[hits[0]] -= 1
        kernels, total, events = kernels[2:], total - 2, events - 2
        names = {k: n for k, n in names.items() if n}
    return total, events, len(kernels), names, [e["name"][:48]
                                                 for e in kernels[:2]]


FIRST = {}


def probe(tag, xception):
    import chip_smoke as cs
    from sparkdl_tpu_torch.utils.metrics import profiled_kernels

    eng, staged = xception
    g = next(iter(eng._graphs.values()))

    def eager():
        eng.capture = False
        try:
            return eng.run_padded(staged)
        finally:
            eng.capture = True

    nodes, node_names = cs.graph_kernel_nodes(g.graph)
    rows = []
    for what, fn in (("replay", g.graph.replay), ("eager", eager)):
        for lead in (None, None, "host", "kernel"):
            total, events, traced, names, head = readings(fn, lead)
            FIRST.setdefault("names", names)
            first = FIRST["names"]
            moved = {k[:40]: (first.get(k, 0), names.get(k, 0))
                     for k in set(first) | set(names)
                     if first.get(k, 0) != names.get(k, 0)}
            rows.append(f"{what} (lead {lead}) key_averages {total} events "
                        f"{events} trace {traced}, first kernels {head}"
                        + (f" (moved: {moved})" if moved else ""))
        rows.append(f"{what} profiled_kernels (second call in "
                    f"the window) {profiled_kernels(fn)[0]}")
    print(f"[{tag}] Xception graph: {nodes} kernel nodes, captures "
          f"{eng.metrics.counters.get('engine.graph_captures')}; "
          + "; ".join(rows), flush=True)


def main():
    import numpy as np
    import torch

    os.chdir(ROOT)
    import chip_smoke as cs
    from sparkdl_tpu_torch.ops import sepconv
    from sparkdl_tpu_torch.transformers import named_image as ni

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build(sepconv)
    cs.phase_sepconv_kernel(sepconv, tiled=False)
    cs.phase_sepconv_ragged(sepconv)
    cs.phase_sepconv_kernel(sepconv, tiled=True)
    cs.phase_sepconv_tiled_ragged(sepconv)
    cs.phase_mbconv_kernel(sepconv)
    cs.phase_mbconv_ragged(sepconv)
    cs.phase_xception(sepconv)
    eng = ni._zoo_engine("Xception", True, cs.BATCH)
    batch = np.random.default_rng(cs.SEED + 11).integers(
        0, 256, (cs.BATCH, 299, 299, 3), dtype=np.uint8)
    xception = (eng, eng._pad(batch))
    eng.run_padded(xception[1])
    probe("after [main]", xception)
    for tag, phase in (("[mobilenet]", cs.phase_mobilenet),
                       ("[tiled]", cs.phase_xception_tiled),
                       ("[inception]", cs.phase_inception),
                       ("[zoo2]", cs.phase_zoo2),
                       ("[keras]", cs.phase_keras)):
        phase(sepconv)
        probe(f"after {tag}", xception)


if __name__ == "__main__":
    main()
