"""B3's tiled sepconv kernel beside an earlier version of it, a sweep of its
launch plans and a trace of where one block's time goes, on a GPU.

    python3 tools/sepconv_tiled_compare.py [--parent build/parent_sepconv_tiled.cu]
                                           [--sweep] [--trace] [--grids]
                                           [--json FILE]

Builds ``sparkdl_tpu_torch/ops/csrc/sepconv_tiled.cu`` with nvcc into
``build/sepconv_tiled_compare/`` and, at each B3 class of ``chip_smoke.py``
(Xception's entry blocks 2-3 at batch 32) and its ragged shapes, holds it
against the plain version (``sepconv_reference``, chip_smoke's tolerance)
and times it (CUDA graph replay, the launch plan of
``_sepconv_tiled_plan``).  ``--parent`` names a source of the kernel with
the interface it had before its launch plan (``sepconv_tiled_launch(x,
dwk, pw, scale, shift, out, N, H, W, C, F, pre_relu, post_relu,
stream)``): it is built beside it, checked at every shape and timed at
the batch-32 classes in the same process, in turns (parent, kernel,
kernel, parent), and the per-forward sums of both are printed.  Make that
file first, e.g. ``git show 5bb53e6:sparkdl_tpu_torch/ops/csrc/
sepconv_tiled.cu > build/parent_sepconv_tiled.cu``.

``--sweep`` also runs every plan the library instantiates (tile, F tile,
ring stages 2-6) at every shape: each is held against the plain version, and
at the batch-32 classes timed, with the plan's own choice ranked among
them; ``--json`` writes every swept plan with its time.

``--grids`` times each batch-32 class's plan on 132, 66 and 33 blocks
(one, a half and a quarter of the SMs) and prints the bytes each block
moves per SM cycle at the card's maximum SM clock, beside the card's own
rate for writing and copying a tensor of the output's size (``zero_``,
``copy_``): a rate that holds as the blocks thin out is set inside each SM,
not by the card's memory.

``--trace`` builds the kernel again with ``-DSEPCONV_TILED_PHASE_TRACE``
and, at each batch-32 class, prints the mean clock64 cycles per item of
one block, for thread 0 of each consumer warpgroup (each takes every
other item): waiting for the item's TMA windows, computing its depthwise,
issuing the products (wgmma), waiting for them, the epilogue, the
barrier.  The probes' stores
add a few cycles each.  Prints the card's name and power limit first.
Needs a CUDA card.
"""

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sparkdl_tpu_torch.ops import build, sepconv  # noqa: E402

OUT = ROOT / "build" / "sepconv_tiled_compare"
_P, _I = ctypes.c_void_p, ctypes.c_int
PLAN_KEYS = ("tile_h", "tile_w", "f_tile", "stages", "grid", "smem")


def nvcc(name, src, defines=()):
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"lib{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           *[f"-D{d}" for d in defines], "-o", str(so), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    log = (proc.stdout + proc.stderr).splitlines()
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in log
            if "Used " in ln and "registers" in ln]
    spills = [int(ln.split("bytes spill stores")[0].split(",")[-1])
              for ln in log if "bytes spill stores" in ln]
    print(f"[build] {name}: {time.perf_counter() - t0:.1f}s, {len(regs)} "
          f"instances, {min(regs)}-{max(regs)} registers, at most "
          f"{max(spills, default=0)} bytes spilled", flush=True)
    for ln in log:
        if "warning" in ln.lower():
            print(f"[build]   {ln.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def launcher(lib, planned):
    """``run(args, pre, post, plan)`` through ``lib``'s
    ``sepconv_tiled_launch``; the parent's interface takes no plan."""
    fn = lib.sepconv_tiled_launch
    fn.argtypes = [_P] * 6 + [_I] * (13 if planned else 7) + [_P]
    fn.restype = _I

    def run(args, pre, post, plan=None):
        x, dwk, pw, scale, shift = args
        n, h, w, c = x.shape
        f = pw.shape[1]
        out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device="cuda")
        extra = []
        if planned:
            plan = plan or sepconv._sepconv_tiled_plan(n, h, w, c, f)
            extra = [plan[k] for k in PLAN_KEYS]
        rc = fn(*(t.data_ptr() for t in (x, dwk, pw, scale, shift, out)),
                n, h, w, c, f, int(pre), int(post), *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sepconv_tiled launch failed: CUDA error {rc}")
        return out
    return run


def every_plan(n, h, w, c, f):
    """Every plan the library instantiates that fits the shape."""
    for (th, tw), tf, st in itertools.product(
            sepconv._T3_TILES, sepconv._T3_F_TILES, range(2, 7)):
        plan = sepconv._sepconv_tiled_candidate(n, h, w, c, f, th, tw, tf,
                                                st)
        if plan is not None:
            yield plan


def short(plan):
    return (f"{plan['tile_h']}x{plan['tile_w']} TF={plan['f_tile']} "
            f"st={plan['stages']}")


def trace(lib):
    read = lib.sepconv_tiled_trace_read
    read.argtypes = [_P, _I]
    read.restype = _I
    run = launcher(lib, planned=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    names = ("wait windows", "depthwise", "issue products",
             "wait products", "epilogue", "barrier")
    for hw, c, f, pre, post, _ in cs.TILED_SHAPES:
        args = cs._sepconv_inputs(g, cs.BATCH, hw, c, f)
        plan = sepconv._sepconv_tiled_plan(cs.BATCH, hw, hw, c, f)
        run(args, pre, post)  # warm: code and weights in the caches
        torch.cuda.synchronize()
        block = plan["grid"] // 2
        assert read(None, block) == 0
        run(args, pre, post)
        torch.cuda.synchronize()
        buf = np.zeros((2, 64, 8), dtype=np.int64)
        assert read(ctypes.c_void_p(buf.ctypes.data), 0) == 0
        print(f"[trace] {hw}x{hw} C={c} F={f}, block {block} "
              f"({cs.tiled_plan_text(plan)}):", flush=True)
        for wg in range(2):
            its = [i for i in range(1, 64) if buf[wg, i, 3]]
            if not its:
                continue
            t = buf[wg, its].astype(np.float64)
            # clock64 at 0 (start), 1 (depthwise done), 3 (end); cycles
            # summed at 2 (windows), 4 (issue), 5 (wait), 6 (stores)
            parts = [t[:, 2], t[:, 1] - t[:, 0] - t[:, 2], t[:, 4], t[:, 5],
                     t[:, 6], t[:, 3] - t[:, 1] - t[:, 4] - t[:, 5] - t[:, 6]]
            whole = (t[:, 3] - t[:, 0]).mean()
            print(f"   warpgroup {wg} ({len(its)} items): {whole:.0f} cycles "
                  f"an item = " + " | ".join(
                      f"{nm} {pt.mean():.0f}" for nm, pt in zip(names, parts)),
                  flush=True)


def grids(run):
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0]) * 1e6
    for hw, c, f, pre, post, _ in cs.TILED_SHAPES:
        n = cs.BATCH
        args = cs._sepconv_inputs(g, n, hw, c, f)
        nbytes = 2 * n * hw * hw * (c + f)
        o = torch.empty(n, hw, hw, f, dtype=torch.bfloat16, device="cuda")
        o2 = torch.empty_like(o)
        w_ms = cs.graph_ms(lambda: o.zero_())
        c_ms = cs.graph_ms(lambda: o.copy_(o2))
        plan = sepconv._sepconv_tiled_plan(n, hw, hw, c, f)
        cells = []
        for grid in (132, 66, 33):
            p = dict(plan, grid=grid)
            ms = cs.graph_ms(lambda: run(args, pre, post, p), calls=10,
                             reps=5)
            cells.append(f"{grid} blocks {ms:.4f} ms, "
                         f"{nbytes / (ms * 1e-3) / grid / clock:.2f} B/cycle "
                         f"a block")
        print(f"[grids] {hw}x{hw} C={c} F={f} ({short(plan)}): "
              + "; ".join(cells) + f" | card: zero_ of the output "
              f"{o.numel() * 2 / (w_ms * 1e-3) / 1e12:.2f} TB/s, copy_ "
              f"{2 * o.numel() * 2 / (c_ms * 1e-3) / 1e12:.2f} TB/s",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="source of the kernel before its plan")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--grids", action="store_true")
    ap.add_argument("--json", help="write every swept plan's time here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    src = build.CSRC / "sepconv_tiled.cu"
    jobs = {"now": (src, ())}
    if args.parent:
        jobs["parent"] = (Path(args.parent), ())
    if args.trace:
        jobs["trace"] = (src, ("SEPCONV_TILED_PHASE_TRACE",))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(nvcc, k, *v) for k, v in jobs.items()}
        libs = {k: f.result() for k, f in futs.items()}
    runs = {k: launcher(libs[k], planned=(k == "now"))
            for k in ("now", "parent") if k in libs}

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    shapes = [(cs.BATCH, hw, hw, c, f, pre, post, per)
              for hw, c, f, pre, post, per in cs.TILED_SHAPES]
    shapes += [(*s, 0) for s in cs.TILED_RAGGED]
    order = (["parent", "now", "now", "parent"] if args.parent
             else ["now", "now"])
    total = dict.fromkeys(runs, 0.0)
    best_total, swept = 0.0, []
    for n, h, w, c, f, pre, post, per in shapes:
        inputs = cs._sepconv_inputs(g, n, h, c, f, w)
        ref = sepconv.sepconv_reference(*inputs, pre, post)
        plan = sepconv._sepconv_tiled_plan(n, h, w, c, f)
        what = f"N={n} {h}x{w} C={c} F={f} pre={int(pre)} post={int(post)}"
        errs = {k: cs.compare(run(inputs, pre, post), ref, (k, what))
                for k, run in runs.items()}
        times = {k: [] for k in runs}
        if per:
            for k in order:
                times[k].append(cs.graph_ms(
                    lambda: runs[k](inputs, pre, post), calls=10, reps=5))
        cells = []
        for k in runs:
            ms = float(np.mean(times[k])) if times[k] else None
            if ms is not None:
                total[k] += per * ms
            cells.append(f"{k} " + (" / ".join(f"{t:.4f}" for t in times[k])
                                    + " ms" if times[k] else "untimed")
                         + f" (max abs {errs[k]:.4f})")
        print(f"[compare] {what} x{per}/forward: " + "; ".join(cells)
              + f"  [{cs.tiled_plan_text(plan)}]", flush=True)
        if not args.sweep:
            continue
        timed = []
        for p in every_plan(n, h, w, c, f):
            cs.compare(runs["now"](inputs, pre, post, p), ref,
                       ("sweep", what, short(p)))
            if per:
                ms = cs.graph_ms(lambda: runs["now"](inputs, pre, post, p),
                                 calls=10, reps=3)
                timed.append((ms, short(p)))
                swept.append(dict(shape=[n, h, w, c, f], per_forward=per,
                                  ms=ms, **p))
        if not per:
            print(f"[sweep] {what}: every plan agrees", flush=True)
            continue
        timed.sort()
        mine = short(plan)
        rank = [t[1] for t in timed].index(mine) + 1
        best_total += per * timed[0][0]
        print(f"[sweep] {what}: plan's choice ({mine}) ranks {rank} of "
              f"{len(timed)}; " + "; ".join(f"{s} {ms:.4f}"
                                           for ms, s in timed),
              flush=True)
    print("[compare] B3 per Xception forward (batch 32): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in total.items())
        + (f"; best swept plans {best_total:.4f} ms" if args.sweep else ""),
        flush=True)
    if args.parent:
        print(f"[compare] {total['now'] / total['parent']:.3f}x the parent's "
              f"time", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(swept))
    if args.grids:
        grids(runs["now"])
    if args.trace:
        trace(libs["trace"])


if __name__ == "__main__":
    main()
