"""B2's mbconv kernel beside an earlier version of it, and a sweep of its
launch plans, on a GPU.

    python3 tools/mbconv_compare.py [--parent build/parent_mbconv.cu]
                                    [--sweep]

Builds ``sparkdl_tpu_torch/ops/csrc/mbconv.cu`` with nvcc into
``build/mbconv_compare/`` and, at each B2 class of ``chip_smoke.py``
(MobileNetV2's 13 stride-1 tails at batch 32) and its ragged shapes, holds
it against the plain version (``mbconv_reference``, chip_smoke's
tolerance) and times it (CUDA graph replay, the launch plan of
``_mbconv_plan``).  ``--parent`` names a source of the kernel with the
interface the MobileNetV2 port first shipped (``mbconv_launch(x, dwk, pw,
mid_shift, shift, out, N, H, W, C, F, stream)``, no plan): it is built
beside it, checked and timed at every shape in the same process, and the
per-forward sums of both are printed.  Make that file first, e.g. ``git
show f21043c:sparkdl_tpu_torch/ops/csrc/mbconv.cu >
build/parent_mbconv.cu``.

``--trace`` builds the kernel again with ``-DMBCONV_PHASE_TRACE`` and, at
each batch-32 class, prints where one block's time goes (mean clock64
cycles of lane 0 of each warp: issuing the first copies, then per chunk
waiting for its copies, the block barrier, issuing the next chunk's
copies, the depthwise, the products,
then the epilogue's partial tile and first cluster barrier, the rows'
reduction and stores, the last barrier) and how the launch's blocks spread
over time (%globaltimer at each block's start and end).

``--sweep`` also runs every plan the library instantiates (tile kind,
cluster size S, C chunk, ring stages) at every shape: each is held against
the plain version, and at the batch-32 classes timed, with the plan's own
choice ranked among them; ``--json`` writes every swept plan with its
time.  Prints the card's name and power limit first.
Needs a CUDA card.
"""

import argparse
import ctypes
import itertools
import json
import re
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

OUT = ROOT / "build" / "mbconv_compare"
_P, _I = ctypes.c_void_p, ctypes.c_int


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
    # ptxas: "Compiling entry function '_Z...mbconv_kernelILi<NT>ELi<KC>E
    # Lb<2d>E...'", then its spill and register lines
    per, entry = [], None
    for ln in log:
        m = re.search(r"mbconv_kernelILi(\d+)ELi(\d+)ELb([01])E", ln)
        if m and "Compiling entry" in ln:
            entry, spill = m.groups(), 0
        elif entry and "bytes spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif entry and "Used " in ln and "registers" in ln:
            nt, kc, t2 = entry
            per.append(f"NT={nt} KC={kc} {'2d' if t2 == '1' else 'flat'}: "
                       f"{ln.split('Used ')[1].split()[0]}"
                       + (f" (spills {spill} B)" if spill else ""))
            entry = None
    if per:
        print("[build]   registers: " + "; ".join(per), flush=True)
    return ctypes.CDLL(str(so))


def launcher(lib, planned):
    """``run(args, plan)`` through ``lib``'s ``mbconv_launch``; the parent's
    interface takes no plan."""
    fn = lib.mbconv_launch
    fn.argtypes = [_P] * 6 + [_I] * (12 if planned else 5) + [_P]
    fn.restype = _I

    def run(args, plan=None):
        x, dwk, pw, mid, shift = args
        n, h, w, c = x.shape
        f = pw.shape[1]
        out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device="cuda")
        extra = []
        if planned:
            plan = plan or sepconv._mbconv_plan(n, h, w, c, f)
            extra = [int(plan["tile"] == "2d"), plan["cluster"],
                     plan["f_tile"], plan["kc"], plan["stages"],
                     plan["grid_y"], plan["smem"]]
        rc = fn(*(t.data_ptr() for t in (x, dwk, pw, mid, shift, out)),
                n, h, w, c, f, *extra, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"mbconv launch failed: CUDA error {rc}")
        return out
    return run


def every_plan(n, h, w, c, f):
    """Every plan the library instantiates for the shape, as the kernel
    takes it (the plan function's choice among them)."""
    for tile2d, s, kc, stages, spread in itertools.product(
            (False, True), sepconv._MB_CLUSTERS, sepconv._MB_CHUNKS,
            sepconv._MB_STAGES, (False, True)):
        if spread and s > 1:
            continue  # a split block takes one tile anyway
        plan = sepconv._mbconv_candidate(n, h, w, c, f, tile2d, s, kc, stages,
                                         spread)
        if plan is not None:
            yield plan


def short(plan):
    return (f"{plan['tile']} S={plan['cluster']} KC={plan['kc']} "
            f"st={plan['stages']} T={plan['tiles_per_block']}")


def trace(lib):
    read = lib.mbconv_trace_read
    read.argtypes = [_P, _P, _I]
    read.restype = _I
    run = launcher(lib, planned=True)
    points = 2 + 5 * 16 + 4
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for hw, c, f, _ in cs.MBCONV_SHAPES:
        inputs = cs._mbconv_inputs(g, cs.BATCH, hw, hw, c, f)
        plan = sepconv._mbconv_plan(cs.BATCH, hw, hw, c, f)
        block = plan["blocks"] // 2
        run(inputs)  # warm: code and weights in the caches
        torch.cuda.synchronize()
        assert read(None, None, block) == 0
        run(inputs)
        torch.cuda.synchronize()
        phases = np.zeros((4, points), dtype=np.int64)
        spans = np.zeros((16384, 2), dtype=np.uint64)
        assert read(phases.ctypes.data, spans.ctypes.data, 0) == 0
        chunks = min(plan["chunks"], 16)
        print(f"[trace] {hw}x{hw} C={c} F={f}, block {block} "
              f"({cs.mbconv_plan_text(plan)}):", flush=True)
        for wp in range(4):
            t = phases[wp].astype(np.float64)
            last = 1
            wait, bar, cp, dw, mma = [], [], [], [], []
            for i in range(chunks):
                p = 2 + 5 * i
                if not t[p + 4]:
                    break  # this block walks fewer chunks than the most
                wait.append(t[p] - t[last])
                bar.append(t[p + 1] - t[p])
                cp.append(t[p + 2] - t[p + 1])
                dw.append(t[p + 3] - t[p + 2])
                mma.append(t[p + 4] - t[p + 3])
                last = p + 4
            e = points - 4
            if not t[e + 3]:  # no split: the tiles' stores are in the walk
                print(f"   warp {wp}: {t[last] - t[0]:.0f} cycles = first "
                      f"copies {t[1] - t[0]:.0f} | per item ({len(wait)}): "
                      f"wait {np.mean(wait):.0f}, barrier {np.mean(bar):.0f},"
                      f" next copies {np.mean(cp):.0f}, depthwise "
                      f"{np.mean(dw):.0f}, products+stores {np.mean(mma):.0f}",
                      flush=True)
                continue
            print(f"   warp {wp}: {t[e + 3] - t[0]:.0f} cycles = first "
                  f"copies {t[1] - t[0]:.0f} | per chunk ({len(wait)}): wait "
                  f"{np.mean(wait):.0f}, barrier {np.mean(bar):.0f}, next "
                  f"copies {np.mean(cp):.0f}, depthwise {np.mean(dw):.0f}, "
                  f"products {np.mean(mma):.0f}"
                  f" | epilogue: drain+barrier {t[e] - t[last]:.0f}, partial "
                  f"+ sync {t[e + 1] - t[e]:.0f}, reduce+store "
                  f"{t[e + 2] - t[e + 1]:.0f}, last sync "
                  f"{t[e + 3] - t[e + 2]:.0f}", flush=True)
        n = min(plan["blocks"], 16384)
        start = spans[:n, 0].astype(np.float64)
        end = spans[:n, 1].astype(np.float64)
        t0 = start.min()
        dur = (end - start) / 1e3
        first = (start - t0 < 1000).sum()
        print(f"   blocks: {n} traced, launch span "
              f"{(end.max() - t0) / 1e3:.2f} us, a block {dur.mean():.2f} us "
              f"on average (min {dur.min():.2f}, max {dur.max():.2f}), "
              f"{first} started in the first microsecond, the last at "
              f"{(start.max() - t0) / 1e3:.2f} us", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="source of the kernel as first shipped")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--trace", action="store_true")
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
    src = build.CSRC / "mbconv.cu"
    jobs = {"now": (src, ())}
    if args.parent:
        jobs["parent"] = (Path(args.parent), ())
    if args.trace:
        jobs["trace"] = (src, ("MBCONV_PHASE_TRACE",))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(nvcc, k, *v) for k, v in jobs.items()}
        libs = {k: f.result() for k, f in futs.items()}
    runs = {k: launcher(libs[k], planned=(k == "now"))
            for k in ("now", "parent") if k in libs}
    if args.trace:
        trace(libs["trace"])

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    shapes = [(cs.BATCH, hw, hw, c, f, None, per)
              for hw, c, f, per in cs.MBCONV_SHAPES]
    shapes += [(*s, 0) for s in cs.MBCONV_RAGGED]
    total = dict.fromkeys(runs, 0.0)
    best_total = 0.0
    swept = []
    for n, h, w, c, f, tile, per in shapes:
        inputs = cs._mbconv_inputs(g, n, h, w, c, f)
        ref = sepconv.mbconv_reference(*inputs)
        plan = sepconv._mbconv_plan(n, h, w, c, f, tile)
        what = f"N={n} {h}x{w} C={c} F={f}"
        cells = []
        for name, run in runs.items():
            p = plan if name == "now" else None
            err = cs.compare(run(inputs, p), ref, (name, what))
            ms = cs.graph_ms(lambda: run(inputs, p), calls=10, reps=5)
            total[name] += per * ms
            cells.append(f"{name} {ms:.4f} ms (max abs {err:.4f})")
        print(f"[compare] {what} x{per}/forward: " + "; ".join(cells)
              + f"  [{cs.mbconv_plan_text(plan)}]", flush=True)
        if not args.sweep:
            continue
        timed = []
        for p in every_plan(n, h, w, c, f):
            cs.compare(runs["now"](inputs, p), ref, ("sweep", what, p))
            if per:
                ms = cs.graph_ms(lambda: runs["now"](inputs, p), calls=10,
                                 reps=3)
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
                                           for ms, s in timed[:6]),
              flush=True)
    print("[compare] B2 per MobileNetV2 forward (batch 32): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in total.items())
        + (f"; best swept plans {best_total:.4f} ms" if args.sweep else ""),
        flush=True)
    if args.parent:
        print(f"[compare] {total['now'] / total['parent']:.3f}x the parent's "
              f"time", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(swept))


if __name__ == "__main__":
    main()
