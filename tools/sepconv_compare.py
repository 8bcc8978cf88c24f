"""B1's whole-image sepconv kernel beside an earlier version of it, and a
trace of where one block's time goes, on a GPU.

    python3 tools/sepconv_compare.py [--parent build/parent_sepconv.cu]
                                     [--trace]

Builds ``sparkdl_tpu_torch/ops/csrc/sepconv.cu`` with nvcc into
``build/sepconv_compare/`` and, at each B1 class of ``chip_smoke.py``
(Xception at batch 32), its ragged shapes and B3's four entry classes,
holds it against the plain version (``sepconv_reference``, chip_smoke's
tolerance) and times it (CUDA graph replay, the launch plan of
``_sepconv_plan``).  ``--parent`` names a source of the kernel as the
Xception port first shipped it (``sepconv_launch(x, dwk, pw, scale, shift,
out, N, H, W, C, F, pre_relu, post_relu, stream)``, no plan): it is built
beside it, checked and timed at the batch-32 classes in the same process,
and the per-forward sums of both are printed.  Make that file first, e.g.
``git show be45c4c:sparkdl_tpu_torch/ops/csrc/sepconv.cu >
build/parent_sepconv.cu``.

``--trace`` builds the kernel again with ``-DSEPCONV_PHASE_TRACE`` and, at
each Xception class, prints the mean clock64 cycles of one block's loop
iterations between the kernel's probes, for thread 0 of each warpgroup:
issuing the copies (warpgroup 0), issuing the products (wgmma), computing
the depthwise (warpgroups 1-2), waiting for the products, waiting for the
copies, the barrier; iterations of the first F tile (depthwise ones) apart
from later ones.  The probes' stores add a few cycles each.  Prints the
card's name and power limit first.  Needs a CUDA card.
"""

import argparse
import ctypes
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

OUT = ROOT / "build" / "sepconv_compare"
_P, _I = ctypes.c_void_p, ctypes.c_int
TRACE_POINTS = ("copies", "issue products", "depthwise", "wait products",
                "wait copies", "barrier")


def nvcc(name, src, defines=()):
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"lib{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           *[f"-D{d}" for d in defines], "-o", str(so), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    regs = [int(ln.split("Used ")[1].split()[0])
            for ln in (proc.stdout + proc.stderr).splitlines()
            if "Used " in ln and "registers" in ln]
    print(f"[build] {name}: {time.perf_counter() - t0:.1f}s, "
          f"{min(regs)}-{max(regs)} registers", flush=True)
    return ctypes.CDLL(str(so))


def launcher(lib, planned):
    fn = lib.sepconv_launch
    fn.argtypes = [_P] * 6 + [_I] * (13 if planned else 7) + [_P]
    fn.restype = _I

    def run(args, pre, post):
        x, dwk, pw, scale, shift = args
        n, h, w, c = x.shape
        f = pw.shape[1]
        out = torch.empty((n, h, w, f), dtype=torch.bfloat16, device="cuda")
        plan = []
        if planned:
            p = sepconv._sepconv_plan(n, h, w, c, f)
            plan = [p[k] for k in ("groups", "tiles_per_group", "n_tile",
                                   "kc", "stages", "smem")]
        rc = fn(*(t.data_ptr() for t in (x, dwk, pw, scale, shift, out)),
                n, h, w, c, f, int(pre), int(post), *plan,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"sepconv launch failed: CUDA error {rc}")
        return out
    return run


def compare(runs, parent):
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    shapes = [(cs.BATCH, hw, c, f, pre, post, per)
              for hw, c, f, pre, post, per in cs.SEPCONV_SHAPES]
    shapes += [(*s, 0) for s in cs.SEPCONV_RAGGED]
    shapes += [(cs.BATCH, hw, c, f, pre, post, 0)
               for hw, c, f, pre, post, _ in cs.TILED_SHAPES]
    total = dict.fromkeys(runs, 0.0)
    for n, hw, c, f, pre, post, per in shapes:
        args = cs._sepconv_inputs(g, n, hw, c, f)
        ref = sepconv.sepconv_reference(*args, pre, post)
        plan = sepconv._sepconv_plan(n, hw, hw, c, f)
        cells = []
        for name, run in runs.items():
            if name == "parent" and n != cs.BATCH:
                continue
            err = cs.compare(run(args, pre, post), ref,
                             (name, n, hw, c, f, pre, post))
            ms = cs.graph_ms(lambda: run(args, pre, post), calls=10, reps=5)
            total[name] += per * ms
            cells.append(f"{name} {ms:.4f} ms (max abs {err:.4f})")
        print(f"[compare] N={n} {hw}x{hw} C={c} F={f} pre={int(pre)} "
              f"post={int(post)} x{per}/forward: " + "; ".join(cells)
              + f"  [{cs.plan_text(plan)}]", flush=True)
    print("[compare] B1 per Xception forward (batch 32): " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in total.items()), flush=True)
    if parent:
        print(f"[compare] {total['now'] / total['parent']:.3f}x the parent's "
              f"time", flush=True)


def trace(lib):
    read = lib.sepconv_trace_read
    read.argtypes = [_P, _I]
    read.restype = _I
    run = launcher(lib, planned=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for hw, c, f, pre, post, _ in cs.SEPCONV_SHAPES:
        args = cs._sepconv_inputs(g, cs.BATCH, hw, c, f)
        plan = sepconv._sepconv_plan(cs.BATCH, hw, hw, c, f)
        # a block of the first full wave, away from the launch's start
        assert read(None, min(plan["blocks"] - 1, 100)) == 0
        buf = np.zeros((3, 128, 8), dtype=np.int64)
        run(args, pre, post)
        torch.cuda.synchronize()
        assert read(ctypes.c_void_p(buf.ctypes.data), 0) == 0
        nk = -(-(-(-c // 16) * 16) // plan["kc"])
        tiles = min(plan["tiles_per_group"], -(-f // (3 * plan["n_tile"])))
        iters = min(128, nk * tiles)
        print(f"[trace] {hw}x{hw} C={c} F={f}: {iters} iterations traced of "
              f"{nk * tiles} ({cs.plan_text(plan)})", flush=True)
        for wg in range(3):
            for label, its in (("first F tile", range(1, min(nk - 1, iters))),
                               ("later F tiles", range(nk, iters))):
                rows = [buf[wg, i] for i in its]
                if not rows:
                    continue
                rows = np.array(rows, dtype=np.float64)
                # an iteration without a barrier has no probe 5; then
                # waiting for the copies takes no time
                p5 = np.where(rows[:, 5] > 0, rows[:, 5], rows[:, 4])
                parts = [rows[:, 1] - rows[:, 0], rows[:, 2] - rows[:, 1],
                         rows[:, 3] - rows[:, 2], rows[:, 4] - rows[:, 3],
                         p5 - rows[:, 4], rows[:, 6] - p5]
                whole = (rows[:, 6] - rows[:, 0]).mean()
                print(f"   warpgroup {wg}, {label} ({len(rows)} its): "
                      f"{whole:.0f} cycles = " + " | ".join(
                          f"{name} {part.mean():.0f}"
                          for name, part in zip(TRACE_POINTS, parts)),
                      flush=True)
            ends = [buf[wg, i] for i in range(iters) if buf[wg, i, 7]]
            print(f"   warpgroup {wg}, epilogue: " + (f"{np.mean([e[7] - e[6] for e in ends]):.0f} cycles"
                                                    f" after each of {len(ends)} F tiles"), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="source of the kernel as first shipped")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    src = build.CSRC / "sepconv.cu"
    jobs = {"now": (src, ())}
    if args.parent:
        jobs["parent"] = (Path(args.parent), ())
    if args.trace:
        jobs["trace"] = (src, ("SEPCONV_PHASE_TRACE",))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(nvcc, k, *v) for k, v in jobs.items()}
        libs = {k: f.result() for k, f in futs.items()}
    runs = {k: launcher(libs[k], planned=(k != "parent"))
            for k in ("now", "parent") if k in libs}
    compare(runs, bool(args.parent))
    if args.trace:
        trace(libs["trace"])


if __name__ == "__main__":
    main()
