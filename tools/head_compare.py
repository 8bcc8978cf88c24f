"""Kernel H1 (the head fan-out's head pass) beside an earlier version of
it, on a GPU.

    python3 tools/head_compare.py [--parent build/parent_head_fanout.cu]
                                  [--sweep] [--trace]
                                  [--json chiprun_out/head_compare.json]

Builds ``sparkdl_tpu_torch/ops/csrc/head_fanout.cu`` with nvcc into
``build/head_compare/`` and, at every shape of ``chip_smoke.py``'s
``HEAD_SHAPES`` (n rows in {1, 7, 32}, D = 2048, C in {100, 129, 1000},
a bank of 64 heads), in f32 and in bf16 weights, holds it against the plain
version (``head_pass_reference``, bit for bit) and times it (CUDA graph
replay, ``chip_smoke.graph_ms``) beside its bound (``head_pass_cost`` at
this run's distinct heads, 2 bytes a bf16 weight).  ``--parent`` names a
source of the kernel with the interface it first shipped with
(``head_fanout_launch(feats, idx, kernel, bias, out, n, cap, D, C, P,
stream)``, f32 weights only): it is built beside it, checked and timed at
every f32 shape in the same process, in turns (parent, kernel, kernel,
parent).  Make that file first, e.g. ``git show
5e76041:sparkdl_tpu_torch/ops/csrc/head_fanout.cu >
build/parent_head_fanout.cu``.  ``--sweep`` also checks and times every
cluster size S at every shape, the plan's (``ops/head.py::_head_plan``)
starred; ``--trace`` builds the kernel with ``-DH1_PHASE_TRACE`` and
prints where the first blocks of a one-row pass spend their cycles.
Prints the card's name and power limit first.  Needs a CUDA card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sparkdl_tpu_torch.ops import build  # noqa: E402
from sparkdl_tpu_torch.ops import head as hops  # noqa: E402

OUT = ROOT / "build" / "head_compare"
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
    return ctypes.CDLL(str(so))


def launcher(lib, typed):
    """``run(feats, idx, kernel, bias, S=None)`` through ``lib``'s
    ``head_fanout_launch`` (S None: ``_head_plan``'s); the parent's
    interface takes no plan and no weight type."""
    fn = lib.head_fanout_launch
    fn.argtypes = [_P] * 5 + [_I] * (7 if typed else 5) + [_P]
    fn.restype = _I

    def run(feats, idx, kernel, bias, S=None):
        n, d = feats.shape
        cap, _, c = kernel.shape
        out = torch.empty((n, c), dtype=torch.float32, device="cuda")
        extra = ([S or hops._head_plan(n, d, c),
                  hops._WEIGHT_CODES[kernel.dtype]] if typed else [])
        rc = fn(*(t.data_ptr() for t in (feats, idx, kernel, bias, out)), n,
                cap, d, c, hops.head_partials(d), *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"head_fanout launch failed: CUDA error {rc}")
        return out
    return run


MARKS = ("index back", "copies issued", "chunk 0 landed", "chains done",
         "cluster started", "partials met", "row stored")


def trace(g):
    """Builds the kernel with -DH1_PHASE_TRACE and prints, for the first
    blocks of a one-row pass at each cluster size, when each started
    (%globaltimer, ns after the first) and the clock64 cycles from each
    phase mark to the next."""
    lib = nvcc("head_fanout_trace", build.CSRC / "head_fanout.cu",
               ("H1_PHASE_TRACE",))
    run = launcher(lib, True)
    read = lib.head_fanout_trace
    read.argtypes = [_P]
    read.restype = _I
    buf = (ctypes.c_ulonglong * (16 * (len(MARKS) + 2)))()
    for c in (100, 1000):
        feats, idx, kernel, bias = cs._head_bank_inputs(g, 1, c)
        for s in (16, 8, 4, 1):
            for _ in range(3):  # warm: the last launch's stamps are read
                run(feats, idx, kernel, bias, S=s)
            torch.cuda.synchronize()
            if read(buf):
                raise RuntimeError("head_fanout_trace failed")
            a = np.asarray(buf, dtype=np.int64).reshape(16, len(MARKS) + 2)
            blocks = min(16, -(-c // 32) * s)
            t0 = a[:blocks, -1].min()
            print(f"[H1 trace] f32 n=1 C={c} S={s}: per block start ns / "
                  f"cycles to " + ", ".join(MARKS), flush=True)
            for b in range(blocks):
                steps = np.diff(a[b, :len(MARKS) + 1])
                print(f"[H1 trace]   block {b}: +{a[b, -1] - t0} ns; "
                      + " ".join(str(int(x)) for x in steps), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier head_fanout.cu (f32 only)")
    ap.add_argument("--sweep", action="store_true",
                    help="also check and time every cluster size S")
    ap.add_argument("--trace", action="store_true",
                    help="per-phase clock64 of the first blocks at n=1")
    ap.add_argument("--json", help="write every row here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("head_compare: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernel_run = launcher(nvcc("head_fanout", build.CSRC / "head_fanout.cu"),
                          True)
    parent_run = (launcher(nvcc("parent_head_fanout", args.parent), False)
                  if args.parent else None)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 80)
    one = torch.zeros(1, device="cuda")
    floor = cs.graph_ms(lambda: one.zero_())
    print(f"[H1] launch floor: a one-element fill in the same graph replay "
          f"{floor * 1e3:.2f} us", flush=True)
    if args.trace:
        trace(torch.Generator(device="cuda").manual_seed(cs.SEED + 79))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in cs.HEAD_SHAPES:
            feats, idx, kernel, bias = cs._head_bank_inputs(g, n, c)
            kernel, bias = kernel.to(dtype), bias.to(dtype)
            operands = (feats, idx, kernel, bias)
            ref = hops.head_pass_reference(*operands)
            versions = [("kernel", kernel_run)]
            if parent_run is not None and dtype == torch.float32:
                versions.append(("parent", parent_run))
            for name, run in versions:
                out = run(*operands)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise SystemExit(
                        f"{name} != plain version at {dtype} n={n} C={c}: "
                        f"max abs {(out - ref).abs().max().item():.3g}")
            order = versions[::-1] + versions  # parent, kernel, kernel, parent
            times = {name: [] for name, _ in versions}
            for name, run in order:
                times[name].append(cs.graph_ms(lambda: run(*operands)))
            distinct = int(torch.unique(idx).numel())
            flops, nbytes = hops.head_pass_cost(n, cs.HEAD_D, c, distinct,
                                                kernel.element_size())
            b_ms, b_by = cs.bound(flops, nbytes, cs.PEAK_F32_FLOPS)
            plan = hops._head_plan(n, cs.HEAD_D, c)
            sweep = {}
            for s in ((1, 2, 4, 8, 16) if args.sweep else ()):
                out = kernel_run(*operands, S=s)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise SystemExit(f"S={s} != plain version at {dtype} "
                                     f"n={n} C={c}")
                sweep[s] = cs.graph_ms(lambda: kernel_run(*operands, S=s))
            if sweep:
                print(f"[H1 sweep] {dtype} n={n} C={c}: " + ", ".join(
                    f"S={s}{'*' if s == plan else ''} {t * 1e3:.2f} us"
                    for s, t in sweep.items()), flush=True)
            row = dict(card=card, dtype=str(dtype).replace("torch.", ""),
                       shape=[n, cs.HEAD_D, c], distinct_heads=distinct,
                       bound_ms=b_ms, bound_by=b_by, plan_S=plan,
                       sweep_ms={str(s): t for s, t in sweep.items()},
                       **{f"{k}_ms": v for k, v in times.items()})
            rows.append(row)
            k_ms = min(times["kernel"])
            ks = ", ".join(f"{t * 1e3:.2f}" for t in times["kernel"])
            line = (f"[H1] {row['dtype']} n={n} C={c} ({distinct} distinct): "
                    f"== plain bit for bit; kernel {ks} us; bound "
                    f"{b_ms * 1e3:.2f} us ({b_by}) -> {b_ms / k_ms:.1%}")
            if "parent" in times:
                p_ms = min(times["parent"])
                parent = ", ".join(f"{t * 1e3:.2f}" for t in times["parent"])
                line += f"; parent {parent} us -> {p_ms / k_ms:.2f}x"
            print(line, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
