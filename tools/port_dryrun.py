"""Crash-safe dryrun of the PyTorch port (``sparkdl_tpu_torch``), with
incremental JSONL.

The port's counterpart of the JAX package's ``tools/dryrun.py`` and its
``__graft_entry__.entry()`` / ``dryrun_multichip(n)``, with the same
stage records: one fsync'd JSONL record a stage event through the port's
``utils.jsonl.CrashSafeJsonlWriter`` (``started``, then ``ok`` or
``error`` with wall seconds), so a SIGKILL at any instant leaves a valid,
stage-resolved partial record; every record is stamped ``faults:
none|<spec>`` (``SPARKDL_FAULTS``), so a chaos dryrun cannot pass for a
clean one.  Stages:

  * ``entry``: the flagship forward, InceptionV3's featurizer (seeded
    weights) over a uint8 batch with the ImageNet preprocess in the same
    call, on the device;
  * ``ranks[W]``: W processes joined by ``torch.distributed`` (gloo unless
    every rank has a card of its own: ``parallel.distributed``), one card
    a process, so on a machine with one card all W share it.  Each holds
    its shard of a small conv + BatchNorm + dense model's global batch and
    runs one data-parallel train step (``parallel.train.make_train_step``:
    gradients all-reduced) and a two-step run (``fit_data_parallel`` with
    ``steps_per_execution=2``); the ranks' losses must agree.  JAX's
    ``dryrun_multichip[N]`` is one controller over an N-device mesh; the
    port runs one process a card instead.

Usage::

    python tools/port_dryrun.py [--ranks W] [--artifact PATH]
                                [--skip-entry] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` asks for the CPU.  Exit code 0
iff every requested stage passed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

RANK_TIMEOUT_S = 300


class StageLog:
    """Stage records through the crash-safe JSONL writer: one fsync'd
    write a record; a read-only checkout disables the on-disk copy instead
    of failing the dryrun (stdout still carries every record)."""

    def __init__(self, path: str):
        from sparkdl_tpu_torch.utils.jsonl import CrashSafeJsonlWriter

        self.writer = CrashSafeJsonlWriter(path)
        self.writer.reset()

    def write(self, **rec) -> None:
        from sparkdl_tpu_torch.faults import current_spec

        rec.setdefault("ts", round(time.time(), 3))
        rec.setdefault("faults", current_spec() or "none")
        line = json.dumps(rec)
        print(line, flush=True)
        self.writer.write_line(line)


def _run_stage(log: StageLog, stage: str, fn) -> bool:
    log.write(stage=stage, status="started")
    t0 = time.perf_counter()
    try:
        detail = fn()
    # graftlint: allow=SDL003 reason=the written stage record IS the report; a driver greps it for pass/fail
    except BaseException as e:
        if isinstance(e, KeyboardInterrupt):
            raise
        log.write(stage=stage, status="error",
                  seconds=round(time.perf_counter() - t0, 3),
                  error=f"{type(e).__name__}: {str(e)[:300]}")
        return False
    log.write(stage=stage, status="ok",
              seconds=round(time.perf_counter() - t0, 3),
              **(detail or {}))
    return True


def entry(device=None):
    """``(fn, (module, batch))``: the flagship forward, InceptionV3's
    featurizer with the ImageNet preprocess in the same call, over a uint8
    RGB batch of 4 at the model's input size, its module on ``device``
    (the card unless the CPU is asked for)."""
    import numpy as np

    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.models import get_model_spec, load_model
    from sparkdl_tpu_torch.transformers.named_image import zoo_model_fn

    dev = resolve_device(device)
    spec = get_model_spec("InceptionV3")
    module = load_model(spec.name, weights=None).to(dev)
    h, w = spec.input_size
    return (zoo_model_fn(spec.name, True),
            (module, np.zeros((4, h, w, 3), np.uint8)))


def run_entry(device=None) -> dict:
    import numpy as np
    import torch

    fn, (module, batch) = entry(device)
    dev = next(module.parameters()).device
    with torch.no_grad():
        out = fn(module, torch.from_numpy(batch).to(dev))
    out = out.float().cpu().numpy()
    if not np.isfinite(out).all():
        raise RuntimeError("entry forward gave non-finite features")
    return {"output_shape": list(out.shape), "device": str(dev)}


# One rank of ``ranks[W]``: argv = rank, world, port, device.
_RANK = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.nn.functional as F

import sparkdl_tpu_torch
from sparkdl_tpu_torch.parallel import distributed, train

rank, world, port, device = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
sparkdl_tpu_torch.set_default_device(device)
distributed.initialize(f"localhost:{{port}}", world, rank)
dev = sparkdl_tpu_torch.resolve_device()

# the JAX dryrun's MiniCNN: conv-BN 8, max pool, conv-BN 16, global
# average pool, dense 10; BatchNorm frozen (inference-mode fine-tuning,
# the estimator's semantics), so its statistics are a scale and a shift
rng = np.random.default_rng(0)
params = {{
    "c1": rng.normal(0, 0.3, (8, 3, 3, 3)).astype(np.float32),
    "s1": np.ones(8, np.float32), "b1": np.zeros(8, np.float32),
    "c2": rng.normal(0, 0.1, (16, 8, 3, 3)).astype(np.float32),
    "s2": np.ones(16, np.float32), "b2": np.zeros(16, np.float32),
    "w": rng.normal(0, 0.25, (16, 10)).astype(np.float32),
    "b": np.zeros(10, np.float32)}}
batch = 2 * world
x = rng.normal(size=(batch, 16, 16, 3)).astype(np.float32)
y = (np.arange(batch) % 10).astype(np.int64)
lo, hi = 2 * rank, 2 * rank + 2      # this rank's shard of the batch


def predict(p, xb):
    h = xb.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(h, p["c1"], padding=1) * p["s1"][:, None, None]
               + p["b1"][:, None, None])
    h = F.max_pool2d(h, 2)
    h = F.relu(F.conv2d(h, p["c2"], padding=1) * p["s2"][:, None, None]
               + p["b2"][:, None, None])
    return h.mean((2, 3)) @ p["w"] + p["b"]


def adam(ps):
    return torch.optim.Adam(ps, lr=1e-3)


tensors = {{k: torch.tensor(v, device=dev, requires_grad=True)
           for k, v in params.items()}}
step = train.make_train_step(predict, train.softmax_cross_entropy,
                             adam(list(tensors.values())), tensors)
loss = float(step(torch.from_numpy(x[lo:hi]).to(dev),
                  torch.from_numpy(y[lo:hi]).to(dev)))
# the two-step run: one epoch of two steps in one group
xs, ys = np.concatenate([x[lo:hi]] * 2), np.concatenate([y[lo:hi]] * 2)
_, losses = train.fit_data_parallel(
    predict, params, xs, ys, optimizer=adam,
    loss=train.softmax_cross_entropy, batch_size=batch, epochs=1,
    shuffle=False, steps_per_execution=2)
print(json.dumps({{"rank": rank, "world": distributed.process_count(),
                  "backend": distributed.backend(), "device": str(dev),
                  "loss": loss, "two_step_losses": losses}}), flush=True)
distributed.shutdown()
"""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, device=None) -> dict:
    """W rank processes over ``torch.distributed``; each must finish with
    a finite loss, and all ranks' losses must agree (the all-reduced
    global batch's mean)."""
    import math

    from sparkdl_tpu_torch import resolve_device

    dev = resolve_device(device).type
    port = _free_port()
    code = _RANK.format(repo=_REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(port), dev],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results, errors = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}: "
                              f"{err[-1500:]}")
            else:
                results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("; ".join(errors))
    losses = [r["loss"] for r in results]
    two = [tuple(r["two_step_losses"]) for r in results]
    if not all(math.isfinite(v) for v in losses) or len(set(losses)) != 1 \
            or len(set(two)) != 1:
        raise RuntimeError(f"ranks disagree: losses {losses}, two-step "
                           f"losses {two}")
    return {"world": world, "backend": results[0]["backend"],
            "devices": sorted({r["device"] for r in results}),
            "loss": round(losses[0], 6),
            "two_step_losses": [round(v, 6) for v in two[0]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes of the ranks stage (default 2)")
    ap.add_argument("--artifact", default=os.path.join(
        _REPO, "artifacts", "port_dryrun_lines.jsonl"),
        help="incremental JSONL artifact path")
    ap.add_argument("--skip-entry", action="store_true",
                    help="skip the entry forward")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sparkdl_tpu_torch import resolve_device

    device = resolve_device(args.device)
    log = StageLog(args.artifact)
    ok = True
    if not args.skip_entry:
        ok = _run_stage(log, "entry", lambda: run_entry(device)) and ok
    ok = _run_stage(log, f"ranks[{args.ranks}]",
                    lambda: run_ranks(args.ranks, device)) and ok
    log.write(stage="summary", status="ok" if ok else "error")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
