"""Capture a ``torch.profiler`` trace of one zoo-model forward of the
PyTorch port (``sparkdl_tpu_torch``) on the card.

Usage: python tools/port_capture_profile.py [model] [out_dir] [batch]
                                            [--device cuda|cpu]
       (defaults: InceptionV3 artifacts/port_profile 128 cuda)

The model runs in the configuration of the JAX package's
``tools/capture_profile.py``: bf16 compute, the preprocess on the device,
the batch already on the host in pinned memory, through the engine's
captured CUDA graph (the port's one program a forward), with the zoo's
weights (``SPARKDL_WEIGHTS_DIR``, else the seeded init).  Writes
``<out_dir>/<model>/trace.json`` (Chrome trace-event JSON, for Perfetto or
``chrome://tracing``) and prints one JSON line: the in-trace wall time of
the forward, the implied img/s and the kernel records by name.

The forward runs twice in the profiled window and only the second counts
(``sparkdl_tpu_torch.utils.metrics.profiled_kernels``): the profiler loses
the first kernel records of its window late in a process, so a single
window can undercount.  The counted forward is the ``sparkdl.counted``
range of the trace.  Runs on the card; ``--device cpu`` asks for the CPU,
where the profiler sees no kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="InceptionV3")
    ap.add_argument("out", nargs="?", default=os.path.join(
        "artifacts", "port_profile"))
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from sparkdl_tpu_torch import resolve_device
    from sparkdl_tpu_torch.models import get_model_spec, load_model
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers.named_image import zoo_model_fn
    from sparkdl_tpu_torch.utils.metrics import profiled_kernels

    device = resolve_device(args.device)
    spec = get_model_spec(args.model)
    h, w = spec.input_size
    eng = InferenceEngine(
        zoo_model_fn(spec.name, True, compute_dtype=torch.bfloat16),
        load_model(spec.name), device=device,
        device_batch_size=args.batch, compute_dtype=torch.bfloat16,
        output_host_dtype=np.float32)
    rng = np.random.default_rng(0)
    piece = eng._pad((rng.random((args.batch, h, w, 3)) * 255).astype(
        np.uint8))
    eng.run_padded(piece)  # capture (and build) outside the trace

    trace_dir = os.path.join(args.out, spec.name.lower())
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    total, names, wall_ms = profiled_kernels(lambda: eng.run_padded(piece),
                                             trace_path=path)
    out = {"model": spec.name, "batch": args.batch, "device": str(device),
           "trace": path, "in_trace_wall_s": round(wall_ms / 1e3, 4),
           "implied_img_s": round(args.batch / (wall_ms / 1e3), 1),
           "kernels": total,
           "kernels_by_name": dict(sorted(names.items(),
                                          key=lambda kv: -kv[1]))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
