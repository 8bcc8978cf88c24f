"""Online inference with sparkdl_tpu_torch.serving, end to end.

The PyTorch port's twin of ``examples/serving_quickstart.py``.  The
offline stack scores whole DataFrames; this example shows the ONLINE path
the serving subsystem adds: single requests admitted into a bounded
queue, assembled into dynamic micro-batches, dispatched through the same
InferenceEngine the transformers use (on the card, one captured CUDA
graph a bucket), and demultiplexed back to per-request futures, with
deadlines, backpressure and metrics.

Walkthrough:
  1. a raw ``fn(module, batch)`` served with ``Server`` (threaded
     submitters, futures, p50/p99 from the metrics registry);
  2. asyncio integration (``predict_async``);
  3. ``serving.from_transformer``: a configured ``ModelTransformer``
     lifted into a server, with the server's rows checked bit-identical
     against the offline ``transform`` of the same inputs;
  4. the shared-queue UDF: ``register_serving_udf`` scores a DataFrame
     column THROUGH the running server.

The model is a dense softmax layer written as a broadcast multiply and a
sum, so a row's arithmetic is the same wherever it sits in a batch (a
GEMM's rows can move by an ulp with their position): that is what lets
a served row, alone in its batch, equal the offline row bit for bit.

Run:  python examples/port_serving_quickstart.py [--device cpu]
      (on the card unless --device cpu; without a card and without
      --device cpu it raises RuntimeError)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DIM, CLASSES = 32, 8


class Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(w))


def fn(m, x):
    logits = (x.float()[..., :, None] * m.w).sum(-2)
    return torch.softmax(logits, dim=-1)


def make_model():
    rng = np.random.default_rng(7)
    return Dense(rng.normal(0, 0.2, (DIM, CLASSES)).astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import sparkdl_tpu_torch

    device = sparkdl_tpu_torch.resolve_device(args.device)
    with sparkdl_tpu_torch.default_device(device):
        _tour(device)


def _tour(device):
    from sparkdl_tpu_torch import serving
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.transformers.tensor import ModelTransformer
    from sparkdl_tpu_torch.udf.registry import (register_serving_udf,
                                                udf_registry)

    module = make_model()
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(96, DIM)).astype(np.float32)

    # -- 1. raw fn behind a server: concurrent submitters ----------------
    with serving.Server(fn, module, max_batch_size=16, max_wait_ms=3,
                        max_queue=256, device=device) as srv:
        srv.warmup(xs[0])
        results = [None] * len(xs)

        def client(lo, hi):
            futs = [(i, srv.submit(xs[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = np.asarray(f.result())

        threads = [threading.Thread(target=client, args=(lo, lo + 24))
                   for lo in range(0, 96, 24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats()
        assert all(r is not None and r.shape == (CLASSES,) for r in results)
        print(f"served {int(stats['serving.completed'])} requests in "
              f"{int(stats['serving.batches'])} micro-batches, p99 "
              f"{1e3 * stats['serving.request_latency.p99_s']:.1f} ms")

        # -- 2. asyncio handler form -------------------------------------
        async def handler():
            return await asyncio.gather(
                *[srv.predict_async(xs[i]) for i in range(4)])

        async_rows = asyncio.run(handler())
        assert len(async_rows) == 4

    # -- 3. transformer -> server, parity with the offline path ----------
    mf = ModelFunction(fn=fn, module=module)
    stage = ModelTransformer(inputCol="features", outputCol="probs",
                             modelFunction=mf, batchSize=16)
    df = DataFrame({"features": [row for row in xs]})
    offline = stage.transform(df).column_to_numpy("probs")
    # one bucket pinned to the stage's batch size: bit-identity is a
    # per-padded-shape contract
    with serving.from_transformer(stage, max_wait_ms=3,
                                  bucket_sizes=[16]) as srv:
        online = np.stack([np.asarray(srv.predict(x)) for x in xs])
        assert np.array_equal(online.astype(np.float32), offline), \
            "online rows must be bit-identical to transform()"

        # -- 4. DataFrame column scored THROUGH the running server -------
        register_serving_udf("probs_via_server", srv)
        scored = udf_registry.apply("probs_via_server", df, "features",
                                    "probs")
        udf_rows = scored.column_to_numpy("probs")
        assert np.allclose(udf_rows, offline, rtol=1e-6, atol=1e-7)

    print(json.dumps({"serving_quickstart": "ok",
                      "requests": int(stats["serving.completed"]),
                      "device": str(device)}))


if __name__ == "__main__":
    main()
