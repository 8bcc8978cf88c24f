"""One rank of the two-process gloo fits of ``test_torch_distributed.py``.

Run as: ``python _torch_dist_worker.py <rank> <world> <port> <out.json>
<ckpt_dir>``.  Imports torch and the port only.  Each rank holds an
UNEQUAL shard (:func:`shards`) and runs, in one process group and in this
order: the in-memory fit (checkpointed), the same fit with
``steps_per_execution=2``, the stream fit with a pinned
``steps_per_epoch``, the fit with ``train_fn`` + ``stats`` (a BatchNorm
whose statistics are the global batch's), and the two zero-row cases,
which must raise on both ranks.  The results go to ``out.json``.
"""

import json
import sys
from types import SimpleNamespace

import numpy as np

DIM, CLASSES, HIDDEN = 6, 4, 5
GLOBAL_BATCH = 8
EPOCHS = 3
STREAM_STEPS = 3
BN_EPS, BN_MOMENTUM = 1e-3, 0.1


def shards():
    """(x, y) per rank (10 and 6 rows), the first weights, and the BN
    model's params and statistics: shared by the ranks and the test's
    single-process oracle."""
    rng = np.random.default_rng(42)
    n = 16
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    y = (np.arange(n) % CLASSES).astype(np.int64)
    parts = [(x[:10], y[:10]), (x[10:], y[10:])]
    params = {"b": np.zeros(CLASSES, np.float32),
              "w": rng.normal(0, 0.1, (DIM, CLASSES)).astype(np.float32)}
    bn_params = {
        "bias": np.zeros(HIDDEN, np.float32),
        "scale": np.ones(HIDDEN, np.float32),
        "w1": rng.normal(0, 0.3, (DIM, HIDDEN)).astype(np.float32),
        "w2": rng.normal(0, 0.3, (HIDDEN, CLASSES)).astype(np.float32)}
    bn_stats = {"mean": np.zeros(HIDDEN, np.float32),
                "var": np.ones(HIDDEN, np.float32)}
    return parts, params, bn_params, bn_stats


def stream_chunks(rank):
    """Each rank's chunk sizes for the stream fit (unequal totals)."""
    return [3, 4, 3] if rank == 0 else [2, 4]


def main():
    rank, world, port, out_path, ckpt = (int(sys.argv[1]), int(sys.argv[2]),
                                         sys.argv[3], sys.argv[4],
                                         sys.argv[5])
    import torch

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.models.layers import flax_batch_norm_train
    from sparkdl_tpu_torch.parallel import distributed, mesh, train
    from sparkdl_tpu_torch.utils.metrics import Metrics

    sparkdl_tpu_torch.set_default_device("cpu")
    torch.set_num_threads(1)
    assert distributed.initialize(f"localhost:{port}", world, rank)
    parts, params, bn_params, bn_stats = shards()
    x, y = parts[rank]
    out = {"rank": rank, "process_count": distributed.process_count(),
           "backend": distributed.backend(),
           "mesh_shape": mesh.get_mesh().shape}

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1)

    def predict(p, xb):
        return xb @ p["w"] + p["b"]

    kw = dict(optimizer=sgd, loss=train.softmax_cross_entropy,
              batch_size=GLOBAL_BATCH, epochs=EPOCHS)
    metrics = Metrics()
    fitted, losses = train.fit_data_parallel(
        predict, params, x, y, checkpoint_dir=ckpt, metrics=metrics, **kw)
    out["arrays"] = {"losses": losses, "w": fitted["w"].tolist(),
                     "b": fitted["b"].tolist(),
                     "steps": metrics.counters.get("train.steps"),
                     "eager": metrics.counters.get("train.step_mode.eager")}
    fitted, losses = train.fit_data_parallel(
        predict, params, x, y, steps_per_execution=2, **kw)
    out["spe"] = {"losses": losses, "w": fitted["w"].tolist(),
                  "b": fitted["b"].tolist()}

    sizes = stream_chunks(rank)

    def source():
        off = 0
        for s in sizes:
            yield x[off:off + s], y[off:off + s]
            off += s

    fitted, losses = train.fit_data_parallel_stream(
        predict, params, source, steps_per_epoch=STREAM_STEPS, **kw)
    out["stream"] = {"losses": losses, "w": fitted["w"].tolist(),
                     "b": fitted["b"].tolist()}

    def bn_train(v, xb):
        p, s = v["params"], v["batch_stats"]
        bn = SimpleNamespace(running_mean=s["mean"], running_var=s["var"],
                             weight=p["scale"], bias=p["bias"], eps=BN_EPS,
                             momentum=BN_MOMENTUM)
        h = flax_batch_norm_train(bn, xb @ p["w1"])
        return torch.relu(h) @ p["w2"], s

    fitted, losses = train.fit_data_parallel(
        None, bn_params, x, y, train_fn=bn_train, stats=bn_stats,
        shuffle=False, **kw)
    out["stats"] = {"losses": losses,
                    "params": {k: v.tolist()
                               for k, v in fitted["params"].items()},
                    "batch_stats": {k: v.tolist() for k, v in
                                    fitted["batch_stats"].items()}}

    # a rank without rows: both ranks raise, neither waits
    xz, yz = (x, y) if rank == 0 else (x[:0], y[:0])
    errors = []
    try:
        train.fit_data_parallel(predict, params, xz, yz, **kw)
    except ValueError as e:
        errors.append(str(e))
    try:
        train.fit_data_parallel_stream(
            predict, params, lambda: iter([(xz, yz)]),
            steps_per_epoch=STREAM_STEPS, **kw)
    except ValueError as e:
        errors.append(str(e))
    out["zero_row_errors"] = errors
    distributed.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
