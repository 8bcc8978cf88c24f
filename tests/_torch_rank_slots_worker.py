"""One rank of the two-process gloo group of ``test_torch_rank_slots.py``,
each rank holding two CPU slots (``distributed.initialize(local_slots=
["cpu", "cpu"])``).

Run as: ``python _torch_rank_slots_worker.py <rank> <world> <port>
<port2> <out.json> <tmp_dir>``.  Imports torch and the port only.  In one
group, in this order:

  * ``tp``: JAX's dp2 x tp2 topology (``tests/_multihost_worker.py
    _run_tensor_parallel``): ``make_train_step`` on ``get_mesh(
    model_parallel=2)``, the head's kernel and bias split over ``model``
    within each rank, each rank stepping its half of every global batch;
  * ``arrays`` / ``stream``: ``fit_data_parallel`` (checkpointed) and
    ``fit_data_parallel_stream`` on dp4 = 2 ranks x 2 data groups, over
    ``_torch_dist_worker``'s unequal shards;
  * ``stats`` / ``stats64``: the BatchNorm fit (``train_fn`` + ``stats``)
    on dp4 in float32 and in float64;
  * ``resume``: the split step with Adam, checkpointed by rank 0 after two
    steps and resumed on every rank for two more, beside the
    uninterrupted four;
  * ``estimator``: ``ImageFileEstimator`` with ``trainBatchStats`` on the
    small BatchNorm net whose weights the test wrote (``bn.pt``), each
    rank over its eight of the test's 16 images, so that the global
    batches are the images in order;
  * ``loss_type``: the dp2 x tp2 split head with bf16 params, its logits
    cast to float32 (a float32 loss) and kept in bf16 (a bf16 loss): each
    step's loss and its type;
  * ``tp4``: a model axis that spans the ranks, one row of four slots
    (``get_mesh(model_parallel=4)``, each rank two shards of every split
    weight): ``_torch_model_ranks_worker.run_layout``'s cases, the fits'
    refusal among them.

Then it leaves the group and joins a second one (``port2``) asking for
2 + rank slots, which must raise the same ``ValueError`` on both ranks.
The results go to ``out.json``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tests import _torch_dist_worker as dist_worker  # noqa: E402
from tests import _torch_model_ranks_worker as model_ranks  # noqa: E402
from tests._multihost_worker import tp_fit_reference  # noqa: E402

SLOTS = 2
TP_BATCH = 8
RESUME_STEPS = 4


def load8(uri):
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((8, 8))
    return np.asarray(img, dtype=np.float32) / 255.0


def rank_images(paths, rank, world=2, per_step=4):
    """Rank ``rank``'s images: its ``per_step`` of each global step of
    ``world * per_step`` images in order."""
    step = world * per_step
    return [p for off in range(0, len(paths), step)
            for p in paths[off + rank * per_step:off + (rank + 1) * per_step]]


def bn_net():
    """``tests/test_torch_image_file_estimator.py TorchBNNet`` (NHWC in)."""
    import torch

    from sparkdl_tpu_torch.models.layers import BatchNorm

    class BNNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
            self.bn = BatchNorm(4, eps=1e-5)
            self.head = torch.nn.Linear(4, 2)

        def forward(self, x):
            y = self.bn(self.conv(x.permute(0, 3, 1, 2)))
            return torch.softmax(self.head(y.mean(dim=(2, 3))), dim=-1)

    return BNNet()


def _lists(tree):
    return {k: (_lists(v) if isinstance(v, dict) else
                np.asarray(v).tolist()) for k, v in tree.items()}


def main():
    rank, world, port, port2, out_path, tmp = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    from types import SimpleNamespace

    import torch

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.checkpoint import TrainCheckpointer
    from sparkdl_tpu_torch.models.layers import flax_batch_norm_train
    from sparkdl_tpu_torch.param.converters import OptaxAdam
    from sparkdl_tpu_torch.parallel import distributed, mesh, train
    from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map
    from sparkdl_tpu_torch.parallel.shard import ShardedTensor, gather
    from sparkdl_tpu_torch.utils.metrics import Metrics

    sparkdl_tpu_torch.set_default_device("cpu")
    torch.set_num_threads(1)
    assert distributed.initialize(f"localhost:{port}", world, rank,
                                  local_slots=["cpu"] * SLOTS)
    dp4 = mesh.get_mesh()
    tp = mesh.get_mesh(model_parallel=2)
    out = {"rank": rank, "backend": distributed.backend(),
           "global_slots": [[str(d) for d in row]
                            for row in distributed.global_slots()],
           "dp4": {"shape": dp4.shape, "ranks": dp4.ranks.tolist(),
                   "local": mesh.local_rows(dp4).shape},
           "tp": {"shape": tp.shape, "ranks": tp.ranks.tolist(),
                  "local": mesh.local_rows(tp).shape}}

    # -- (i) JAX's dp2 x tp2 fit ------------------------------------------
    def tp_rule(path, leaf):
        if path.endswith("head/kernel"):
            return mesh.P(None, "model")
        if path.endswith("head/bias"):
            return mesh.P("model")
        return mesh.P()

    def tp_predict(p, xb):
        h = torch.tanh(xb @ p["body"])
        return h @ p["head"]["kernel"] + p["head"]["bias"]

    x, y, params0, epochs = tp_fit_reference()
    local = TP_BATCH // world

    def tp_step(make_opt):
        params = _tree_map(lambda a: torch.tensor(a, requires_grad=True),
                           params0)
        return train.make_train_step(
            tp_predict, train.softmax_cross_entropy,
            make_opt(_tree_leaves(params)), params, mesh=tp,
            param_specs=tp_rule)

    def tp_batches():
        for off in range(0, len(x), TP_BATCH):
            rows = slice(off + rank * local, off + (rank + 1) * local)
            yield torch.from_numpy(x[rows]), torch.from_numpy(y[rows])

    step = tp_step(lambda ps: torch.optim.SGD(ps, lr=0.1))
    kernel = step.tree["head"]["kernel"]
    losses = []
    for _ in range(epochs):
        for bx, by in tp_batches():
            lval = step(bx, by)
        losses.append(float(lval))
    out["tp"].update(
        losses=losses, params=_lists(step.host_params()),
        shards=[list(s.shape) for s in kernel.shards],
        sharded=isinstance(kernel, ShardedTensor),
        flat_bytes=step._flat.numel() * step._flat.element_size())

    # -- (ii) the fits on dp4 ----------------------------------------------
    parts, params, bn_params, bn_stats = dist_worker.shards()
    x, y = parts[rank]

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1)

    def predict(p, xb):
        return xb @ p["w"] + p["b"]

    kw = dict(optimizer=sgd, loss=train.softmax_cross_entropy,
              batch_size=dist_worker.GLOBAL_BATCH, epochs=dist_worker.EPOCHS)

    def record(fitted, losses, m):
        return {"losses": losses, "fitted": _lists(fitted),
                "groups": m.gauges.get("train.data_groups"),
                "steps": m.counters.get("train.steps"),
                "modes": [k for k in m.counters
                          if k.startswith("train.step_mode.")]}

    m = Metrics()
    fitted, losses = train.fit_data_parallel(
        predict, params, x, y, checkpoint_dir=os.path.join(tmp, "ckpt"),
        metrics=m, **kw)
    out["arrays"] = record(fitted, losses, m)

    sizes = dist_worker.stream_chunks(rank)

    def source():
        off = 0
        for s in sizes:
            yield x[off:off + s], y[off:off + s]
            off += s

    m = Metrics()
    fitted, losses = train.fit_data_parallel_stream(
        predict, params, source, steps_per_epoch=dist_worker.STREAM_STEPS,
        metrics=m, **kw)
    out["stream"] = record(fitted, losses, m)

    # -- (iii) batch statistics across the ranks' groups ---------------------
    def bn_train(v, xb):
        p, s = v["params"], v["batch_stats"]
        bn = SimpleNamespace(running_mean=s["mean"], running_var=s["var"],
                             weight=p["scale"], bias=p["bias"],
                             eps=dist_worker.BN_EPS,
                             momentum=dist_worker.BN_MOMENTUM)
        h = flax_batch_norm_train(bn, xb @ p["w1"])
        return torch.relu(h) @ p["w2"], s

    for name, dtype in (("stats", np.float32), ("stats64", np.float64)):
        m = Metrics()
        fitted, losses = train.fit_data_parallel(
            None, {k: v.astype(dtype) for k, v in bn_params.items()},
            x.astype(dtype), y, train_fn=bn_train,
            stats={k: v.astype(dtype) for k, v in bn_stats.items()},
            shuffle=False, metrics=m, **kw)
        out[name] = record(fitted, losses, m)
    why = train.step_mode(torch.device("cuda"), sgd([torch.zeros(1)]),
                          True, groups=SLOTS)
    out["stats"]["cuda_mode"] = list(why)

    # -- (iv) a split step's checkpoint, resumed on every rank ---------------
    def adam(ps):
        return OptaxAdam(ps, lr=1e-2)

    x, y, params0, _ = tp_fit_reference()
    batches = list(tp_batches())
    whole = tp_step(adam)
    for bx, by in batches[:RESUME_STEPS]:
        whole(bx, by)
    first = tp_step(adam)
    for bx, by in batches[:RESUME_STEPS // 2]:
        first(bx, by)
    ck = TrainCheckpointer(os.path.join(tmp, "split_ckpt"))
    wrote = ck.maybe_save(1, first.state_dict())
    torch.distributed.barrier()
    _, restored = ck.restore_latest()
    again = tp_step(adam)
    again.load_state_dict(restored)
    kernel = again.tree["head"]["kernel"]
    b = kernel.bounds()
    want = np.asarray(restored["params"]["head"]["kernel"])
    loaded = all(np.array_equal(s.detach().numpy(), want[:, b[i]:b[i + 1]])
                 for i, s in enumerate(kernel.shards))
    moments = [list(again.optimizer.state[s]["mu"].shape)
               for s in kernel.shards]
    for bx, by in batches[RESUME_STEPS // 2:RESUME_STEPS]:
        again(bx, by)
    out["resume"] = {"wrote": wrote is not None, "loaded": loaded,
                     "moments": moments,
                     "whole": _lists(whole.host_params()),
                     "resumed": _lists(again.host_params()),
                     "gathered": gather(kernel).detach().numpy().tolist()}

    # -- ImageFileEstimator, batch statistics on the group's default mesh ---
    from sparkdl_tpu_torch.estimators import ImageFileEstimator
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction

    net = bn_net()
    net.load_state_dict(torch.load(os.path.join(tmp, "bn.pt")))
    paths = sorted(os.path.join(tmp, "images", f)
                   for f in os.listdir(os.path.join(tmp, "images")))
    mine = rank_images(paths, rank)
    index = {p: i for i, p in enumerate(paths)}
    est = ImageFileEstimator(
        inputCol="uri", outputCol="preds", labelCol="label",
        imageLoader=load8, optimizer="sgd", batchSize=8,
        loss="categorical_crossentropy",
        modelFunction=ModelFunction.from_module(net), trainBatchStats=True,
        fitParams={"epochs": 1, "shuffle": False})
    fm = est.fit(DataFrame({"uri": mine, "label": [
        [0.0, 1.0] if index[p] % 2 else [1.0, 0.0] for p in mine]}))
    out["estimator"] = {
        "losses": fm.trainLosses,
        "state": {k: v.numpy().tolist() for k, v in
                  fm.getModelFunction().module.state_dict().items()
                  if not k.endswith("num_batches_tracked")}}

    # -- the loss keeps its own type in a group ------------------------------
    x, y, params0, _ = tp_fit_reference()
    out["loss_type"] = {}
    for name, logits in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        params = _tree_map(lambda a: torch.tensor(
            a, dtype=torch.bfloat16, requires_grad=True), params0)

        def cast_predict(p, xb, logits=logits):
            return tp_predict(p, xb.to(torch.bfloat16)).to(logits)

        step = train.make_train_step(
            cast_predict, train.softmax_cross_entropy,
            sgd(_tree_leaves(params)), params, mesh=tp, param_specs=tp_rule)
        losses, dtypes = [], set()
        for bx, by in tp_batches():
            lval = step(bx, by)
            losses.append(float(lval))
            dtypes.add(str(lval.dtype))
        out["loss_type"][name] = {"losses": losses, "dtypes": sorted(dtypes)}

    # -- (v) a model axis across the ranks ------------------------------------
    out["tp4"] = model_ranks.run_layout(rank, 2 * SLOTS, tmp)
    out["tp4"]["rank"] = rank
    distributed.shutdown()

    # -- (v) unequal slot counts: the same ValueError on every rank ---------
    try:
        distributed.initialize(f"localhost:{port2}", world, rank,
                               local_slots=["cpu"] * (SLOTS + rank))
        out["unequal"] = None
    except ValueError as e:
        out["unequal"] = str(e)
    out["group_left"] = not torch.distributed.is_initialized()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
