"""The ranks of ``test_torch_model_ranks.py``: a model axis that spans
processes.  Four gloo ranks of one CPU slot each, ``get_mesh(
model_parallel=2)``: data 2 x model 2 with the rows {0, 1} and {2, 3} and
the column groups {0, 2} and {1, 3} (layout (iii)).
``_torch_rank_slots_worker.py`` runs the same cases (:func:`run_layout`)
on its two ranks of two slots with ``model_parallel=4``: one row of four
slots over both ranks (layout (ii)).

Run as: ``python _torch_model_ranks_worker.py <rank> <world> <port>
<out.json> <tmp_dir>``.  Imports torch and the port only.  In one group,
each rank passing the rows of its data row (the ranks of a row the same
rows, JAX's replica contract):

  * ``sgd`` / ``adam``: ``tp_fit_reference``'s body and head, the head's
    kernel and bias split over ``model``, SGD and Adam over its three
    epochs of batch 8 (every step's loss and its type, the fitted params,
    the first step's shard gradients, the step's layout and mode);
  * ``stats``: ``make_train_step_with_stats`` on a small BatchNorm net
    whose conv (weight and bias) is split over ``model``;
  * ``resume``: the split Adam step checkpointed by rank 0 after two steps
    and resumed on every rank for two more, beside the uninterrupted four;
  * ``refusals``: both fits on the mesh, which must raise.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tests._multihost_worker import tp_fit_reference  # noqa: E402

TP_BATCH = 8
RESUME_STEPS = 4
STATS_BATCH = 8
STATS_STEPS = 3
BN_EPS, BN_MOMENTUM = 1e-3, 0.1


def stats_reference():
    """(x NCHW, y, params, stats) of the BatchNorm net: a 3x3 conv of 8
    channels (torch's OIHW weight), train-mode BatchNorm, ReLU, a mean
    over the pixels and a dense head of 2 classes."""
    rng = np.random.default_rng(11)
    n = STATS_BATCH * STATS_STEPS
    x = rng.normal(size=(n, 3, 6, 6)).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.int64)
    params = {
        "conv": {"kernel": rng.normal(0, 0.3, (8, 3, 3, 3)).astype(
            np.float32),
            "bias": rng.normal(0, 0.1, 8).astype(np.float32)},
        "bn": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
               "bias": rng.normal(0, 0.1, 8).astype(np.float32)},
        "head": {"kernel": rng.normal(0, 0.3, (8, 2)).astype(np.float32),
                 "bias": np.zeros(2, np.float32)}}
    stats = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
    return x, y, params, stats


def tp_rule_names(path):
    """The split of the split-head net: the head's kernel on its last
    dimension, its bias (None: replicated)."""
    if path.endswith("head/kernel"):
        return (None, "model")
    if path.endswith("head/bias"):
        return ("model",)
    return None


def stats_rule_names(path):
    """The split of the BatchNorm net: the conv's weight and bias on their
    first dimension (the output channels)."""
    if path.endswith(("conv/kernel", "conv/bias")):
        return ("model",)
    return None


def _lists(tree):
    return {k: (_lists(v) if isinstance(v, dict) else
                np.asarray(v).tolist()) for k, v in tree.items()}


def run_layout(rank, model_parallel, tmp):
    """Every case on ``get_mesh(model_parallel=...)`` in the group this
    process has joined; returns what the test checks."""
    from types import SimpleNamespace

    import torch
    import torch.nn.functional as F

    from sparkdl_tpu_torch.checkpoint import TrainCheckpointer
    from sparkdl_tpu_torch.models.layers import flax_batch_norm_train
    from sparkdl_tpu_torch.param.converters import OptaxAdam
    from sparkdl_tpu_torch.parallel import mesh, train
    from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map
    from sparkdl_tpu_torch.parallel.shard import ShardedTensor, gather
    from tests import _torch_dist_worker as dist_worker

    m = mesh.get_mesh(model_parallel=model_parallel)
    local = mesh.local_rows(m)
    dp, row = int(m.shape["data"]), local.rows[0]
    out = {"mesh": m.shape, "ranks": m.ranks.tolist(),
           "local": {"shape": local.shape, "rows": list(local.rows),
                     "row_ranks": [list(r) for r in local.row_ranks],
                     "positions": list(local.positions)}}

    def mine(off, batch):
        per = batch // dp
        return slice(off + row * per, off + (row + 1) * per)

    def rule(names):
        def spec(path, leaf):
            got = names(path)
            return mesh.P() if got is None else mesh.P(*got)
        return spec

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1)

    def adam(ps):
        return OptaxAdam(ps, lr=1e-2)

    # -- the split head, SGD and Adam ---------------------------------------
    x, y, params0, epochs = tp_fit_reference()

    def tp_predict(p, xb):
        h = torch.tanh(xb @ p["body"])
        return h @ p["head"]["kernel"] + p["head"]["bias"]

    def tp_step(make_opt):
        params = _tree_map(lambda a: torch.tensor(a, requires_grad=True),
                           params0)
        return train.make_train_step(
            tp_predict, train.softmax_cross_entropy,
            make_opt(_tree_leaves(params)), params, mesh=m,
            param_specs=rule(tp_rule_names))

    batches = [(torch.from_numpy(x[mine(off, TP_BATCH)]),
                torch.from_numpy(y[mine(off, TP_BATCH)]))
               for off in range(0, len(x), TP_BATCH)]
    for name, make_opt in (("sgd", sgd), ("adam", adam)):
        step = tp_step(make_opt)
        losses, dtypes, grads = [], set(), None
        for _ in range(epochs):
            for bx, by in batches:
                lval = step(bx, by)
                losses.append(float(lval))
                dtypes.add(str(lval.dtype))
                if grads is None:
                    head = step.tree["head"]
                    grads = {k: {"spans": head[k].spans(), "dim":
                                 head[k].split_dim, "grads": [
                                     s.grad.tolist() for s in head[k].shards]}
                             for k in ("kernel", "bias")}
        lay = step.layout()
        out[name] = {
            "losses": losses, "dtypes": sorted(dtypes), "grads": grads,
            "params": _lists(step.host_params()), "layout": lay,
            "flat_bytes": (None if step._flat is None else
                           step._flat.numel() * step._flat.element_size()),
            "sharded": isinstance(step.tree["head"]["kernel"], ShardedTensor),
            "mode": list(train.step_mode(
                torch.device("cuda"), step.optimizer, False,
                row=lay["row"], column=lay["column"]))}
        if name == "adam":
            out[name]["moments"] = [
                list(step.optimizer.state[s]["mu"].shape)
                for s in step.tree["head"]["kernel"].shards]
            sh = step.opt_state_shardings()
            leaf = [mesh.param_path_str(p) for p, _ in
                    mesh.tree_flatten_with_path(step.tree)].index(
                        "head/kernel")
            out[name]["mu_owners"] = np.asarray(
                sh[leaf]["mu"].mesh.ranks).tolist()
            out[name]["mu_spec"] = list(sh[leaf]["mu"].spec)

    # -- batch statistics through a split conv ------------------------------
    sx, sy, sparams, sstats = stats_reference()

    def bn_train(v, xb):
        p, s = v["params"], v["batch_stats"]
        h = F.conv2d(xb, p["conv"]["kernel"], p["conv"]["bias"], padding=1)
        bn = SimpleNamespace(running_mean=s["mean"], running_var=s["var"],
                             weight=p["bn"]["scale"], bias=p["bn"]["bias"],
                             eps=BN_EPS, momentum=BN_MOMENTUM)
        h = torch.relu(flax_batch_norm_train(bn, h))
        return h.mean(dim=(2, 3)) @ p["head"]["kernel"] + p["head"]["bias"], s

    params = _tree_map(lambda a: torch.tensor(a, requires_grad=True),
                       sparams)
    stats = {"batch_stats": _tree_map(torch.tensor, sstats)}
    step = train.make_train_step_with_stats(
        bn_train, train.softmax_cross_entropy, sgd(_tree_leaves(params)),
        params, stats, mesh=m, param_specs=rule(stats_rule_names))
    losses = []
    for off in range(0, len(sx), STATS_BATCH):
        rows = mine(off, STATS_BATCH)
        losses.append(float(step(torch.from_numpy(sx[rows]),
                                 torch.from_numpy(sy[rows]))))
    conv = step.tree["conv"]["kernel"]
    out["stats"] = {
        "losses": losses, "params": _lists(step.host_params()),
        "stats": _lists(_tree_map(lambda t: t.detach().numpy(),
                                  stats["batch_stats"])),
        "conv_shards": [list(s.shape) for s in conv.shards],
        "owners": conv.row_split.owners if conv.row_split else None}

    # -- a split step's checkpoint, resumed on every rank --------------------
    whole = tp_step(adam)
    for bx, by in batches[:RESUME_STEPS]:
        whole(bx, by)
    first = tp_step(adam)
    for bx, by in batches[:RESUME_STEPS // 2]:
        first(bx, by)
    ck = TrainCheckpointer(os.path.join(tmp, f"split_ckpt_{model_parallel}"))
    wrote = ck.maybe_save(1, first.state_dict())
    torch.distributed.barrier()
    _, restored = ck.restore_latest()
    again = tp_step(adam)
    again.load_state_dict(restored)
    kernel = again.tree["head"]["kernel"]
    want = np.asarray(restored["params"]["head"]["kernel"])
    index = [mesh.param_path_str(p) for p, _ in
             mesh.tree_flatten_with_path(again.tree)].index("head/kernel")
    saved = restored["opt_state"]["state"]
    mu = np.asarray(saved.get(index, saved.get(str(index)))["mu"])
    loaded = all(
        np.array_equal(s.detach().numpy(), want[:, off:off + n])
        and np.array_equal(again.optimizer.state[s]["mu"].numpy(),
                           mu[:, off:off + n])
        for (off, n), s in zip(kernel.spans(), kernel.shards))
    for bx, by in batches[RESUME_STEPS // 2:RESUME_STEPS]:
        again(bx, by)
    out["resume"] = {"wrote": wrote is not None, "loaded": loaded,
                     "saved_shape": list(want.shape),
                     "saved_mu_shape": list(mu.shape),
                     "whole": _lists(whole.host_params()),
                     "resumed": _lists(again.host_params()),
                     "gathered": gather(kernel).detach().numpy().tolist()}

    # -- the fits refuse a row across ranks ---------------------------------
    parts, fparams, _, _ = dist_worker.shards()
    fx, fy = parts[rank % 2]
    kw = dict(optimizer=sgd, loss=train.softmax_cross_entropy,
              batch_size=dist_worker.GLOBAL_BATCH, epochs=1, mesh=m)
    errors = []
    for run in (
            lambda: train.fit_data_parallel(
                lambda p, xb: xb @ p["w"] + p["b"], fparams, fx, fy, **kw),
            lambda: train.fit_data_parallel_stream(
                lambda p, xb: xb @ p["w"] + p["b"], fparams,
                lambda: iter([(fx, fy)]), steps_per_epoch=1, **kw)):
        try:
            run()
            errors.append(None)
        except NotImplementedError as e:
            errors.append(str(e))
    out["refusals"] = errors
    return out


def main():
    rank, world, port, out_path, tmp = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
    import torch

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.parallel import distributed

    sparkdl_tpu_torch.set_default_device("cpu")
    torch.set_num_threads(1)
    assert distributed.initialize(f"localhost:{port}", world, rank)
    out = run_layout(rank, 2, tmp)
    out["rank"] = rank
    out["made_groups"] = len(distributed._MADE)
    distributed.shutdown()
    out["group_left"] = (not torch.distributed.is_initialized()
                         and not distributed._MADE
                         and not distributed._LAYOUTS)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
