"""Training on a mesh of several slots in one process (``parallel/train.py``
``TrainStep`` over data groups, ``parallel/shard.py``'s trainable shards,
``models/layers.py``'s BatchNorm across groups, ``fitMultiple``'s mesh
slices) held against the JAX package on the CPU.

The port runs on ``get_mesh(devices=["cpu"] * n, model_parallel=m)``; the
JAX side runs on the conftest's 8 virtual devices with the same seeded
numpy inputs.  Each test ports one of ``tests/test_estimators.py``'s
mesh tests with its tolerances (rtol 1e-4 / atol 1e-5 unless it says
otherwise); the fitMultiple tests stand eight CPU slots in for the virtual
devices by patching the default device list (``mesh._global_devices``).
Every partitioned form of ``ShardedTensor`` and its gather give each shard
the gradient of its slice of the whole-tensor gradient (rtol 1e-6, f32).
"""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as JP

import sparkdl_tpu_torch
from sparkdl_tpu.estimators import CrossValidator as JaxCV
from sparkdl_tpu.estimators import ImageFileEstimator as JaxEstimator
from sparkdl_tpu.estimators import (
    MulticlassClassificationEvaluator as JaxEvaluator)
from sparkdl_tpu.frame import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.parallel import get_mesh as jget_mesh
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu_torch.estimators import (CrossValidator, ImageFileEstimator,
                                          MulticlassClassificationEvaluator)
from sparkdl_tpu_torch.estimators import image_file_estimator as pife
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.layers import flax_batch_norm_train
from sparkdl_tpu_torch.param.converters import Lamb, OptaxAdam
from sparkdl_tpu_torch.parallel import mesh as mesh_lib
from sparkdl_tpu_torch.parallel import train
from sparkdl_tpu_torch.parallel.engine import _tree_leaves
from sparkdl_tpu_torch.parallel.shard import ShardedTensor, gather
from sparkdl_tpu_torch.utils.metrics import Metrics
from tests.test_torch_image_file_estimator import (  # noqa: F401
    _bn_state_dict, _bn_twins, _columns, files, load8)

FIT_TOL = dict(rtol=1e-4, atol=1e-5)
MAP_TOL = dict(rtol=1e-4, atol=1e-6)     # fitMultiple's weights
GRAD_TOL = dict(rtol=1e-6, atol=1e-7)    # a shard's gradient vs its slice
# a whole operand's gradient: the sum of every shard's part, in another
# order than the whole op's (a conv's input gradient moves by ~1e-6)
OPERAND_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def slots(n, model=1):
    return mesh_lib.get_mesh(devices=["cpu"] * n, model_parallel=model)


@pytest.fixture
def eight_slots(monkeypatch):
    """The default device list as eight CPU slots: the port's stand-in for
    the JAX conftest's 8 virtual devices."""
    monkeypatch.setattr(mesh_lib, "_global_devices",
                        lambda: ([torch.device("cpu")] * 8, [0] * 8))


def _sgd(lr):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


# -- data-parallel fits ------------------------------------------------------

def test_fit_data_parallel_converges_and_matches_single_device():
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(5, 1)).astype(np.float32)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    y = x @ w_true
    kw = dict(loss="mse", batch_size=16, epochs=30, seed=7)

    def run(mesh, m=None):
        return train.fit_data_parallel(
            lambda p, xb: xb @ p["w"], {"w": np.zeros((5, 1), np.float32)},
            x, y, optimizer=_sgd(0.1), mesh=mesh, metrics=m, **kw)

    m8 = Metrics()
    (f8, l8), (f1, l1) = run(slots(8), m8), run(slots(1))
    jf8, jl8 = jtrain.fit_data_parallel(
        lambda p, xb: jnp.asarray(xb) @ p["w"],
        {"w": np.zeros((5, 1), np.float32)}, x, y,
        optimizer=optax.sgd(0.1), mesh=jget_mesh(), **kw)
    assert m8.gauges["train.data_groups"] == 8
    assert l8[-1] < 1e-3
    np.testing.assert_allclose(f8["w"], f1["w"], **FIT_TOL)
    np.testing.assert_allclose(f8["w"], np.asarray(jf8["w"]), **FIT_TOL)
    np.testing.assert_allclose(l8, jl8, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(f8["w"], w_true, rtol=0.05, atol=0.01)


def _bn_variables():
    from flax import linen as nn

    class BNNet(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = nn.Dense(8, name="d1")(x)
            x = nn.BatchNorm(use_running_average=not train, name="bn")(x)
            return nn.Dense(2, name="head")(x)

    module = BNNet()
    variables = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(0), np.zeros((1, 5), np.float32), train=False))

    def jax_train_fn(v, xb):
        pred, mutated = module.apply(v, xb, train=True,
                                     mutable=["batch_stats"])
        return pred, mutated["batch_stats"]

    return variables, jax_train_fn


def _bn_train(v, xb):
    """flax's BNNet (Dense, train-mode BatchNorm, Dense) on the port."""
    p, s = v["params"], v["batch_stats"]
    h = xb @ p["d1"]["kernel"] + p["d1"]["bias"]
    bn = SimpleNamespace(running_mean=s["bn"]["mean"],
                         running_var=s["bn"]["var"], weight=p["bn"]["scale"],
                         bias=p["bn"]["bias"], eps=1e-5, momentum=0.01)
    h = flax_batch_norm_train(bn, h)
    return h @ p["head"]["kernel"] + p["head"]["bias"], s


def test_train_batch_stats_global_batch_equivalence():
    """dp8 against one device and against JAX's dp8: the BatchNorm's μ and
    σ² are the global batch's across the eight groups' threads, so the
    fitted statistics and params agree."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    y = rng.normal(size=(64, 2)).astype(np.float32)
    variables, jax_train_fn = _bn_variables()
    kw = dict(loss="mse", batch_size=16, epochs=4, shuffle=False)

    def run(mesh):
        fitted, losses = train.fit_data_parallel(
            None, dict(variables["params"]), x, y, optimizer=_sgd(0.05),
            mesh=mesh, train_fn=_bn_train,
            stats=dict(variables["batch_stats"]), **kw)
        return fitted, losses

    (f8, l8), (f1, l1) = run(slots(8)), run(slots(1))
    jf8, jl8 = jtrain.fit_data_parallel(
        None, dict(variables["params"]), x, y, optimizer=optax.sgd(0.05),
        mesh=jget_mesh(), train_fn=jax_train_fn,
        stats=dict(variables["batch_stats"]), **kw)
    for other in (f1, jax.tree_util.tree_map(np.asarray, jf8)):
        for part in ("batch_stats", "params"):
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(a, b, **FIT_TOL),
                f8[part], other[part])
    np.testing.assert_allclose(l8, jl8, rtol=1e-4)
    assert not np.allclose(f8["batch_stats"]["bn"]["mean"],
                           variables["batch_stats"]["bn"]["mean"])


def test_stream_fit_on_two_slots_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y = (np.arange(40) % 3).astype(np.int64)
    w = rng.normal(0, 0.1, (6, 3)).astype(np.float32)

    def chunks():
        off = 0
        for n in (13, 16, 11):
            yield x[off:off + n], y[off:off + n]
            off += n

    kw = dict(batch_size=8, epochs=2)
    m = Metrics()
    fitted, losses = train.fit_data_parallel_stream(
        lambda p, xb: xb @ p["w"], {"w": w}, chunks, optimizer=_sgd(0.1),
        loss=train.softmax_cross_entropy, mesh=slots(2), metrics=m, **kw)
    jfitted, jlosses = jtrain.fit_data_parallel_stream(
        lambda p, xb: xb @ p["w"], {"w": w}, chunks,
        optimizer=optax.sgd(0.1),
        loss=lambda lg, yb: optax.softmax_cross_entropy_with_integer_labels(
            lg, yb.astype(jnp.int32)), mesh=jget_mesh(num_devices=2), **kw)
    assert m.gauges["train.data_groups"] == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(fitted["w"], np.asarray(jfitted["w"]),
                               **FIT_TOL)


# -- the model axis: a split head -------------------------------------------

DIM, CLASSES, ROWS = 6, 4, 32


def _tp_data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    y = (np.arange(ROWS) % CLASSES).astype(np.int64)
    params0 = {
        "body": rng.normal(0, 0.1, (DIM, DIM)).astype(np.float32),
        "head": {"kernel": rng.normal(0, 0.1, (DIM, CLASSES)
                                      ).astype(np.float32),
                 "bias": np.zeros((CLASSES,), np.float32)},
    }
    return x, y, params0


def _jax_tp_rule(path, leaf):
    if path.endswith("head/kernel"):
        return JP(None, "model")
    if path.endswith("head/bias"):
        return JP("model")
    return JP()


def _tp_rule(path, leaf):
    if path.endswith("head/kernel"):
        return mesh_lib.P(None, "model")
    if path.endswith("head/bias"):
        return mesh_lib.P("model")
    return mesh_lib.P()


def _jax_tp_fit(opt, mesh, specs):
    x, y, params0 = _tp_data()

    def predict(p, xb):
        h = jnp.tanh(jnp.asarray(xb) @ p["body"])
        return h @ p["head"]["kernel"] + p["head"]["bias"]

    def ce(logits, yb):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yb.astype(jnp.int32))

    step = jtrain.make_train_step(predict, ce, opt, mesh=mesh, cache=False,
                                  param_specs=specs, params_template=params0)
    params, opt_state = step.put_state(params0, opt.init(params0))
    for off in range(0, ROWS, 8):
        bx, by = step.put_batch(x[off:off + 8], y[off:off + 8].astype(
            np.int32))
        params, opt_state, lval = step(params, opt_state, bx, by)
    return (jax.tree_util.tree_map(np.asarray, params), float(lval),
            opt_state)


def _port_tp_step(make_opt, mesh, specs):
    x, y, params0 = _tp_data()
    params = jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=True), params0)
    opt = make_opt(_tree_leaves(params))

    def predict(p, xb):
        h = torch.tanh(xb @ p["body"])
        return h @ p["head"]["kernel"] + p["head"]["bias"]

    step = train.make_train_step(predict, train.softmax_cross_entropy, opt,
                                 params, mesh=mesh, param_specs=specs)
    return step, x, y


def _run(step, x, y, rows=range(0, ROWS, 8)):
    for off in rows:
        lval = step(torch.from_numpy(x[off:off + 8]),
                    torch.from_numpy(y[off:off + 8]))
    return step.host_params(), float(lval)


def test_tensor_parallel_head_matches_replicated():
    """data 4 x model 2 with the head's kernel and bias split, SGD: the
    same fit as the replicated dp8 step and as JAX's (4, 2) step; each
    shard is a leaf of its own that the optimizer steps."""
    step, x, y = _port_tp_step(_sgd(0.1), slots(8, 2), _tp_rule)
    kernel = step.tree["head"]["kernel"]
    assert isinstance(kernel, ShardedTensor) and kernel.split_dim == 1
    assert [tuple(s.shape) for s in kernel.shards] == [(DIM, 2), (DIM, 2)]
    assert all(s.is_leaf and s.requires_grad for s in kernel.shards)
    stepped = [p for g in step.optimizer.param_groups for p in g["params"]]
    assert {id(s) for s in kernel.shards} <= {id(p) for p in stepped}
    assert all(p.shape != (DIM, CLASSES) for p in stepped)
    p_tp, l_tp = _run(step, x, y)
    assert all(s.grad is not None and s.grad.shape == s.shape
               for s in kernel.shards)
    rep, _, _ = _port_tp_step(_sgd(0.1), slots(8), None)
    p_rep, l_rep = _run(rep, x, y)
    jp_tp, jl_tp, _ = _jax_tp_fit(optax.sgd(0.1),
                                  jget_mesh(model_parallel=2), _jax_tp_rule)
    assert np.isfinite(l_tp) and np.isfinite(l_rep)
    np.testing.assert_allclose(l_tp, l_rep, rtol=1e-4)
    np.testing.assert_allclose(l_tp, jl_tp, rtol=1e-4)
    for other in (p_rep, jp_tp):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, **FIT_TOL),
            p_tp, other)


def test_tensor_parallel_opt_state_single_compile():
    """Adam on (4, 2): the moments live per shard in shard-shaped tensors
    and report the kernel's sharding, the step count replicated; the step
    places its params once (the same leaves every step: one program, eager
    on the CPU), and the fit matches JAX's."""
    step, x, y = _port_tp_step(lambda ps: OptaxAdam(ps, lr=1e-2),
                               slots(8, 2), _tp_rule)
    before = [id(p) for p in step.params]
    fitted, lval = _run(step, x, y)
    assert [id(p) for p in step.params] == before
    assert np.isfinite(lval)
    kernel = step.tree["head"]["kernel"]
    for s in kernel.shards:
        st = step.optimizer.state[s]
        assert tuple(st["mu"].shape) == tuple(s.shape) == (DIM, 2)
    leaf = [mesh_lib.param_path_str(p) for p, _ in
            mesh_lib.tree_flatten_with_path(step.tree)].index("head/kernel")
    sh = step.opt_state_shardings()
    assert sh[leaf]["mu"].spec == mesh_lib.P(None, "model")
    assert sh[leaf]["nu"].spec == mesh_lib.P(None, "model")
    assert sh[leaf]["step"] is step.replicated
    jfitted, jl, jstate = _jax_tp_fit(optax.adam(1e-2),
                                      jget_mesh(model_parallel=2),
                                      _jax_tp_rule)
    assert jstate[0].mu["head"]["kernel"].sharding.spec == \
        JP(None, "model")
    np.testing.assert_allclose(lval, jl, rtol=1e-4)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, **FIT_TOL),
        fitted, jfitted)


def test_split_checkpoint_saves_whole_and_resumes(tmp_path):
    """A step's state dict holds each split leaf whole, and Adam's moments
    in the whole leaves' layout; a fresh step on another layout loads it
    and goes on as the uninterrupted step."""
    from sparkdl_tpu_torch.checkpoint import TrainCheckpointer

    make = lambda ps: OptaxAdam(ps, lr=1e-2)  # noqa: E731
    whole, x, y = _port_tp_step(make, slots(8, 2), _tp_rule)
    want, _ = _run(whole, x, y)
    first, _, _ = _port_tp_step(make, slots(8, 2), _tp_rule)
    _run(first, x, y, range(0, 16, 8))
    state = first.state_dict()
    assert tuple(state["params"]["head"]["kernel"].shape) == (DIM, CLASSES)
    assert not isinstance(state["params"]["head"]["kernel"], ShardedTensor)
    saved = state["opt_state"]["state"]
    assert len(saved) == 3 and tuple(saved[2]["mu"].shape) == (DIM, CLASSES)
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    ck.maybe_save(1, state)
    _, restored = ck.restore_latest()
    for mesh, specs in ((slots(8, 2), _tp_rule), (slots(2, 2), _tp_rule),
                        (slots(1), None)):
        again, _, _ = _port_tp_step(make, mesh, specs)
        again.load_state_dict(restored)
        got, _ = _run(again, x, y, range(16, ROWS, 8))
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                    atol=1e-6), got, want)


def test_split_refuses_what_it_cannot_split():
    """A split needs an elementwise optimizer (Lamb's trust ratio is a
    whole-tensor norm) and the model axis (a data-axis split raises, as
    the engine's does)."""
    with pytest.raises(NotImplementedError, match="Lamb"):
        _port_tp_step(lambda ps: Lamb(ps, lr=1e-2), slots(8, 2), _tp_rule)
    with pytest.raises(NotImplementedError, match="data axis"):
        _port_tp_step(_sgd(0.1), slots(8, 2),
                      lambda path, leaf: mesh_lib.P("data"))


# -- gradients of every partitioned form -------------------------------------

def _whole_and_split(shape, dim, seed, k=2):
    g = torch.Generator().manual_seed(seed)
    whole = torch.randn(shape, generator=g, dtype=torch.float32)
    n = shape[dim] // k
    shards = [whole.narrow(dim, i * n, n).clone().requires_grad_()
              for i in range(k)]
    return whole.requires_grad_(), ShardedTensor(shards, dim)


FORMS = {
    # name: (weight shape, split dim, f(w, x) -> tensor, x shape)
    "linear": ((6, 5), 0, lambda w, x, b: F.linear(x, w, b), (3, 5)),
    "conv2d": ((4, 3, 3, 3), 0,
               lambda w, x, b: F.conv2d(x, w, b, padding=1), (2, 3, 5, 5)),
    "matmul": ((5, 6), 1, lambda w, x, b: x @ w, (3, 5)),
    "elementwise": ((3, 6), 1,
                    lambda w, x, b: torch.tanh(w * 2.0 + x) - w.sigmoid(),
                    (3, 6)),
    "broadcast": ((3, 6), 1, lambda w, x, b: F.relu(w + x) * x, (1, 6)),
    "sum": ((4, 6), 1, lambda w, x, b: (w * x).sum(dim=0), (4, 6)),
    "mean": ((4, 6), 1, lambda w, x, b: torch.mean(w - x, dim=0), (4, 6)),
    "t": ((5, 6), 1, lambda w, x, b: w.t() * 3.0, (1,)),
    "transpose": ((5, 6), 1, lambda w, x, b: w.transpose(0, 1) - x, (6, 1)),
    "permute": ((2, 3, 4), 2, lambda w, x, b: w.permute(2, 0, 1) * x,
                (1, 1, 3)),
    "gather": ((5, 6), 1,
               lambda w, x, b: torch.log_softmax(x @ w, dim=-1), (3, 5)),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_partitioned_form_gradients(form):
    """Each shard's gradient equals its slice of the whole tensor's, and a
    whole operand's gradient equals the whole op's; the gather's backward
    hands each shard its slice."""
    shape, dim, f, xshape = FORMS[form]
    whole, split = _whole_and_split(shape, dim, seed=len(form))
    g = torch.Generator().manual_seed(7)
    xw = torch.randn(xshape, generator=g).requires_grad_()
    xs = xw.detach().clone().requires_grad_()
    bias = None
    if form in ("linear", "conv2d"):
        bias = torch.randn(shape[0], generator=g).requires_grad_()
    bias_s = None if bias is None else bias.detach().clone().requires_grad_()
    out_w = f(whole, xw, bias)
    out_s = f(split, xs, bias_s)
    assert isinstance(out_s, ShardedTensor) == (form != "gather")
    out_s = gather(out_s)
    r = torch.randn(out_w.shape, generator=g)
    (out_w * r).sum().backward()
    (out_s * r).sum().backward()
    torch.testing.assert_close(out_s.detach(), out_w.detach(), **GRAD_TOL)
    got = torch.cat([s.grad for s in split.shards], dim)
    torch.testing.assert_close(got, whole.grad, **GRAD_TOL)
    assert isinstance(split.grad, ShardedTensor) and split.requires_grad
    torch.testing.assert_close(gather(split.grad), whole.grad, **GRAD_TOL)
    if xw.grad is not None:
        torch.testing.assert_close(xs.grad, xw.grad, **OPERAND_TOL)
    if bias is not None:
        torch.testing.assert_close(bias_s.grad, bias.grad, **GRAD_TOL)


# -- fitMultiple's mesh slices and CrossValidator ----------------------------

class _Tiny(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))


def _tiny_fn(module, x):
    return torch.softmax(x.reshape(x.shape[0], -1) @ module.w, dim=-1)


def _tiny_w(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.01, (8 * 8 * 3, 2)).astype(np.float32)


def _tiny_jmf():
    def fn(v, x):
        logits = x.reshape(x.shape[0], -1) @ v["w"]
        return jnp.exp(logits) / jnp.sum(jnp.exp(logits), axis=-1,
                                         keepdims=True)

    return JaxModelFunction(fn=fn, variables={"w": _tiny_w()})


def _tiny_mf():
    return ModelFunction(fn=_tiny_fn, module=_Tiny(_tiny_w()))


@pytest.fixture
def slice_log(monkeypatch):
    """Each port fit's mesh size and thread, as fitMultiple hands them to
    ``fit_data_parallel``."""
    log, real = [], pife.fit_data_parallel

    def logged(*a, **kw):
        log.append((kw["mesh"].size, threading.current_thread().name))
        return real(*a, **kw)

    monkeypatch.setattr(pife, "fit_data_parallel", logged)
    return log


def _est_kw(**kw):
    return dict(dict(inputCol="uri", outputCol="preds", labelCol="label",
                     imageLoader=load8, optimizer="sgd", batchSize=8,
                     loss="categorical_crossentropy"), **kw)


def _epoch_maps(est, epochs, **fp):
    return [{est.fitParams: dict(fp, epochs=e, shuffle=False)}
            for e in epochs]


def test_fit_multiple_parallel_mesh_slices_match_sequential(
        files, eight_slots, slice_log):
    """parallelism=4 over eight slots: four slices of two, one thread each;
    every map's losses and weights are the sequential whole-mesh fits'
    and JAX's fan-out's."""
    cols = _columns(files)
    est_seq = ImageFileEstimator(modelFunction=_tiny_mf(), **_est_kw(
        fitParams={"epochs": 2, "shuffle": False}, parallelism=1))
    seq = est_seq.fit(DataFrame(cols), _epoch_maps(est_seq, (1, 2, 3, 4)))
    assert [s for s, _ in slice_log] == [8] * 4
    slice_log.clear()
    est_par = ImageFileEstimator(modelFunction=_tiny_mf(), **_est_kw(
        fitParams={"epochs": 2, "shuffle": False}, parallelism=4))
    par = est_par.fit(DataFrame(cols), _epoch_maps(est_par, (1, 2, 3, 4)))
    assert sorted(s for s, _ in slice_log) == [2] * 4
    assert len({t for _, t in slice_log}) > 1
    jest = JaxEstimator(modelFunction=_tiny_jmf(), **_est_kw(
        fitParams={"epochs": 2, "shuffle": False}, parallelism=4))
    jpar = jest.fit(JaxDataFrame(cols), _epoch_maps(jest, (1, 2, 3, 4)))
    assert len(par) == 4
    for m_seq, m_par, m_jax in zip(seq, par, jpar):
        assert m_seq.trainLosses == pytest.approx(m_par.trainLosses,
                                                  rel=1e-4)
        np.testing.assert_allclose(m_par.trainLosses, m_jax.trainLosses,
                                   rtol=1e-4)
        w_par = m_par.getModelFunction().module.w.detach().numpy()
        np.testing.assert_allclose(
            m_seq.getModelFunction().module.w.detach().numpy(), w_par,
            **MAP_TOL)
        np.testing.assert_allclose(
            w_par, np.asarray(m_jax.getModelFunction().variables["w"]),
            **MAP_TOL)


def test_fit_multiple_parallel_with_train_batch_stats(files, eight_slots,
                                                      slice_log):
    """parallelism=2 with trainBatchStats: two slices of four data groups,
    whose BatchNorms meet across their threads; the same params and
    statistics as the sequential fits and as JAX's."""
    cols = _columns(files)
    jmf, _ = _bn_twins(0)

    def build(par):
        return ImageFileEstimator(modelFunction=_bn_twins(0)[1], **_est_kw(
            fitParams={"epochs": 1, "shuffle": False},
            trainBatchStats=True, parallelism=par))

    est_seq, est_par = build(1), build(2)
    seq = est_seq.fit(DataFrame(cols), _epoch_maps(est_seq, (1, 3)))
    slice_log.clear()
    par = est_par.fit(DataFrame(cols), _epoch_maps(est_par, (1, 3)))
    assert sorted(s for s, _ in slice_log) == [4, 4]
    jest = JaxEstimator(modelFunction=jmf, **_est_kw(
        fitParams={"epochs": 1, "shuffle": False}, trainBatchStats=True,
        parallelism=2))
    jpar = jest.fit(JaxDataFrame(cols), _epoch_maps(jest, (1, 3)))
    assert len(par) == 2
    for m_seq, m_par, m_jax in zip(seq, par, jpar):
        assert m_seq.trainLosses == pytest.approx(m_par.trainLosses,
                                                  rel=1e-4)
        np.testing.assert_allclose(m_par.trainLosses, m_jax.trainLosses,
                                   rtol=1e-4)
        vs, vp = (m.getModelFunction().module.state_dict()
                  for m in (m_seq, m_par))
        vj = _bn_state_dict(jax.tree_util.tree_map(
            np.asarray, m_jax.getModelFunction().variables))
        for k in ("bn.running_mean", "bn.running_var", "head.weight"):
            np.testing.assert_allclose(vs[k].numpy(), vp[k].numpy(),
                                       **MAP_TOL, err_msg=k)
            np.testing.assert_allclose(vp[k].numpy(), vj[k].numpy(),
                                       **MAP_TOL, err_msg=k)


def test_fit_multiple_parallel_checkpoint_dirs(files, eight_slots, tmp_path):
    """parallelism=2 with a shared checkpoint_dir: the concurrent maps
    write their own subdirectories and match the sequential fit."""
    cols = _columns(files)
    out = {}
    for par in (2, 1):
        ck = str(tmp_path / f"ck_{par}")
        est = ImageFileEstimator(modelFunction=_tiny_mf(), **_est_kw(
            fitParams={"epochs": 1, "checkpoint_dir": ck, "shuffle": False},
            parallelism=par))
        out[par] = est.fit(DataFrame(cols), _epoch_maps(
            est, (1, 2), checkpoint_dir=ck))
        assert sorted(os.listdir(ck)) == ["map_000", "map_001"]
        assert os.path.isdir(os.path.join(ck, "map_000", "epoch_000001"))
        assert os.path.isdir(os.path.join(ck, "map_001", "epoch_000002"))
    for m_seq, m_par in zip(out[1], out[2]):
        assert len(m_seq.trainLosses) == len(m_par.trainLosses)
        np.testing.assert_allclose(
            m_seq.getModelFunction().module.w.detach().numpy(),
            m_par.getModelFunction().module.w.detach().numpy(), **MAP_TOL)


def test_cross_validator_parallelism_matches_sequential(files, eight_slots,
                                                        slice_log):
    """CrossValidator(parallelism=2) hands the fan-out to the estimator:
    its folds' maps fit on two slices of four, and the metrics and the
    selected model are the sequential run's and JAX's."""
    cols = dict(_columns(files))
    cols["label"] = [i % 2 for i in range(len(files))]

    def build(par, jax_side=False):
        kw = _est_kw(outputCol="prediction",
                     loss="sparse_categorical_crossentropy",
                     fitParams={"epochs": 1, "shuffle": False})
        if jax_side:
            est = JaxEstimator(modelFunction=_tiny_jmf(), **kw)
            ev = JaxEvaluator(labelCol="label", predictionCol="prediction")
            cv = JaxCV
        else:
            est = ImageFileEstimator(modelFunction=_tiny_mf(), **kw)
            ev = MulticlassClassificationEvaluator(
                labelCol="label", predictionCol="prediction")
            cv = CrossValidator
        maps = [{est.batchSize: 8}, {est.batchSize: 12}]
        return cv(estimator=est, estimatorParamMaps=maps, evaluator=ev,
                  numFolds=2, parallelism=par)

    m_seq = build(1).fit(DataFrame(cols))
    slice_log.clear()
    m_par = build(2).fit(DataFrame(cols))
    assert 4 in {s for s, _ in slice_log}
    m_jax = build(2, jax_side=True).fit(JaxDataFrame(cols))
    np.testing.assert_allclose(m_seq.avgMetrics, m_par.avgMetrics, rtol=1e-6)
    np.testing.assert_allclose(m_par.avgMetrics, m_jax.avgMetrics, rtol=1e-6)
    a = m_seq.bestModel.transform(DataFrame(cols)).collect()
    b = m_par.bestModel.transform(DataFrame(cols)).collect()
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(ra["prediction"], rb["prediction"])


def test_group_sums_hold_under_thread_switching():
    """``GroupSums`` with more groups than cores and a short switch
    interval: every group of every round gets the sum of that round's
    parts, in group order, and a group that raises breaks the rendezvous
    for the others instead of leaving them waiting."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from sparkdl_tpu_torch.models.layers import GroupSums

    groups, rounds = max(8, 2 * (os.cpu_count() or 1)), 20
    sums = GroupSums(groups)
    want = [sum(float(g * 100 + r) for g in range(groups))
            for r in range(rounds)]

    def run(g):
        return [float(sums.all_sum(g, torch.tensor([g * 100.0 + r])))
                for r in range(rounds)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(groups) as ex:
            futures = [ex.submit(run, g) for g in range(groups)]
            got = [f.result(timeout=60) for f in futures]
        broken = GroupSums(2)

        def fail_or_wait(g):
            if g == 0:
                broken.abort()
                raise RuntimeError("group 0 failed")
            return broken.all_sum(g, torch.zeros(1))

        with ThreadPoolExecutor(2) as ex:
            futures = [ex.submit(fail_or_wait, g) for g in range(2)]
            with pytest.raises(RuntimeError, match="group 0"):
                futures[0].result(timeout=60)
            with pytest.raises(threading.BrokenBarrierError):
                futures[1].result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert all(row == want for row in got)
