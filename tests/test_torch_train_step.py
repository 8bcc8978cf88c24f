"""The port's step API and step modes (``parallel/train.py``) on the CPU.

The step API takes ``mesh=``, ``param_specs=`` and ``params_template=`` as
JAX's does (``resolve_param_specs`` held to JAX's on the same rules;
``resolve_opt_state_shardings`` gives moments their param's layout and
counters the replicated one); a step with statistics writes them INTO the
given tensors (what a captured step needs); a step in a group of W ranks
divides the all-reduced gradients and loss by W; the mode a fit's steps
run in is chosen up front and reported in its ``Metrics`` (eager on the
CPU, and on the card under anomaly mode, with an optimizer that cannot
be captured, a CPU generator, batch statistics in a group, or too few
steps to pay for a capture).  The captured step itself
runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as JP

import sparkdl_tpu_torch
from sparkdl_tpu.parallel import mesh as jmesh
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu_torch.parallel import distributed, mesh, train
from sparkdl_tpu_torch.param.converters import NamedOptimizer
from sparkdl_tpu_torch.utils.metrics import Metrics

CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = (np.arange(n) % 3).astype(np.int64)
    w = rng.normal(0, 0.1, (5, 3)).astype(np.float32)
    return x, y, w


def _predict(p, xb):
    return xb @ p["w"]


@pytest.mark.parametrize("spe", [1, 3])
def test_cpu_fit_reports_the_eager_step_mode(spe):
    x, y, w = _data()
    m = Metrics()
    _, losses = train.fit_data_parallel(
        _predict, {"w": w}, x, y, loss=train.softmax_cross_entropy,
        batch_size=8, epochs=2, steps_per_execution=spe, metrics=m)
    steps = 2 * 3  # 20 rows, batch 8, two epochs
    assert m.counters["train.step_mode.eager"] == 1
    assert "train.step_mode.captured" not in m.counters
    assert "train.captures" not in m.counters
    assert m.counters["train.steps"] == steps
    assert m.counters["train.loss_fetches"] == 2 * -(-3 // spe)
    assert m.gauges["train.host_us_per_step"] > 0
    assert len(losses) == 2


class _Plain(torch.optim.Optimizer):
    """A user's optimizer that says nothing about capture."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        pass


@pytest.mark.parametrize("make, want", [
    (lambda p: torch.optim.SGD(p, lr=0.1), ("captured", "")),
    (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9), ("captured", "")),
    (NamedOptimizer("rmsprop"), ("captured", "")),
    (NamedOptimizer("lamb"), ("captured", "")),
    (NamedOptimizer("lion"), ("captured", "")),
    (NamedOptimizer("adagrad"), ("captured", "")),
    (lambda p: torch.optim.Adam(p, capturable=False),
     ("eager", "Adam was built with capturable=False")),
    (lambda p: _Plain(p), ("eager", "_Plain is not known to be capturable")),
])
def test_step_mode_is_chosen_up_front(make, want, monkeypatch):
    """On the card a fit captures unless its optimizer cannot be captured;
    the CPU is always eager.  In a group: two graphs a step around the
    host all-reduce, eager with batch statistics."""
    opt = make([torch.zeros(2, requires_grad=True)])
    assert train.step_mode(torch.device("cpu"), opt, False)[0] == "eager"
    assert train.step_mode(CUDA, opt, False) == want
    if want[0] == "captured":
        gen = torch.Generator()
        mode, why = train.step_mode(CUDA, opt, False, [gen])
        assert mode == "eager" and "CPU torch.Generator" in why
        monkeypatch.setattr(train.distributed, "process_count", lambda: 2)
        assert train.step_mode(CUDA, opt, False) == ("split", "")
        mode, why = train.step_mode(CUDA, opt, True)
        assert mode == "eager" and "batch statistics" in why


@pytest.mark.parametrize("steps, epochs, spe, plan", [
    (3, 4, 1, (11, 1)),   # the warm-up, then one graph replayed 11 times
    (3, 2, 1, (5, 1)),
    (5, 3, 4, (14, 5)),   # warm-up, 4 | 4, 1 | 4, 1: graphs of 4 and 1
    (3, 17, 3, (50, 5)),  # warm-up, 2 | 3 | 3 ...: graphs of 2 and 3
    (4, 1, 2, (3, 3)),    # warm-up, 2, 1
    (1, 1, 1, (0, 0)),    # the warm-up only: nothing to capture
])
def test_capture_plan_counts_replays_and_captured_steps(steps, epochs, spe,
                                                        plan):
    """(steps replayed, steps captured): the fit's first step is its
    eager warm-up, then each epoch's groups of ``spe`` and ragged tail,
    one graph per distinct length."""
    assert train.capture_plan(steps, epochs, spe) == plan


@pytest.mark.parametrize("fit_steps, spe, group, want", [
    ((3, 4), 1, False, "captured"),
    ((3, 2), 1, False, "eager"),    # 5 replays of one captured step
    ((3, 17), 3, False, "captured"),
    ((3, 16), 3, False, "eager"),   # 47 replays of 5 captured steps
    ((3, 4), 3, True, "split"),     # a group captures one step
    ((3, 2), 1, True, "eager"),
    (None, 1, False, "captured"),   # a stream of unknown length
])
def test_short_fits_run_eagerly(fit_steps, spe, group, want, monkeypatch):
    """A fit whose known step count would replay each captured step fewer
    than BREAK_EVEN_REPLAYS times keeps its steps eager, and says why."""
    if group:
        monkeypatch.setattr(train.distributed, "process_count", lambda: 2)
    opt = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
    mode, why = train.step_mode(CUDA, opt, False, (), fit_steps, spe)
    assert mode == want
    if want == "eager":
        assert why.startswith(f"a fit of {fit_steps[0] * fit_steps[1]} "
                              f"steps") and "replay" in why
    else:
        assert why == ""


def test_anomaly_mode_keeps_the_steps_eager():
    """Autograd anomaly mode (``utils.debug.enable_nan_checks``) checks
    every backward output on the host, which a capture cannot hold: the
    steps stay eager and the reason names it."""
    opt = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
    with torch.autograd.set_detect_anomaly(True):
        mode, why = train.step_mode(CUDA, opt, False, (), (3, 40), 1)
    assert mode == "eager" and "anomaly mode" in why
    assert train.step_mode(CUDA, opt, False, (), (3, 40), 1) == \
        ("captured", "")


def test_fit_on_the_cpu_asked_for_by_argument(monkeypatch):
    """``device="cpu"`` with no default device set and no card: the fit's
    default mesh is that device, so it runs (the device rule)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, w = _data()
    with sparkdl_tpu_torch.default_device(None):
        _, losses = train.fit_data_parallel(
            _predict, {"w": w}, x, y, loss=train.softmax_cross_entropy,
            batch_size=8, epochs=1, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.fit_data_parallel(
                _predict, {"w": w}, x, y, loss=train.softmax_cross_entropy,
                batch_size=8, epochs=1)
    assert len(losses) == 1 and np.isfinite(losses).all()


def test_resolve_param_specs_equal_jax():
    """A rule ``(path, leaf) -> spec`` and a spec tree resolve to the
    shardings JAX's resolve to, on the same paths."""
    params = {"body": np.zeros((4, 4), np.float32),
              "head": {"kernel": np.zeros((4, 8), np.float32),
                       "bias": np.zeros(8, np.float32)}}

    def rule(P):
        def fn(path, leaf):
            if path.endswith("head/kernel"):
                return P(None, "model")
            return P()
        return fn

    pm = mesh.get_mesh(devices=["cpu"] * 4, model_parallel=2)
    jm = jmesh.get_mesh(num_devices=4, model_parallel=2)
    got = train.resolve_param_specs(rule(mesh.P), params, pm)
    want = jtrain.resolve_param_specs(rule(JP), params, jm)
    assert tuple(got["head"]["kernel"].spec) == \
        tuple(want["head"]["kernel"].spec) == (None, "model")
    assert tuple(got["body"].spec) == tuple(want["body"].spec) == ()
    tree = {"body": mesh.P(), "head": {"kernel": mesh.P(None, "model"),
                                       "bias": mesh.P("model")}}
    got = train.resolve_param_specs(tree, params, pm)
    assert got["head"]["bias"].spec == mesh.P("model")
    assert got["head"]["bias"].mesh is pm


def test_step_records_its_mesh_and_optimizer_layout():
    """A step's default mesh is its params' device; after a step, Adam's
    moments inherit their param's sharding and its counters replicate."""
    _, _, w = _data()
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.zeros(3, requires_grad=True)
    params = {"b": bt, "w": wt}
    opt = torch.optim.Adam([bt, wt], lr=0.01)
    specs = {"b": mesh.P(None), "w": mesh.P(None, "model")}
    step = train.make_train_step(
        lambda p, xb: xb @ p["w"] + p["b"], train.softmax_cross_entropy,
        opt, params, param_specs=specs)
    assert step.mesh.shape == {"data": 1, "model": 1}
    assert step.opt_state_shardings() == {}  # no state before a step
    x, y, _ = _data()
    step(torch.from_numpy(x[:8]), torch.from_numpy(y[:8]))
    sh = step.opt_state_shardings()
    assert sh[1]["exp_avg"].spec == mesh.P(None, "model")
    assert sh[1]["exp_avg_sq"] is step.param_shardings["w"]
    assert sh[0]["step"] is step.replicated


def test_stats_step_updates_the_given_tensors_in_place():
    """The statistics tensors the step was given are the ones updated
    (a captured step writes static tensors), even when ``train_fn`` hands
    back new tensors."""
    x, y, w = _data()
    wt = torch.tensor(w, requires_grad=True)
    mean = torch.zeros(3)
    stats = {"batch_stats": {"mean": mean}}

    def train_fn(v, xb):
        pred = xb @ v["params"]["w"]
        new = 0.9 * v["batch_stats"]["mean"] + 0.1 * pred.mean(0).detach()
        return pred, {"mean": new}

    step = train.make_train_step_with_stats(
        train_fn, train.softmax_cross_entropy,
        torch.optim.SGD([wt], lr=0.1), {"w": wt}, stats)
    step(torch.from_numpy(x[:8]), torch.from_numpy(y[:8]))
    assert stats["batch_stats"]["mean"] is mean
    assert mean.abs().sum() > 0


def test_group_step_divides_the_reduced_buffer_by_the_group():
    """``pack`` lays the gradients and the loss into one flat buffer (the
    all-reduce's), ``unpack`` divides it by the size of the group it is
    reduced over (the column group: every rank where each data row lies
    within one rank) and writes it back: with the sum standing in for the
    all-reduce of two equal ranks the update is one rank's."""
    x, y, w = _data()
    ref = torch.tensor(w, requires_grad=True)
    two = torch.tensor(w, requires_grad=True)
    steps = []
    for t in (ref, two):
        steps.append(train.make_train_step(
            _predict, train.softmax_cross_entropy,
            torch.optim.SGD([t], lr=0.1), {"w": t}))
    xb, yb = torch.from_numpy(x[:8]), torch.from_numpy(y[:8])
    lref = steps[0](xb, yb)
    step = steps[1]
    step.columns = distributed.RankGroup([0, 1])
    lval = step.forward_backward(xb, yb)
    flat = step.pack(lval)
    assert flat.numel() == w.size + 1 and flat[-1] == lval
    flat.mul_(2)  # two ranks of the same batch, summed
    assert step.unpack() == lref
    step.optimizer.step()
    np.testing.assert_array_equal(two.detach().numpy(), ref.detach().numpy())


def test_clear_train_step_cache_drops_kept_optimizers():
    def factory():
        return lambda ps: torch.optim.SGD(ps, lr=0.1)

    first = train._resolve_optimizer(factory)
    assert train._resolve_optimizer(factory) is first
    train.clear_train_step_cache()
    assert train._resolve_optimizer(factory) is not first
