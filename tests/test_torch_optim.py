"""The port's optimizer names (``param/converters.py``) held against optax
on the CPU: each name's optimizer, with the defaults the JAX package's
name table gives it (optax's), takes the same steps as optax on the same
gradients; and ``toOptimizer`` accepts and refuses what the JAX
package's does.
"""

import functools

import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.param.converters import \
    SparkDLTypeConverters as JaxConverters
from sparkdl_tpu_torch.param.converters import (NamedOptimizer,
                                                SparkDLTypeConverters)
from sparkdl_tpu_torch.parallel import train

NAMES = ["adam", "adamw", "sgd", "rmsprop", "adagrad", "lamb", "lion"]
STEPS = 6
# f32 on both sides, each update's terms summed in another order; lion's
# update is a sign, so it is equal but for the weight decay's rounding
TOL = dict(rtol=2e-6, atol=2e-7)


def _trees(seed):
    """Two parameters (a matrix and a vector) and STEPS gradients for each,
    gradients of assorted scales (some near zero) so that ε matters."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 0.1, 3).astype(np.float32)}
    grads = [{k: (rng.normal(0, 1, v.shape)
                  * 10.0 ** rng.integers(-4, 1, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("name", NAMES)
def test_named_optimizer_matches_optax(name):
    params, grads = _trees(NAMES.index(name))
    tx = JaxConverters.toOptimizer(name)
    p_jax = {k: np.asarray(v) for k, v in params.items()}
    state = tx.init(p_jax)
    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    opt = SparkDLTypeConverters.toOptimizer(name)(list(tensors.values()))
    for g in grads:
        updates, state = tx.update(g, state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(p_jax[k]), **TOL,
                                       err_msg=f"{name} {k}")


def test_named_optimizer_defaults_differ_from_torch_where_optax_does():
    """The torch defaults that optax's differ from are not the ones used:
    AdamW's weight decay, RMSprop's and Adagrad's ε placement."""
    p = [torch.zeros(2, requires_grad=True)]
    assert NamedOptimizer("adamw")(p).defaults["weight_decay"] == 1e-4
    assert NamedOptimizer("rmsprop")(p).defaults["decay"] == 0.9
    opt = NamedOptimizer("adagrad")(p)
    assert opt.defaults["initial_accumulator_value"] == 0.1
    assert opt.defaults["eps"] == 1e-7
    assert NamedOptimizer("sgd")(p).defaults["lr"] == 1e-2
    assert NamedOptimizer("lion")(p).defaults["lr"] == 1e-4


def test_to_optimizer_forms_and_refusals():
    conv = SparkDLTypeConverters.toOptimizer
    # names: case-insensitive, unknown raises as JAX's does
    assert conv("ADAM").name == "adam"
    with pytest.raises(TypeError, match="Unknown optimizer name"):
        conv("nadamw")
    with pytest.raises(TypeError, match="Unknown optimizer name"):
        JaxConverters.toOptimizer("nadamw")
    # a factory params -> Optimizer and a zero-arg factory pass through
    sgd = functools.partial(torch.optim.SGD, lr=0.5)
    assert conv(sgd) is sgd and conv(torch.optim.Adam) is torch.optim.Adam

    def zero_arg():
        return sgd

    assert conv(zero_arg) is zero_arg
    # a factory that needs more arguments raises at set time, as JAX's
    with pytest.raises(TypeError, match="requires arguments"):
        conv(lambda params, lr: torch.optim.SGD(params, lr=lr))
    with pytest.raises(TypeError, match="requires arguments"):
        JaxConverters.toOptimizer(optax.adam)
    with pytest.raises(TypeError, match="not an Optimizer"):
        conv(torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1))
    with pytest.raises(TypeError, match="Could not convert"):
        conv(3)


def test_resolve_optimizer_keeps_one_instance_per_factory():
    """A zero-argument factory is called once per process, as the JAX
    package keeps one optax transformation per factory; the default is
    optax's Adam."""
    calls = []

    def factory():
        calls.append(1)
        return functools.partial(torch.optim.SGD, lr=0.25)

    try:
        a = train._resolve_optimizer(factory)
        b = train._resolve_optimizer(factory)
    finally:
        train.clear_train_step_cache()
    assert a is b and len(calls) == 1
    assert a([torch.zeros(1, requires_grad=True)]).defaults["lr"] == 0.25
    assert train._resolve_optimizer(None).name == "adam"
    named = NamedOptimizer("sgd")
    assert train._resolve_optimizer(named) is named


@pytest.mark.parametrize("name", NAMES)
def test_named_optimizers_are_capturable_on_the_card(name):
    """Every name's step can be held by a CUDA graph: SGD keeps no host
    state, and the port's own optimizers (Adam and AdamW among them) say
    ``capturable``, with the same code on the CPU and the card."""
    opt = NamedOptimizer(name)([torch.zeros(2, requires_grad=True)])
    assert train.optimizer_capturable(opt) == (True, "")
    if name in ("adam", "adamw", "lamb"):
        opt.param_groups[0]["params"][0].grad = torch.ones(2)
        opt.step()
        (st,) = opt.state.values()
        assert st["step"].dtype == torch.float32 and st["step"].dim() == 0


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_device_step_count_survives_a_state_dict_round_trip(name):
    """Adam's and Lamb's step counts are device tensors: a run interrupted
    after three steps and resumed from its ``state_dict`` (the checkpoint
    path) takes the uninterrupted run's steps bit for bit, and both match
    optax."""
    params, grads = _trees(11)
    tx = JaxConverters.toOptimizer(name)
    p_jax = {k: np.asarray(v) for k, v in params.items()}
    state = tx.init(p_jax)
    for g in grads:
        updates, state = tx.update(g, state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)

    def run(split):
        tensors = [torch.tensor(params[k], requires_grad=True)
                   for k in ("w", "b")]
        opt = NamedOptimizer(name)(tensors)
        for i, g in enumerate(grads):
            if i == split:
                saved = opt.state_dict()
                fresh = [t.detach().clone().requires_grad_(True)
                         for t in tensors]
                opt = NamedOptimizer(name)(fresh)
                opt.load_state_dict(saved)
                tensors = fresh
            for t, k in zip(tensors, ("w", "b")):
                t.grad = torch.from_numpy(g[k].copy())
            opt.step()
        assert opt.state[tensors[0]]["step"].item() == STEPS
        return [t.detach().numpy() for t in tensors]

    whole, resumed = run(None), run(3)
    for a, b, k in zip(whole, resumed, ("w", "b")):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(p_jax[k]), **TOL)
