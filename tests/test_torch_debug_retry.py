"""The port's numerical checks (``utils/debug.py``) and fit retries
(``utils/retry.py fit_with_retries``) held against the JAX package's on the
CPU.

``check_finite`` names the bad leaves of the same trees (numpy arrays on
the JAX side, tensors and arrays on the port's) with the JAX package's
message; the epoch-boundary loss check raises JAX's message; anomaly mode
(the port's counterpart of ``jax_debug_nans``) is turned off by
``disable_checks`` only when this module turned it on; ``fit_with_retries``
restarts a fit whose loading failed and resumes one preempted mid-training
from its checkpoint, to the uninterrupted fit's parameters and to JAX's
``fit_with_retries`` run.
"""

import collections

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.estimators import ImageFileEstimator as JaxEstimator
from sparkdl_tpu.frame import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.parallel import train as jtrain
from sparkdl_tpu.utils import debug as jdebug
from sparkdl_tpu.utils import retry as jretry
from sparkdl_tpu_torch.estimators import ImageFileEstimator
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.parallel import train
from sparkdl_tpu_torch.utils import debug, retry
from tests.test_torch_image_file_estimator import (  # noqa: F401 fixture
    LOSS_TOL, TENSOR_TOL, _columns, files, load8)
from tests.test_torch_stream_fit import CrashAfterEpochs

NT = collections.namedtuple("NT", "a b")


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _checks_off(monkeypatch):
    """Each test starts and ends with checks and anomaly mode off."""
    monkeypatch.delenv("SPARKDL_DEBUG_NANS", raising=False)
    debug.disable_checks()
    jdebug._ENABLED = False
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(False)
    yield
    debug.disable_checks()
    jdebug._ENABLED = False
    torch.autograd.set_detect_anomaly(anomaly)


def _nan(*shape):
    return np.full(shape or (1,), np.nan, np.float32)


TREES = {
    "nested-dicts": {"a": np.array([1.0, np.nan]),
                     "b": {"c": np.array([np.inf]), "d": np.arange(3)}},
    "lists-tuples": [np.ones(2), (_nan(), {"x": np.array([-np.inf])})],
    "root": _nan(2),
    "namedtuple": NT(_nan(), np.ones(1)),
    "more-than-five": {f"k{i}": _nan() for i in range(7)},
    "none-leaf": {"k": [None, _nan()]},
}


def _as_torch(tree):
    """The tree with every numpy leaf as a tensor (namedtuples kept)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_as_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.asarray(tree))


def _message(fn, tree):
    with pytest.raises(FloatingPointError) as ei:
        fn(tree, "params")
    return str(ei.value)


@pytest.mark.parametrize("leaves", ["numpy", "tensors"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_check_finite_messages_equal_jax(name, leaves):
    tree = TREES[name]
    want = _message(jdebug.check_finite, tree)
    got = _message(debug.check_finite,
                   tree if leaves == "numpy" else _as_torch(tree))
    assert got == want
    assert got.startswith("non-finite params: ")


def test_check_finite_passes_finite_and_integer_leaves():
    debug.check_finite({"a": np.ones(3), "b": {"c": np.zeros(2)}})
    debug.check_finite({"i": np.asarray([1, 2, 3]),
                        "t": torch.arange(4),
                        "h": torch.ones(2, dtype=torch.bfloat16),
                        "f": 1.5})
    with pytest.raises(FloatingPointError, match=r"\['h'\]"):
        debug.check_finite({"h": torch.tensor([np.inf],
                                              dtype=torch.bfloat16)})
    with pytest.raises(FloatingPointError, match="non-finite value"):
        debug.check_finite([torch.tensor([1.0, float("nan")])])


def test_checks_enabled_env_and_api(monkeypatch):
    assert not debug.checks_enabled()
    for value, on in (("1", True), ("0", False), ("false", False),
                      ("yes", True)):
        monkeypatch.setenv("SPARKDL_DEBUG_NANS", value)
        assert debug.checks_enabled() is on
    monkeypatch.delenv("SPARKDL_DEBUG_NANS")
    debug.enable_checks(nan_debug=False)
    assert debug.checks_enabled() and not torch.is_anomaly_enabled()
    debug.disable_checks()
    assert not debug.checks_enabled()


def test_anomaly_mode_ownership():
    """enable_checks() turns anomaly mode on and disable_checks() turns it
    off; a user's own anomaly mode survives disable_checks()."""
    debug.enable_checks()
    assert debug.checks_enabled() and torch.is_anomaly_enabled()
    debug.disable_checks()
    assert not torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)   # the user's own
    debug.enable_checks()
    debug.disable_checks()
    assert torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(False)
    debug.enable_nan_checks()
    assert torch.is_anomaly_enabled()
    debug.disable_checks()
    assert not torch.is_anomaly_enabled()


def test_nan_checks_localise_a_backward_nan():
    """Anomaly mode names the backward op that produced a NaN (what
    ``jax_debug_nans`` does for the forward): the documented counterpart."""
    w = torch.tensor([0.0], requires_grad=True)
    loss = torch.sqrt(w).sum()
    loss.backward()                       # no check: a silent inf/nan grad
    assert not torch.isfinite(w.grad).all()
    debug.enable_nan_checks()
    w.grad = None
    with pytest.raises(RuntimeError, match="returned nan"):
        (torch.sqrt(w) * 0.0).sum().backward()


def test_nonfinite_loss_message_equals_jax():
    for mod in (debug, jdebug):
        mod.enable_checks(nan_debug=False)
    msgs = []
    for mod in (debug, jdebug):
        with pytest.raises(FloatingPointError) as ei:
            mod.warn_or_raise_nonfinite_loss([0.5, float("nan"), 1.0], 2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].endswith("; utils.debug.enable_nan_checks() localizes "
                            "the producing op")
    debug.disable_checks()
    jdebug.disable_checks()
    debug.warn_or_raise_nonfinite_loss([float("inf")], 0)  # warns only


def test_nonfinite_loss_fails_fast_when_enabled(rng):
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(16, 1)).astype(np.float32)

    def predict(p, xb):
        return xb @ p["w"] / torch.sum(p["w"]) * float("nan")

    debug.enable_checks(nan_debug=False)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train.fit_data_parallel(
            predict, {"w": np.ones((4, 1), np.float32)}, x, y,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1), loss="mse",
            batch_size=8, epochs=2)
    debug.disable_checks()
    _, losses = train.fit_data_parallel(   # warns, does not raise
        predict, {"w": np.ones((4, 1), np.float32)}, x, y,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1), loss="mse",
        batch_size=8, epochs=1)
    assert not np.isfinite(losses).any()


# -- fit_with_retries ----------------------------------------------------------

class Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(np.array(w)))


def _plin(m, x):
    return x.reshape(x.shape[0], -1) @ m.w


def _jlin(v, x):
    import jax.numpy as jnp

    return jnp.asarray(x).reshape(x.shape[0], -1) @ v["w"]


def _jmatmul(p, xb):
    import jax.numpy as jnp

    return jnp.asarray(xb) @ p["w"]


def _flaky(fails):
    def loader(uri):
        if fails["left"] > 0 and uri.endswith("img_02.png"):
            fails["left"] -= 1
            raise OSError("simulated flaky storage")
        return load8(uri)

    return loader


def test_fit_with_retries_restarts_on_load_failure(files):
    """A transient failure while loading (before any epoch trains) is
    retried from scratch: the fitted weights equal an uninterrupted fit's
    and JAX's fit_with_retries run's."""
    w0 = np.random.default_rng(0).normal(0, 0.01, (192, 2)).astype(
        np.float32)
    kw = dict(inputCol="uri", outputCol="preds", labelCol="label",
              optimizer="sgd", loss="mse", fitParams={"epochs": 3},
              batchSize=8)
    fails = {"left": 1}
    retried = []
    est = ImageFileEstimator(modelFunction=ModelFunction(
        fn=_plin, module=Linear(w0)), imageLoader=_flaky(fails), **kw)
    model = retry.fit_with_retries(
        est, DataFrame(_columns(files)), max_retries=2,
        on_retry=lambda i, e: retried.append(type(e).__name__))
    assert fails["left"] == 0 and retried == ["OSError"]
    assert len(model.trainLosses) == 3
    clean = ImageFileEstimator(modelFunction=ModelFunction(
        fn=_plin, module=Linear(w0)), imageLoader=load8, **kw).fit(
        DataFrame(_columns(files)))
    got = model.getModelFunction().module.w.detach().numpy()
    np.testing.assert_array_equal(
        got, clean.getModelFunction().module.w.detach().numpy())
    jfails = {"left": 1}
    jest = JaxEstimator(modelFunction=JaxModelFunction(
        fn=_jlin, variables={"w": w0}), imageLoader=_flaky(jfails), **kw)
    jm = jretry.fit_with_retries(jest, JaxDataFrame(_columns(files)),
                                 max_retries=2)
    assert jfails["left"] == 0
    np.testing.assert_allclose(model.trainLosses, jm.trainLosses,
                               **LOSS_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jm.getModelFunction().variables["w"]), **TENSOR_TOL)


def test_fit_with_retries_resumes_mid_training_from_checkpoint(tmp_path,
                                                               rng):
    """A fit that dies mid-training (at the end of epoch 2 of 4, before
    that epoch's checkpoint) is retried and resumes after epoch 1: it
    trains the remaining three epochs, to the uninterrupted fit's weights
    and to JAX's fit_with_retries run of the same fit."""
    import optax

    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = x @ rng.normal(size=(4, 1)).astype(np.float32)
    kw = dict(loss="mse", batch_size=8, epochs=4, seed=3)

    def fitter(fit, predict, opt, ck):
        attempts = []

        class Est:
            def fit(self, dataset, params=None):
                crash = 2 if not attempts else None
                attempts.append(crash)
                return fit(predict, {"w": np.zeros((4, 1), np.float32)},
                           x, y, optimizer=opt, checkpoint_dir=ck,
                           metrics=CrashAfterEpochs(crash), **kw)

        return Est(), attempts

    est, attempts = fitter(
        train.fit_data_parallel, lambda p, xb: xb @ p["w"],
        lambda ps: torch.optim.SGD(ps, lr=0.05), str(tmp_path / "port"))
    fitted, losses = retry.fit_with_retries(est, None, max_retries=1)
    assert attempts == [2, None] and len(losses) == 3
    full, full_losses = train.fit_data_parallel(
        lambda p, xb: xb @ p["w"], {"w": np.zeros((4, 1), np.float32)}, x,
        y, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05), **kw)
    np.testing.assert_allclose(fitted["w"], full["w"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses, full_losses[1:], rtol=1e-5)
    jest, jattempts = fitter(
        jtrain.fit_data_parallel,
        _jmatmul,
        optax.sgd(0.05), str(tmp_path / "jax"))
    jfitted, jlosses = jretry.fit_with_retries(jest, None, max_retries=1)
    assert jattempts == [2, None]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fitted["w"], np.asarray(jfitted["w"]),
                               rtol=1e-5, atol=1e-6)


def test_fit_with_retries_deterministic_failures_not_retried():
    calls = []

    class Est:
        def fit(self, dataset, params=None):
            calls.append(1)
            raise ValueError("requires params")

    with pytest.raises(ValueError, match="requires params"):
        retry.fit_with_retries(Est(), None, max_retries=3)
    assert calls == [1]

    class Flaky:
        def fit(self, dataset, params=None):
            calls.append(2)
            raise RuntimeError("preempted")

    with pytest.raises(RuntimeError, match="preempted"):
        retry.fit_with_retries(Flaky(), None, max_retries=2)
    assert calls == [1, 2, 2, 2]
