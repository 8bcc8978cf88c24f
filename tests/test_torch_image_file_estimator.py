"""The port's image-file estimators (``estimators/image_file_estimator.py``)
held against the JAX package's on the CPU.

Sixteen real PNG files (two classes, one-hot labels) and a batch of 8:
multiples of 8, so that JAX's fit on the tests' 8-device CPU mesh draws
the same batches as the port's fit on one device.  The models:

* a small Keras CNN (Conv2D, BatchNormalization with moving statistics
  redrawn from a seed, Dropout, MaxPooling2D, GlobalAveragePooling2D,
  Dense), written by Keras here and read by each package's converter.  It
  has no BatchNorm running statistics in either package's sense, so both
  fits train every variable, the moving statistics by gradient;
* a conv + BatchNorm + dense module, flax's (``from_flax``) and its torch
  twin from the same variables (``from_module``): frozen statistics by
  default, ``trainBatchStats=True`` through each package's ``train_fn``;
* the zoo's Xception at 32x32 with its fused route forced: the
  frozen-statistics fit must take the unfused route (the fused kernels
  have no backward) and give JAX's losses.
"""

import os

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu_torch
from sparkdl_tpu.estimators import ImageFileEstimator as JaxEstimator
from sparkdl_tpu.estimators import KerasImageFileEstimator as JaxKeras
from sparkdl_tpu.frame import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu_torch.estimators import (ImageFileEstimator, ImageFileModel,
                                          KerasImageFileEstimator)
from sparkdl_tpu_torch.frame import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.keras_convert import state_dict_from_jax
from sparkdl_tpu_torch.models import layers
from sparkdl_tpu_torch.models.keras_import import read_keras
from sparkdl_tpu_torch.ops import sepconv as ops

# f32 on both sides; the loss means, the updates and the convs sum in
# another order
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
TENSOR_TOL = dict(rtol=1e-4, atol=2e-6)
N_ROWS, BATCH = 16, 8


def load8(uri):
    """Module-level, so that a fitted model holding it saves."""
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((8, 8))
    return np.asarray(img, dtype=np.float32) / 255.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(N_ROWS):
        base = np.asarray([200, 40, 40] if i % 2 else [40, 40, 200])
        img = np.clip(base + rng.normal(0, 40, (12, 12, 3)), 0, 255)
        p = str(d / f"img_{i:02d}.png")
        Image.fromarray(img.astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _columns(paths):
    return {"uri": list(paths),
            "label": [[0.0, 1.0] if i % 2 else [1.0, 0.0]
                      for i in range(len(paths))]}


@pytest.fixture(scope="module")
def keras_path(tmp_path_factory):
    import keras
    from keras import layers as kl

    keras.utils.set_random_seed(1)
    model = keras.Sequential([
        kl.Input((8, 8, 3)),
        kl.Conv2D(4, 3, padding="same", activation="relu"),
        kl.BatchNormalization(),
        kl.Dropout(0.3),
        kl.MaxPooling2D(),
        kl.GlobalAveragePooling2D(),
        kl.Dense(2, activation="softmax")])
    bn = model.layers[1]
    rng = np.random.default_rng(2)
    g, b, m, v = bn.get_weights()
    bn.set_weights([rng.uniform(0.8, 1.2, g.shape).astype(np.float32),
                    rng.normal(0, 0.1, b.shape).astype(np.float32),
                    rng.normal(0, 0.2, m.shape).astype(np.float32),
                    rng.uniform(0.5, 1.5, v.shape).astype(np.float32)])
    path = str(tmp_path_factory.mktemp("keras") / "cnn.keras")
    model.save(path)
    return path


def _keras_kw(path, **kw):
    return dict(dict(inputCol="uri", outputCol="preds", labelCol="label",
                     modelFile=path, imageLoader=load8,
                     kerasLoss="categorical_crossentropy", batchSize=BATCH),
                **kw)


def _assert_fitted_keras_equal(port_model, jax_model, tol=TENSOR_TOL):
    module = port_model.getModelFunction().module
    want = state_dict_from_jax(module, jax.tree_util.tree_map(
        np.asarray, jax_model.getModelFunction().variables))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


@pytest.mark.parametrize("opt", ["adam", "sgd", "rmsprop"])
def test_keras_fit_matches_jax(files, keras_path, opt):
    """Per-epoch losses and every fitted tensor, the moving statistics
    included: both fits train them by gradient."""
    kw = _keras_kw(keras_path, kerasOptimizer=opt,
                   kerasFitParams={"epochs": 2})
    jm = JaxKeras(**kw).fit(JaxDataFrame(_columns(files)))
    with sparkdl_tpu_torch.default_device("cpu"):
        pm = KerasImageFileEstimator(**kw).fit(DataFrame(_columns(files)))
    np.testing.assert_allclose(pm.trainLosses, jm.trainLosses, **LOSS_TOL)
    _assert_fitted_keras_equal(pm, jm)
    bn = read_keras(keras_path).layers[1]  # conv, BatchNormalization, dense
    moving_mean = bn.weights[2]
    fitted = pm.getModelFunction().module.state_dict()
    name = [k for k in fitted if k.endswith("running_mean")][0]
    assert not np.allclose(fitted[name].numpy(), moving_mean)


def test_fit_leaves_the_model_untouched(files, keras_path):
    """A fit trains copies: the estimator's converted model keeps its
    tensors, and the fitted module is a new one, in eval mode, without
    requires_grad, on the CPU; two fits from one estimator agree."""
    est = KerasImageFileEstimator(**_keras_kw(
        keras_path, kerasOptimizer="adam", kerasFitParams={"epochs": 1}))
    with sparkdl_tpu_torch.default_device("cpu"):
        mf = est.getModelFunction()
        before = {k: v.clone() for k, v in mf.module.state_dict().items()}
        a = est.fit(DataFrame(_columns(files)))
        b = est.fit(DataFrame(_columns(files)))
    assert all(torch.equal(mf.module.state_dict()[k], v)
               for k, v in before.items())
    fitted = a.getModelFunction().module
    assert fitted is not mf.module and not fitted.training
    assert not any(p.requires_grad for p in fitted.parameters())
    assert all(t.device.type == "cpu" for t in fitted.state_dict().values())
    assert a.trainLosses == b.trainLosses
    for k, v in fitted.state_dict().items():
        assert torch.equal(b.getModelFunction().module.state_dict()[k], v)
    assert a.getModelFunction().train_fn is None  # a Keras model: none


def test_keras_file_in_memory_and_transform(files, keras_path):
    """``modelFile`` may be an in-memory KerasFile (the card has no
    h5py); its fit equals the path's, and the fitted model transforms as
    JAX's does."""
    kfile = read_keras(keras_path)
    kw = _keras_kw(keras_path, kerasOptimizer="sgd",
                   kerasFitParams={"epochs": 1})
    jm = JaxKeras(**kw).fit(JaxDataFrame(_columns(files)))
    with sparkdl_tpu_torch.default_device("cpu"):
        by_path = KerasImageFileEstimator(**kw).fit(
            DataFrame(_columns(files)))
        in_memory = KerasImageFileEstimator(**dict(kw, modelFile=kfile)).fit(
            DataFrame(_columns(files)))
        out = in_memory.transform(DataFrame(_columns(files)))
    assert in_memory.trainLosses == by_path.trainLosses
    want = jm.transform(JaxDataFrame(_columns(files)))
    np.testing.assert_allclose(out.column_to_numpy("preds"),
                               want.column_to_numpy("preds"), **TENSOR_TOL)


def test_steps_per_execution_matches_jax(files, keras_path):
    """Three steps per loss fetch: the same loss series as one, and JAX's
    (which packs them into one compiled program)."""
    cols = _columns(files)
    fits = {}
    for spe in (1, 3):
        kw = _keras_kw(keras_path, kerasOptimizer="adam",
                       kerasFitParams={"epochs": 3, "steps_per_execution": spe})
        with sparkdl_tpu_torch.default_device("cpu"):
            fits[spe] = KerasImageFileEstimator(**kw).fit(DataFrame(cols))
    jm = JaxKeras(**kw).fit(JaxDataFrame(cols))
    assert fits[1].trainLosses == fits[3].trainLosses
    np.testing.assert_allclose(fits[3].trainLosses, jm.trainLosses,
                               **LOSS_TOL)
    _assert_fitted_keras_equal(fits[3], jm)


def test_fit_multiple_order_and_checkpoint_dirs(files, keras_path, tmp_path):
    """One model per map in map order, each map in its own checkpoint
    directory, the same with parallelism > 1 (one device: sequential),
    and the same losses as JAX's fitMultiple."""
    ck = str(tmp_path / "ck")
    cols = _columns(files)
    est = KerasImageFileEstimator(**_keras_kw(
        keras_path, kerasOptimizer="sgd",
        kerasFitParams={"epochs": 1, "checkpoint_dir": ck}))
    maps = [{est.fitParams: {"epochs": e, "checkpoint_dir": ck}}
            for e in (2, 1, 3)]
    with sparkdl_tpu_torch.default_device("cpu"):
        got = list(est.fitMultiple(DataFrame(cols), maps))
        est2 = est.copy({est.parallelism: 3})
        again = list(est2.fitMultiple(DataFrame(cols), [
            {est.fitParams: {"epochs": e}} for e in (2, 1, 3)]))
    assert [i for i, _ in got] == [0, 1, 2]
    assert [len(m.trainLosses) for _, m in got] == [2, 1, 3]
    assert [m.trainLosses for _, m in again] == [m.trainLosses
                                                 for _, m in got]
    assert sorted(os.listdir(ck)) == ["map_000", "map_001", "map_002"]
    assert sorted(os.listdir(os.path.join(ck, "map_002"))) == [
        f"epoch_{e:06d}" for e in (1, 2, 3)]
    jest = JaxKeras(**_keras_kw(keras_path, kerasOptimizer="sgd",
                                kerasFitParams={"epochs": 1}))
    # the JAX KerasImageFileEstimator has no parallelism default
    jest.set(jest.parallelism, 1)
    want = list(jest.fitMultiple(JaxDataFrame(cols), [
        {jest.fitParams: {"epochs": e}} for e in (2, 1, 3)]))
    for (_, p), (_, j) in zip(got, want):
        np.testing.assert_allclose(p.trainLosses, j.trainLosses, **LOSS_TOL)


def test_param_validation(files, keras_path):
    with pytest.raises(ValueError, match="requires params"):
        ImageFileEstimator(inputCol="uri", labelCol="label").fit(
            DataFrame(_columns(files)))
    with pytest.raises(ValueError, match="modelFile"):
        KerasImageFileEstimator(inputCol="uri", labelCol="label",
                                imageLoader=load8).fit(
            DataFrame(_columns(files)))
    with sparkdl_tpu_torch.default_device("cpu"):
        with pytest.raises(ValueError, match="trainBatchStats"):
            est = KerasImageFileEstimator(**_keras_kw(keras_path))
            est.set(est.trainBatchStats, True)
            est.fit(DataFrame(_columns(files)))
        with pytest.raises(ValueError, match="yielded no rows"):
            KerasImageFileEstimator(**_keras_kw(keras_path)).fit(
                lambda: iter(()))


def test_each_image_is_decoded_once_across_folds_and_maps(files, keras_path):
    calls = []

    def counting(uri):
        calls.append(uri)
        return load8(uri)

    est = KerasImageFileEstimator(**_keras_kw(
        keras_path, kerasOptimizer="sgd", kerasFitParams={"epochs": 1}))
    est._set(imageLoader=counting)
    cols = _columns(files)
    with sparkdl_tpu_torch.default_device("cpu"):
        for idx in (range(0, 8), range(8, 16), range(16)):
            sub = {k: [v[i] for i in idx] for k, v in cols.items()}
            list(est.fitMultiple(DataFrame(sub), [
                {est.fitParams: {"epochs": 1}}] * 2))
    assert sorted(calls) == sorted(files)


# -- a module with BatchNorm statistics -------------------------------------------
class TorchBNNet(torch.nn.Module):
    """The torch twin of the flax ``BNNet`` below (NHWC in)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = layers.BatchNorm(4, eps=1e-5)  # flax's default eps
        self.head = torch.nn.Linear(4, 2)

    def forward(self, x):
        y = self.bn(self.conv(x.permute(0, 3, 1, 2)))
        return torch.softmax(self.head(y.mean(dim=(2, 3))), dim=-1)


def _bn_twins(seed=0):
    from flax import linen as nn

    class BNNet(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = nn.Conv(4, (3, 3), name="conv")(x)
            x = nn.BatchNorm(use_running_average=not train, name="bn")(x)
            x = x.mean(axis=(1, 2))
            return nn.softmax(nn.Dense(2, name="head")(x))

    module = BNNet()
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, xb: module.init(r, xb, train=False))(
        jax.random.PRNGKey(seed), np.zeros((1, 8, 8, 3), np.float32)))
    rng = np.random.default_rng(seed)
    variables = {"params": dict(variables["params"]), "batch_stats": {
        "bn": {"mean": rng.normal(0, 0.1, 4).astype(np.float32),
               "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}}}
    jmf = JaxModelFunction.from_flax(module, variables,
                                     method_kwargs={"train": False})
    net = TorchBNNet()
    net.load_state_dict(_bn_state_dict(variables))
    return jmf, ModelFunction.from_module(net)


def _bn_state_dict(v):
    p, s = v["params"], v["batch_stats"]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {"conv.weight": t(p["conv"]["kernel"]).permute(3, 2, 0, 1),
            "conv.bias": t(p["conv"]["bias"]),
            "bn.weight": t(p["bn"]["scale"]), "bn.bias": t(p["bn"]["bias"]),
            "bn.running_mean": t(s["bn"]["mean"]),
            "bn.running_var": t(s["bn"]["var"]),
            "bn.num_batches_tracked": torch.tensor(0),
            "head.weight": t(p["head"]["kernel"]).t(),
            "head.bias": t(p["head"]["bias"])}


def test_batchnorm_train_fn_matches_flax(files):
    """``from_module``'s train_fn is flax's train-mode apply: the same
    predictions and updated statistics (biased variance, momentum 0.99)."""
    jmf, mf = _bn_twins(3)
    x = np.stack([load8(p) for p in files[:8]])
    want, stats = jmf.train_fn(jmf.variables, x)
    got, new = mf.train_fn(mf.module, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TENSOR_TOL)
    for ours, theirs in (("bn.running_mean", "mean"),
                         ("bn.running_var", "var")):
        np.testing.assert_allclose(new[ours].numpy(),
                                   np.asarray(stats["bn"][theirs]),
                                   **TENSOR_TOL)
    assert not mf.module.training


def test_train_fn_gives_any_batchnorm_flax_semantics():
    """A module's own ``nn.BatchNorm2d`` (torch's train mode updates
    ``running_var`` with the unbiased variance) follows flax's update under
    ``train_fn``: the biased variance, momentum 1 - 0.1, and its forward is
    its own again after the call."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    net[1].running_mean.uniform_(-0.5, 0.5)
    net[1].running_var.uniform_(0.5, 1.5)
    mean0 = net[1].running_mean.clone()
    var0 = net[1].running_var.clone()
    mf = ModelFunction.from_module(net)
    x = torch.randn(8, 3, 6, 6)
    pred, stats = mf.train_fn(net, x)
    y = net[0](x).detach()
    bm, bv = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(stats["1.running_mean"], 0.9 * mean0 + 0.1 * bm)
    torch.testing.assert_close(stats["1.running_var"], 0.9 * var0 + 0.1 * bv)
    want = (y - bm.reshape(1, -1, 1, 1)) * torch.rsqrt(
        bv.reshape(1, -1, 1, 1) + 1e-5) * net[1].weight.reshape(1, -1, 1, 1) \
        + net[1].bias.reshape(1, -1, 1, 1)
    torch.testing.assert_close(pred.detach(), want, rtol=1e-5, atol=1e-5)
    assert "forward" not in vars(net[1]) and not net.training
    assert ModelFunction.from_module(torch.nn.Linear(2, 2)).train_fn is None


@pytest.mark.parametrize("train_stats", [False, True],
                         ids=["frozen", "trainBatchStats"])
def test_batchnorm_module_fit_matches_jax(files, train_stats):
    jmf, mf = _bn_twins(0)
    kw = dict(inputCol="uri", outputCol="preds", labelCol="label",
              imageLoader=load8, optimizer="sgd", batchSize=BATCH,
              loss="categorical_crossentropy", fitParams={"epochs": 2},
              trainBatchStats=train_stats)
    jm = JaxEstimator(modelFunction=jmf, **kw).fit(
        JaxDataFrame(_columns(files)))
    with sparkdl_tpu_torch.default_device("cpu"):
        pm = ImageFileEstimator(modelFunction=mf, **kw).fit(
            DataFrame(_columns(files)))
    np.testing.assert_allclose(pm.trainLosses, jm.trainLosses, **LOSS_TOL)
    got = pm.getModelFunction().module.state_dict()
    want = _bn_state_dict(jax.tree_util.tree_map(
        np.asarray, jm.getModelFunction().variables))
    for k, v in want.items():
        if k != "bn.num_batches_tracked":
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       **TENSOR_TOL, err_msg=k)
    start = mf.module.state_dict()
    moved = not torch.equal(got["bn.running_mean"], start["bn.running_mean"])
    assert moved == train_stats
    assert pm.getModelFunction().train_fn is mf.train_fn


def test_xception_frozen_stats_fit_takes_the_unfused_route(files,
                                                           monkeypatch):
    """The zoo's Xception with its fused route forced: the fit runs the
    unfused route (no fused kernel call; the kernels have no backward) and
    gives the losses of JAX's fit of its Xception (unfused on the CPU)
    from the same variables."""
    from sparkdl_tpu.models.xception import Xception as JaxXception
    from sparkdl_tpu_torch.models import convert
    from sparkdl_tpu_torch.models.xception import Xception

    jx = JaxXception(num_classes=2)
    x0 = np.zeros((1, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(lambda r: jx.init(r, x0, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']") or key.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if "kernel" in key:
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(1 / fan), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    jmf = JaxModelFunction.from_flax(jx, variables,
                                     method_kwargs={"train": False})
    pmod = Xception(num_classes=2, fused_inference=True)
    pmod.load_state_dict(convert.state_dict_from_jax("Xception", variables))
    calls = []
    real = ops.fused_sepconv
    monkeypatch.setattr(layers, "fused_sepconv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def load32(uri):
        return load8(uri).repeat(4, 0).repeat(4, 1) * 2.0 - 1.0

    kw = dict(inputCol="uri", outputCol="preds", labelCol="label",
              imageLoader=load32, optimizer="sgd", batchSize=BATCH,
              fitParams={"epochs": 1})
    jm = JaxEstimator(modelFunction=jmf, **kw).fit(
        JaxDataFrame(_columns(files)))
    with sparkdl_tpu_torch.default_device("cpu"):
        pm = ImageFileEstimator(modelFunction=ModelFunction.from_module(
            pmod), **kw).fit(DataFrame(_columns(files)))
    assert calls == []
    np.testing.assert_allclose(pm.trainLosses, jm.trainLosses, rtol=1e-4)
    # the fitted model's inference keeps the fused route
    with torch.no_grad():
        pm.getModelFunction().module(torch.zeros(1, 32, 32, 3))
    assert len(calls) == 34


# -- persistence -----------------------------------------------------------------
@pytest.mark.parametrize("source", ["path", "KerasFile", "module"])
def test_fitted_model_save_load_transforms_bit_for_bit(files, keras_path,
                                                       tmp_path, source):
    cols = _columns(files)
    with sparkdl_tpu_torch.default_device("cpu"):
        if source == "module":
            _, mf = _bn_twins(1)
            est = ImageFileEstimator(
                inputCol="uri", outputCol="preds", labelCol="label",
                modelFunction=mf, imageLoader=load8, optimizer="sgd",
                batchSize=BATCH)
        else:
            model_file = (keras_path if source == "path"
                          else read_keras(keras_path))
            est = KerasImageFileEstimator(**_keras_kw(
                model_file, kerasOptimizer="adam"))
        model = est.fit(DataFrame(cols))
        before = model.transform(DataFrame(cols)).column_to_numpy("preds")
        model.save(str(tmp_path / "m"))
        back = ImageFileModel.load(str(tmp_path / "m"))
        after = back.transform(DataFrame(cols)).column_to_numpy("preds")
    np.testing.assert_array_equal(after, before)
    assert back.trainLosses == model.trainLosses
    assert (back.modelFile == keras_path) == (source == "path")
    if source == "module":
        # the train_fn survives (a module-level class pickles)
        assert type(back.getModelFunction().train_fn).__name__ == \
            "_TrainApply"
