"""The port's MobileNetV2 (sparkdl_tpu_torch/models/mobilenet.py) held against
the JAX package's on the CPU, from the same variables, and the registry and
stage plumbing around it.

JAX ``MobileNetV2(num_classes=5)`` is initialised at 96x96, its BatchNorm
variables are redrawn from a numpy seed (so the BN mapping and the folds
are not identities), and the tree goes through ``state_dict_from_jax`` into
the port.  Both run the same seeded batch of 2 on the unfused route and on
the fused route (on the CPU both packages route the fused tails to their
kernel's plain version).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu_torch
import sparkdl_tpu.transformers.named_image as jax_ni
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu.image.io import readImages as jax_readImages
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.models.mobilenet import MobileNetV2 as JaxMobileNetV2
from sparkdl_tpu_torch.image.io import readImages
from sparkdl_tpu_torch.models import (convert, get_model_spec,
                                      model_variant_key)
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2

SIZE = 96
# f32 on both sides, sums in another order: 1e-3 covers the accumulated
# rounding of ~50 conv layers.
UNFUSED_TOL = dict(rtol=1e-3, atol=1e-3)
# Both fused routes round each tail's clamped depthwise and its output to
# bf16 at the same points; a value near a rounding boundary can land one
# bf16 step apart on the two sides and the step travels down the network.
FUSED_TOL = dict(rtol=2e-2, atol=2e-2)
# fused vs unfused: the JAX package's own bar (tests/test_ops_sepconv.py)
ROUTE_TOL = dict(rtol=5e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jax_setup():
    rng = np.random.default_rng(21)
    x = (rng.random((2, SIZE, SIZE, 3)) * 2 - 1).astype(np.float32)
    model = JaxMobileNetV2(num_classes=5, fused_inference=False)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda r, a: model.init(r, a, train=False))(
            jax.random.PRNGKey(0), x))
    params = {k: dict(v) for k, v in variables["params"].items()}
    stats = {k: dict(v) for k, v in variables["batch_stats"].items()}
    for name in stats:
        f = stats[name]["mean"].shape[0]
        params[name]["scale"] = rng.uniform(0.8, 1.2, f).astype(np.float32)
        params[name]["bias"] = rng.normal(0, 0.05, f).astype(np.float32)
        stats[name]["mean"] = rng.normal(0, 0.05, f).astype(np.float32)
        stats[name]["var"] = rng.uniform(0.8, 1.2, f).astype(np.float32)
    return x, {"params": params, "batch_stats": stats}


def _port(variables, fused, num_classes=5):
    m = MobileNetV2(num_classes=num_classes, fused_inference=fused)
    m.load_state_dict(convert.state_dict_from_jax("MobileNetV2", variables))
    return m.eval()


@pytest.mark.parametrize("fused,tol", [(False, UNFUSED_TOL),
                                       (True, FUSED_TOL)])
def test_features_and_logits_match_jax(jax_setup, fused, tol):
    x, variables = jax_setup
    jm = JaxMobileNetV2(num_classes=5, fused_inference=fused)
    pm = _port(variables, fused)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        feats = pm(xt, features=True)
        logits = pm(xt, logits=True)
        probs = pm(xt)
    want_f = np.asarray(jm.apply(variables, x, train=False, features=True))
    want_l = np.asarray(jm.apply(variables, x, train=False, logits=True))
    assert feats.shape == (2, 1280) and logits.shape == (2, 5)
    # the head (Conv_1 + BN) is plain on both routes: f32 out, as in JAX
    assert want_f.dtype == np.float32 and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), want_f, **tol)
    np.testing.assert_allclose(logits.numpy(), want_l, **tol)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_fused_matches_unfused_and_counts_tails(jax_setup, monkeypatch):
    """The port's two routes agree from the same parameters; the fused
    route sends the 13 stride-1 tails through ``fused_mbconv``, with the
    expanded widths the kernel sees; train mode takes the plain route."""
    import sparkdl_tpu_torch.models.mobilenet as mn

    x, variables = jax_setup
    pm = _port(variables, True)
    calls = []
    real = mn.fused_mbconv

    def counting(y, kd, kp, bd, bp):
        calls.append((tuple(y.shape[1:]), kp.shape[-1]))
        return real(y, kd, kp, bd, bp)

    monkeypatch.setattr(mn, "fused_mbconv", counting)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        fused = pm(xt, features=True).numpy()
        pm.fused_inference = False
        plain = pm(xt, features=True).numpy()
        pm.fused_inference = True
        pm.train()
        pm(xt, features=True)
    np.testing.assert_allclose(fused, plain, **ROUTE_TOL)
    assert len(calls) == 13
    # at 96x96: block0 at 48x48 (C=32, F=16), the last tail at 3x3 (960->320)
    assert calls[0] == ((48, 48, 32), 16) and calls[-1] == ((3, 3, 960), 320)


def _other_variables(variables, seed):
    """``variables`` with every leaf redrawn from a numpy seed (BatchNorm
    variances kept positive)."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        if "var" in jax.tree_util.keystr(path):
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        return (leaf + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


def test_fused_route_folds_once_per_weights_version(jax_setup, monkeypatch):
    """The BatchNorm folds run on the first fused forward only: a second
    forward calls ``fold_bn_into_conv`` zero times and gives bit-identical
    outputs, equal to a fresh model's (the uncached route)."""
    import sparkdl_tpu_torch.models.mobilenet as mn

    x, variables = jax_setup
    pm = _port(variables, True)
    folds = []
    real = mn.fold_bn_into_conv

    def counting(*a):
        folds.append(1)
        return real(*a)

    monkeypatch.setattr(mn, "fold_bn_into_conv", counting)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        first = pm(xt, features=True)
        n_first = len(folds)
        second = pm(xt, features=True)
        fresh = _port(variables, True)(xt, features=True)
    # 13 blocks fold their depthwise and project BatchNorms, 12 the expand
    assert n_first == 13 * 2 + 12 and len(folds) == n_first * 2
    torch.testing.assert_close(second, first, rtol=0, atol=0)
    torch.testing.assert_close(fresh, first, rtol=0, atol=0)


def test_fold_cache_follows_load_state_dict(jax_setup):
    """After ``load_state_dict`` with other weights the fused forward is a
    fresh model's from those weights (no stale fold) and matches the JAX
    fused route on them."""
    x, variables = jax_setup
    other = _other_variables(variables, 5)
    pm = _port(variables, True)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        before = pm(xt, features=True)
        pm.load_state_dict(convert.state_dict_from_jax("MobileNetV2", other))
        got = pm(xt, features=True)
        fresh = _port(other, True)(xt, features=True)
    torch.testing.assert_close(got, fresh, rtol=0, atol=0)
    assert not torch.equal(got, before)
    jm = JaxMobileNetV2(num_classes=5, fused_inference=True)
    want = np.asarray(jm.apply(other, x, train=False, features=True))
    np.testing.assert_allclose(got.numpy(), want, **FUSED_TOL)


def test_fold_cache_follows_in_place_edits(jax_setup):
    """An in-place edit of one BatchNorm's running variance (its version
    counter moves) changes the fused forward, to a fresh model's."""
    x, variables = jax_setup
    pm = _port(variables, True)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        before = pm(xt, features=True)
    with torch.no_grad():
        pm.block_14_depthwise_BN.running_var.mul_(4.0)
    with torch.inference_mode():
        after = pm(xt, features=True)
        fresh = copy.deepcopy(pm)(xt, features=True)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


def test_registry_knob_and_variant_key(monkeypatch):
    spec = get_model_spec("MobileNetV2")
    assert (spec.input_size, spec.feature_size, spec.preprocess_mode) == (
        (224, 224), 1280, "tf")
    monkeypatch.delenv("SPARKDL_MNV2_FUSED", raising=False)
    assert spec.build().fused_inference is False  # off by default, as JAX
    assert model_variant_key("MobileNetV2") == ""
    monkeypatch.setenv("SPARKDL_MNV2_FUSED", "1")
    assert spec.build(num_classes=3).fused_inference is True
    assert model_variant_key("mobilenetv2") == "fused"
    monkeypatch.setenv("SPARKDL_MNV2_FUSED", "false")
    assert model_variant_key("MobileNetV2") == ""

    xspec = get_model_spec("Xception")
    monkeypatch.delenv("SPARKDL_XC_TILED", raising=False)
    assert xspec.build().tiled_entry is False
    assert model_variant_key("Xception") == ""
    monkeypatch.setenv("SPARKDL_XC_TILED", "1")
    assert xspec.build().tiled_entry is True
    assert model_variant_key("Xception") == "tiled"


@pytest.mark.parametrize("name", ["MobileNetV2", "Xception"])
def test_convert_places_every_leaf(name):
    """Both zoo models' full JAX variable trees convert with no leaf left
    over and no port tensor unset (shapes from ``eval_shape``, zeros for
    values: only the mapping is under test)."""
    module = jax_spec(name).build()
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda r: module.init(r, x, train=False),
                            jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = convert.state_dict_from_jax(name, variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    # BN layers gain num_batches_tracked; everything else is one-to-one
    n_bn = len(variables["batch_stats"])
    assert len(sd) == n_leaves + n_bn
    model = get_model_spec(name).build()
    model.load_state_dict(sd)  # strict: every tensor placed


@pytest.fixture
def zoo(monkeypatch):
    """Both zoos serve the same MobileNetV2 weights (1000 classes) at a
    96x96 input, on the CPU."""
    model = JaxMobileNetV2(num_classes=1000)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda r, a: model.init(r, a, train=False))(
            jax.random.PRNGKey(4), np.zeros((1, SIZE, SIZE, 3), np.float32)))
    narrow_jax = dataclasses.replace(jax_spec("MobileNetV2"),
                                     input_size=(SIZE, SIZE))
    narrow_port = dataclasses.replace(get_model_spec("MobileNetV2"),
                                      input_size=(SIZE, SIZE))
    monkeypatch.delenv("SPARKDL_MNV2_FUSED", raising=False)
    monkeypatch.setattr(jax_ni, "get_model_spec", lambda name: narrow_jax)
    monkeypatch.setattr(port_ni, "get_model_spec", lambda name: narrow_port)
    monkeypatch.setattr(jax_ni, "_ENGINE_CACHE", {})
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    monkeypatch.setattr(port_ni, "_MODEL_CACHE", {})
    monkeypatch.setitem(jax_ni._MODEL_CACHE, ("MobileNetV2", ""),
                        (narrow_jax.build(), variables))
    sd = convert.state_dict_from_jax("MobileNetV2", variables)

    def load(name, **kw):
        m = get_model_spec(name).build()
        m.load_state_dict(sd)
        return m.eval()

    monkeypatch.setattr(port_ni, "load_model", load)
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _features(df, col):
    return [None if v is None else np.asarray(v, np.float32)
            for v in df.table.column(col).to_pylist()]


def test_featurizer_matches_jax(zoo, fixture_images):
    kw = dict(inputCol="image", outputCol="features",
              modelName="MobileNetV2", batchSize=2)
    want = _features(jax_ni.DeepImageFeaturizer(**kw).transform(
        jax_readImages(fixture_images["dir"])), "features")
    got = _features(port_ni.DeepImageFeaturizer(**kw).transform(
        readImages(fixture_images["dir"])), "features")
    assert [g is None for g in got] == [w is None for w in want] == [
        False, False, False, True]  # the undecodable file stays null
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == (1280,)
        np.testing.assert_allclose(g, w, **UNFUSED_TOL)


def test_knob_set_after_first_call_builds_fused_variant(zoo, fixture_images,
                                                        monkeypatch):
    """The caches are keyed on the build variant: setting
    SPARKDL_MNV2_FUSED after a first call serves the fused model, not the
    cached unfused one, and its features agree with the first call's."""
    df = readImages(fixture_images["dir"])
    kw = dict(inputCol="image", outputCol="features",
              modelName="MobileNetV2", batchSize=4)
    first = _features(port_ni.DeepImageFeaturizer(**kw).transform(df),
                      "features")
    monkeypatch.setenv("SPARKDL_MNV2_FUSED", "1")
    second = _features(port_ni.DeepImageFeaturizer(**kw).transform(df),
                       "features")
    assert set(port_ni._MODEL_CACHE) == {("MobileNetV2", ""),
                                         ("MobileNetV2", "fused")}
    engines = {k[1]: e for k, e in port_ni._ENGINE_CACHE.items()}
    assert engines[""].module.fused_inference is False
    assert engines["fused"].module.fused_inference is True
    for a, b in zip(first[:3], second[:3]):
        np.testing.assert_allclose(b, a, **ROUTE_TOL)
