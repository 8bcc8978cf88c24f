"""The port's InceptionV3 (sparkdl_tpu_torch/models/inception.py) and its
building blocks held against the JAX package's on the CPU, from the same
variables.

The JAX variable tree's shapes come from ``jax.eval_shape`` (no init
compile) and are filled from a numpy seed: He-scaled kernels (so the
activations keep their size through ~50 conv layers), BatchNorm bias,
mean and var drawn as in ``test_torch_xception.py`` (InceptionV3's BNs
have no scale).  The tree goes through ``state_dict_from_jax`` into the
port.  Both run the same seeded batch of 2 at 75x75, the smallest input
the net takes, at full width with 5 classes.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.models.inception import InceptionV3 as JaxInceptionV3
from sparkdl_tpu.models.layers import SpaceToDepthConv as JaxSpaceToDepthConv
from sparkdl_tpu_torch.models import (convert, get_model_spec, layers,
                                      load_model, model_variant_key)
from sparkdl_tpu_torch.models.inception import (BLOCKS, InceptionV3,
                                                inception_import_order)

SIZE = 75
# f32 on both sides, sums in another order: 1e-3 covers the accumulated
# rounding of ~50 conv layers (the Xception tests' UNFUSED_TOL).
UNFUSED_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 on both sides: each layer rounds to bf16 and a value near a rounding
# boundary can land one bf16 step apart; the JAX package's fused bar.
BF16_TOL = dict(rtol=5e-2, atol=2e-2)
# Blocks whose branches start with 2-3 stride-1 1x1 units: mixed0-2,
# mixed4-7, mixed8, mixed9-10 (mixed3 has one).
FUSED_HEAD_BLOCKS = 10


def seeded_variables(module, size, seed):
    """``module``'s variable tree at a ``size`` input: shapes from
    ``eval_shape``, values from a numpy seed."""
    x = np.zeros((1, size, size, 3), np.float32)
    shapes = jax.eval_shape(lambda r: module.init(r, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if "var" in key:
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if key.endswith("['kernel']") or "_kernel']" in key:
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2 / fan), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_setup():
    x = (np.random.default_rng(31).random((2, SIZE, SIZE, 3)) * 2 - 1
         ).astype(np.float32)
    return x, seeded_variables(JaxInceptionV3(num_classes=5), SIZE, 32)


def _jax_apply(module, variables, x, **kw):
    """``module.apply`` at inference under ``jax.jit`` (one compile of the
    whole net takes a few seconds on the CPU; op-by-op dispatch, several
    times that)."""
    return np.asarray(jax.jit(lambda v, a: module.apply(
        v, a, train=False, **kw))(variables, x))


def _port(variables, **kw):
    m = InceptionV3(num_classes=5, **kw)
    m.load_state_dict(convert.state_dict_from_jax("InceptionV3", variables))
    return m.eval()


@pytest.mark.parametrize("fused_heads", [True, False])
def test_features_and_logits_match_jax(jax_setup, fused_heads):
    x, variables = jax_setup
    jm = JaxInceptionV3(num_classes=5, fused_heads=fused_heads)
    pm = _port(variables, fused_heads=fused_heads)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        feats = pm(xt, features=True)
        logits = pm(xt, logits=True)
        probs = pm(xt)
    want_f = _jax_apply(jm, variables, x, features=True)
    want_l = _jax_apply(jm, variables, x, logits=True)
    assert feats.shape == (2, 2048) and logits.shape == (2, 5)
    assert feats.dtype == torch.float32
    assert np.abs(want_f).mean() > 0.1  # activations kept their size
    np.testing.assert_allclose(feats.numpy(), want_f, **UNFUSED_TOL)
    np.testing.assert_allclose(logits.numpy(), want_l, **UNFUSED_TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_s2d_stem_matches_jax(jax_setup):
    x, variables = jax_setup
    jm = JaxInceptionV3(num_classes=5, s2d_stem=True)
    pm = _port(variables, s2d_stem=True)
    assert isinstance(pm.stem_conv1.conv, layers.SpaceToDepthConv)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x), features=True).numpy()
    want = _jax_apply(jm, variables, x, features=True)
    np.testing.assert_allclose(got, want, **UNFUSED_TOL)


def test_bf16_route_matches_jax_bf16(jax_setup):
    """The bf16 engine's route (every floating tensor and the input cast to
    bf16, fused heads on) against JAX run the same way."""
    x, variables = jax_setup
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                variables)
    want = _jax_apply(JaxInceptionV3(num_classes=5), vb,
                      jnp.asarray(x, jnp.bfloat16),
                      features=True).astype(np.float32)
    pm = _port(variables).to(torch.bfloat16)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).bfloat16(), features=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_fused_heads_counts_and_train_mode(jax_setup, monkeypatch):
    """Fused heads start 10 blocks with one conv each at inference; train
    mode and ``fused_inference = False`` (the alias the scripts set) take
    the per-branch route."""
    import sparkdl_tpu_torch.models.inception as inc

    x, variables = jax_setup
    pm = _port(variables)
    calls = []
    real = inc.conv2d

    def counting(x, w, *a, **kw):
        calls.append(w.shape[0])
        return real(x, w, *a, **kw)

    monkeypatch.setattr(inc, "conv2d", counting)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        pm(xt, features=True)
        assert len(calls) == FUSED_HEAD_BLOCKS
        # mixed0: 64 + 48 + 64 output channels; mixed10: 320 + 384 + 448
        assert calls[0] == 176 and calls[-1] == 1152
        pm.fused_inference = False
        assert pm.fused_heads is False
        pm(xt, features=True)
        pm.fused_inference = None
        pm.train()
        pm(xt, features=True)
    assert len(calls) == FUSED_HEAD_BLOCKS


def test_fused_heads_fold_once_per_weights_version(jax_setup, monkeypatch):
    """The heads are folded on the first fused forward only; a
    ``load_state_dict`` with other weights and an in-place edit refold, to
    a fresh model's outputs."""
    import sparkdl_tpu_torch.models.inception as inc

    x, variables = jax_setup
    pm = _port(variables)
    folds = []
    real = inc.fold_bn_into_conv

    def counting(*a):
        folds.append(1)
        return real(*a)

    monkeypatch.setattr(inc, "fold_bn_into_conv", counting)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        first = pm(xt, features=True)
        n_first = len(folds)
        second = pm(xt, features=True)
    assert n_first == 3 * 3 + 4 * 3 + 2 + 2 * 3 and len(folds) == n_first
    torch.testing.assert_close(second, first, rtol=0, atol=0)

    other = jax.tree_util.tree_map(
        lambda a: (a * 1.1).astype(np.float32), variables)
    pm.load_state_dict(convert.state_dict_from_jax("InceptionV3", other))
    with torch.inference_mode():
        got = pm(xt, features=True)
        assert len(folds) == 2 * n_first
        fresh = _port(other)(xt, features=True)
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, fresh, rtol=0, atol=0)

    with torch.no_grad():
        pm.mixed9_b3x3dbl_1.bn.running_var.mul_(4.0)
    with torch.inference_mode():
        after = pm(xt, features=True)
        fresh = copy.deepcopy(pm)(xt, features=True)
    assert not torch.equal(after, got)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


@pytest.mark.parametrize("size", [9, 10])
def test_space_to_depth_conv_matches_flax(size):
    """``SpaceToDepthConv`` against the JAX layer and against the plain
    stride-2 conv, 3x3 kernel, at an odd and an even extent."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    want = np.asarray(JaxSpaceToDepthConv(8, (3, 3), (2, 2)).apply(
        {"params": {"kernel": k}}, x))
    conv = layers.SpaceToDepthConv(3, 8, (3, 3), (2, 2))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = conv(xt)
        plain = torch.nn.functional.conv2d(xt, conv.weight, stride=2)
    out = (size - 3) // 2 + 1
    assert got.shape == (2, 8, out, out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pool_same_excludes_padding(dtype):
    """At the border the divisor counts only the pixels inside the image,
    as flax's ``count_include_pad=False``; the result keeps x's dtype."""
    x = np.random.default_rng(3).normal(size=(2, 5, 6, 4)).astype(np.float32)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                   padding="SAME", count_include_pad=False))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got = layers.avg_pool_same(xt)
    assert got.dtype == xt.dtype
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               want, rtol=tol, atol=tol)
    # the corner averages its 2x2 neighbourhood
    np.testing.assert_allclose(want[0, 0, 0], x[0, :2, :2].mean((0, 1)),
                               rtol=1e-6)


def test_max_pool_valid_matches_flax():
    x = np.random.default_rng(4).normal(size=(2, 9, 8, 3)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="VALID"))
    got = layers.max_pool_valid(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv_bn_has_no_bn_scale():
    unit = layers.ConvBN(4, 8, (1, 7))
    assert unit.padding == (0, 3)
    assert sorted(unit.state_dict()) == [
        "bn.bias", "bn.num_batches_tracked", "bn.running_mean",
        "bn.running_var", "conv.weight"]
    k, s, t = unit.folded()
    assert k is unit.conv.weight
    torch.testing.assert_close(s, torch.full((8,), 1 / np.sqrt(1 + 1e-3)))
    with pytest.raises(ValueError):
        layers.ConvBN(4, 8, (3, 3), (2, 2), "SAME")


@pytest.mark.parametrize("env,key,s2d,fused", [
    ({}, "", False, None),
    ({"SPARKDL_FUSED_HEADS": "0"}, "nofh", False, False),
    ({"SPARKDL_S2D_STEM": "1"}, "s2d", True, None),
    ({"SPARKDL_S2D_STEM": "1", "SPARKDL_FUSED_HEADS": "0"}, "s2d+nofh",
     True, False),
])
def test_registry_knobs_and_variant_key(monkeypatch, env, key, s2d, fused):
    monkeypatch.delenv("SPARKDL_S2D_STEM", raising=False)
    monkeypatch.delenv("SPARKDL_FUSED_HEADS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = get_model_spec("InceptionV3")
    assert (spec.input_size, spec.feature_size, spec.preprocess_mode) == (
        (299, 299), 2048, "tf")
    with torch.device("meta"):
        m = spec.build(num_classes=3)
    assert (m.s2d_stem, m.fused_heads, m.predictions.out_features) == (
        s2d, fused, 3)
    assert model_variant_key("inceptionv3") == key
    assert model_variant_key("InceptionV3") == jax_spec(
        "InceptionV3").variant_key_fn()


def test_convert_places_every_leaf_and_raises_on_unmatched(jax_setup):
    _, variables = jax_setup
    sd = convert.state_dict_from_jax("InceptionV3", variables)
    n_units = len(variables["batch_stats"])
    assert n_units == 94 == len(inception_import_order()) // 2
    # every leaf placed; each BN gains num_batches_tracked and has no weight
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) + n_units
    assert "stem_conv1.bn.weight" not in sd
    assert sd["stem_conv1.conv.weight"].shape == (32, 3, 3, 3)
    InceptionV3(num_classes=5).load_state_dict(sd)  # strict

    params = {k: dict(v) for k, v in variables["params"].items()}
    params["mixed5_b1x1"] = {"conv": params["mixed5_b1x1"]["conv"],
                             "bn": {}}
    with pytest.raises(ValueError, match="mixed5_b1x1"):
        convert.state_dict_from_jax(
            "InceptionV3", {"params": params,
                            "batch_stats": variables["batch_stats"]})
    params = {k: dict(v) for k, v in variables["params"].items()}
    params["mixed5_b1x1"]["bn"] = dict(params["mixed5_b1x1"]["bn"],
                                       extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="mixed5_b1x1/bn"):
        convert.state_dict_from_jax(
            "InceptionV3", {"params": params,
                            "batch_stats": variables["batch_stats"]})
    params = {k: dict(v) for k, v in variables["params"].items()}
    params["stem_conv1"]["bn"] = dict(params["stem_conv1"]["bn"],
                                      scale=np.ones(32, np.float32))
    with pytest.raises(ValueError, match="stem_conv1.bn.weight"):
        convert.state_dict_from_jax(
            "InceptionV3", {"params": params,
                            "batch_stats": variables["batch_stats"]})


def _digest(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        t = sd[k].contiguous()
        h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,digest", [
    ("Xception",
     "d272ab2a37f520865d74f02c0e83acdfc90e5668cd0977b8a6f1e77af9608b3b"),
    ("MobileNetV2",
     "ddf8719370cb13a305558b23c09f39cf40acc29b0c5ddbd2df84d9c332009504"),
])
def test_flat_zoo_conversions_unchanged(name, digest):
    """The nested walk leaves the flat trees' conversion byte for byte as
    the one-level converter gave it (its digest on these seeded trees)."""
    variables = seeded_variables(jax_spec(name).build(), 64, 7)
    assert _digest(convert.state_dict_from_jax(name, variables)) == digest


def test_load_model_is_seeded():
    a = load_model("InceptionV3", num_classes=3,
                   generator=torch.Generator().manual_seed(5))
    b = load_model("inceptionv3", num_classes=3,
                   generator=torch.Generator().manual_seed(5))
    c = load_model("InceptionV3", num_classes=3,
                   generator=torch.Generator().manual_seed(6))
    assert not a.training
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    assert not torch.equal(sa["mixed10_bpool.conv.weight"],
                           c.state_dict()["mixed10_bpool.conv.weight"])
    assert not any(k.endswith("bn.weight") for k in sa)
    assert len(BLOCKS) == 11


def test_featurizer_matches_jax(jax_setup, fixture_images, monkeypatch):
    """``DeepImageFeaturizer(modelName="InceptionV3")`` of both packages
    over the same JPEG files and weights, with both registries' spec
    narrowed to a 75x75 input (widths full): 2048-d features within 1e-3;
    the undecodable file stays null."""
    import dataclasses

    import sparkdl_tpu.transformers.named_image as jax_ni
    import sparkdl_tpu_torch
    import sparkdl_tpu_torch.transformers.named_image as port_ni
    from sparkdl_tpu.image.io import readImages as jax_readImages
    from sparkdl_tpu_torch.image.io import readImages

    _, variables = jax_setup
    narrow_jax = dataclasses.replace(jax_spec("InceptionV3"),
                                     input_size=(SIZE, SIZE))
    narrow_port = dataclasses.replace(get_model_spec("InceptionV3"),
                                      input_size=(SIZE, SIZE))
    monkeypatch.delenv("SPARKDL_FUSED_HEADS", raising=False)
    monkeypatch.delenv("SPARKDL_S2D_STEM", raising=False)
    monkeypatch.setattr(jax_ni, "get_model_spec", lambda name: narrow_jax)
    monkeypatch.setattr(port_ni, "get_model_spec", lambda name: narrow_port)
    monkeypatch.setattr(jax_ni, "_ENGINE_CACHE", {})
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    monkeypatch.setitem(jax_ni._MODEL_CACHE, ("InceptionV3", ""),
                        (JaxInceptionV3(num_classes=5), variables))
    monkeypatch.setattr(port_ni, "_MODEL_CACHE",
                        {("InceptionV3", ""): _port(variables)})
    kw = dict(inputCol="image", outputCol="features",
              modelName="InceptionV3", batchSize=2)
    want = jax_ni.DeepImageFeaturizer(**kw).transform(
        jax_readImages(fixture_images["dir"])).table.column(
        "features").to_pylist()
    with sparkdl_tpu_torch.default_device("cpu"):
        got = port_ni.DeepImageFeaturizer(**kw).transform(
            readImages(fixture_images["dir"])).table.column(
            "features").to_pylist()
    assert [g is None for g in got] == [w is None for w in want] == [
        False, False, False, True]
    for g, w in zip(got[:3], want[:3]):
        assert len(g) == 2048
        np.testing.assert_allclose(g, w, **UNFUSED_TOL)
