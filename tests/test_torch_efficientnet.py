"""The port's EfficientNetB0 (sparkdl_tpu_torch/models/efficientnet.py) and
its building blocks held against the JAX package's on the CPU, from the
same variables.

At an odd (35) and an even (32) input the stride-2 blocks' Keras
``correct_pad`` takes both of its forms.  The JAX tree's shapes come from
``jax.eval_shape`` and are filled from a numpy seed, with the input
normalization's mean and variance near ImageNet's and ``post_scale`` at
the ImageNet build's ``1/sqrt(std)`` (not 1); the tree goes through
``state_dict_from_jax`` into the port.  The input is raw [0, 255] pixels
(preprocess mode "none": the model scales them itself).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.models.efficientnet import (EfficientNetB0 as JaxEffNet,
                                             _correct_pad as jax_correct_pad)
from sparkdl_tpu.models.layers import DepthwiseConv2D as JaxDepthwise
from sparkdl_tpu_torch.models import convert, get_model_spec, load_model
from sparkdl_tpu_torch.models.efficientnet import (EfficientNetB0,
                                                   efficientnet_import_fixup)
from sparkdl_tpu_torch.models.layers import DepthwiseConv2D, correct_pad

# f32 on both sides, sums in another order (the other zoo tests' bar)
TOL = dict(rtol=1e-3, atol=1e-3)
POST_SCALE = (1 / np.sqrt([0.229, 0.224, 0.225])).astype(np.float32)


def seeded_variables(module, size, seed):
    x = np.zeros((1, size, size, 3), np.float32)
    shapes = jax.eval_shape(lambda r: module.init(r, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if "normalization" in key:
            return {"['mean']": np.asarray([0.485, 0.456, 0.406], np.float32),
                    "['var']": np.asarray([0.229, 0.224, 0.225],
                                          np.float32) ** 2,
                    "['post_scale']": POST_SCALE}[key[key.rindex("["):]]
        if key.endswith("['var']") or key.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if key.endswith("['kernel']") or key.endswith("_kernel']"):
            fan = int(np.prod(s.shape[:-1])) if "depthwise" not in key \
                else int(np.prod(s.shape[:2]))
            return rng.normal(0, np.sqrt(2 / fan), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("size", [35, 32])
def test_features_and_logits_match_jax(size):
    jm = JaxEffNet(num_classes=5)
    variables = seeded_variables(jm, size, 61)
    x = np.random.default_rng(62).integers(
        0, 256, (2, size, size, 3)).astype(np.float32)
    pm = EfficientNetB0(num_classes=5)
    sd = convert.state_dict_from_jax("EfficientNetB0", variables)
    assert torch.equal(sd["normalization.post_scale"],
                       torch.from_numpy(POST_SCALE))
    pm.load_state_dict(sd)
    pm.eval()
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        feats = pm(xt, features=True)
        logits = pm(xt, logits=True)
    want_f = np.asarray(jax.jit(lambda v, a: jm.apply(
        v, a, train=False, features=True))(variables, x))
    kernel = variables["params"]["predictions"]["kernel"]
    bias = variables["params"]["predictions"]["bias"]
    want_l = want_f @ kernel + bias
    assert feats.shape == (2, 1280) and logits.shape == (2, 5)
    assert np.abs(want_f).mean() > 0.05
    # the two images give different features
    assert np.abs(want_f[0] - want_f[1]).mean() > 1e-3
    np.testing.assert_allclose(feats.numpy(), want_f, **TOL)
    np.testing.assert_allclose(logits.numpy(), want_l, **TOL)
    # post_scale is applied: at 1 the features move
    sd["normalization.post_scale"] = torch.ones(3)
    pm.load_state_dict(sd)
    with torch.inference_mode():
        plain = pm(xt, features=True).numpy()
    assert not np.allclose(plain, want_f, **TOL)


@pytest.mark.parametrize("h,w", [(7, 8), (8, 7), (16, 16), (15, 15)])
@pytest.mark.parametrize("k", [3, 5])
def test_correct_pad_matches_keras(h, w, k):
    x = np.random.default_rng(63).random((1, h, w, 2)).astype(np.float32)
    want = np.asarray(jax_correct_pad(jnp.asarray(x), k))
    got = correct_pad(torch.from_numpy(x).permute(0, 3, 1, 2), k)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2), (5, 2)])
def test_depthwise_matches_jax(k, stride):
    c = 6
    x = np.random.default_rng(64).random((2, 11, 11, c)).astype(np.float32)
    jm = JaxDepthwise((k, k), strides=(stride, stride),
                      padding="SAME" if stride == 1 else "VALID")
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(k), x))
    want = np.asarray(jm.apply(variables, x))
    pm = DepthwiseConv2D(c, stride, kernel_size=k)
    pm.load_state_dict({"depthwise_weight": torch.from_numpy(np.array(
        variables["params"]["depthwise_kernel"])).permute(2, 3, 0, 1)})
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert [n for n, _ in pm.named_parameters()] == ["depthwise_weight"]


def test_import_fixup_reads_the_second_rescaling():
    sd = {"normalization.post_scale": torch.ones(3)}
    configs = [("InputLayer", {}), ("Rescaling", {"scale": 1 / 255}),
               ("Normalization", {})]
    assert torch.equal(efficientnet_import_fixup(configs, dict(sd))[
        "normalization.post_scale"], torch.ones(3))
    assert efficientnet_import_fixup(None, dict(sd)) == sd
    configs.append(("Rescaling", {"scale": POST_SCALE.tolist()}))
    got = efficientnet_import_fixup(configs, dict(sd))
    assert torch.equal(got["normalization.post_scale"],
                       torch.from_numpy(POST_SCALE))
    configs[-1] = ("Rescaling", {"scale": 0.5})
    assert torch.equal(efficientnet_import_fixup(configs, dict(sd))[
        "normalization.post_scale"], torch.full((3,), 0.5))


def test_registry_matches_jax():
    spec, jspec = get_model_spec("EfficientNetB0"), jax_spec("EfficientNetB0")
    assert (spec.input_size, spec.feature_size, spec.preprocess_mode,
            spec.keras_app) == ((224, 224), 1280, "none",
                                "EfficientNetB0") == (
        jspec.input_size, jspec.feature_size, jspec.preprocess_mode,
        jspec.keras_app)
    m = load_model("EfficientNetB0")
    assert torch.equal(m.normalization.post_scale, torch.ones(3))
    # a uint8 batch as the stage ships it (preprocess "none" casts it)
    x = torch.randint(0, 256, (1, 32, 32, 3), dtype=torch.uint8)
    with torch.inference_mode():
        f = m(spec.preprocess(x), features=True)
    assert f.shape == (1, 1280) and torch.isfinite(f).all()


# -- train mode: flax BatchNorm and stochastic depth ------------------------------
# train mode normalizes by batch statistics: the same bar, the updated
# statistics (means over the batch) a little tighter
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def test_train_mode_at_rate_zero_matches_jax():
    """``drop_connect_rate`` 0 (the default): the train-mode apply
    (``ModelFunction.train_fn``: every BatchNorm on batch statistics with
    flax's update) gives JAX's ``train=True`` logits and updated
    ``batch_stats``."""
    from sparkdl_tpu_torch.graph.function import ModelFunction

    jm = JaxEffNet(num_classes=5)
    variables = seeded_variables(jm, 32, 63)
    x = np.random.default_rng(64).integers(
        0, 256, (4, 32, 32, 3)).astype(np.float32)
    want, mutated = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, logits=True, mutable=["batch_stats"]))(variables, x)
    pm = EfficientNetB0(num_classes=5)
    pm.load_state_dict(convert.state_dict_from_jax("EfficientNetB0",
                                                   variables))
    mf = ModelFunction.from_module(pm, method_kwargs={"logits": True})
    got, stats = mf.train_fn(pm, torch.from_numpy(x))
    assert not pm.training  # the mode is restored
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    new_sd = convert.state_dict_from_jax(
        "EfficientNetB0", {"params": variables["params"],
                           "batch_stats": jax.tree_util.tree_map(
                               np.asarray, mutated["batch_stats"])})
    assert len(stats) == 2 * 49 and set(stats) <= set(new_sd)
    for k, t in stats.items():
        np.testing.assert_allclose(t.numpy(), new_sd[k].numpy(),
                                   **STATS_TOL, err_msg=k)
    # the input normalization's statistics are not BatchNorm statistics
    assert not any(k.startswith("normalization") for k in stats)


def test_drop_connect_mask_properties_and_reproducibility():
    """Per-sample masks (every element of a sample kept or zeroed
    together), survivors divided by keep, about ``keep`` of the samples
    kept, the same draws from the same seed; a generator is required, and
    eval mode never drops."""
    from sparkdl_tpu_torch.models.efficientnet import drop_connect

    x = torch.ones(4000, 2, 3, 3)
    out = drop_connect(x, 0.3, torch.Generator().manual_seed(1))
    per_sample = out.reshape(4000, -1)
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    kept = per_sample[:, 0] != 0
    torch.testing.assert_close(per_sample[kept, 0],
                               torch.full((int(kept.sum()),), 1 / 0.7))
    # binomial(4000, 0.7): 0.7 +- 4.3 sigma
    assert abs(float(kept.float().mean()) - 0.7) < 0.03
    again = drop_connect(x, 0.3, torch.Generator().manual_seed(1))
    other = drop_connect(x, 0.3, torch.Generator().manual_seed(2))
    assert torch.equal(out, again) and not torch.equal(out, other)
    with pytest.raises(ValueError, match="generator"):
        drop_connect(x, 0.3, None)

    def run(seed, train=True):
        m = EfficientNetB0(num_classes=3, drop_connect_rate=0.5,
                           generator=torch.Generator().manual_seed(seed))
        from sparkdl_tpu_torch.models import init_weights

        init_weights(m, torch.Generator().manual_seed(0))
        m.train(train)
        with torch.no_grad():
            return m(torch.full((3, 32, 32, 3), 100.0), logits=True)

    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))
    assert torch.equal(run(5, train=False), run(6, train=False))
    m = EfficientNetB0(num_classes=3, drop_connect_rate=0.5).train()
    with pytest.raises(ValueError, match="generator"):
        m(torch.zeros(1, 32, 32, 3))
