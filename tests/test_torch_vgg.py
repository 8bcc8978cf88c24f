"""The port's VGG16/19 (sparkdl_tpu_torch/models/vgg.py) held against the
JAX package's on the CPU, from the same variables.

At a 32x32 input the last pool leaves 1x1x512, where any flatten order is
the same; at 64x96 it leaves 2x3x512, where ``fc1``'s rows must be read in
Keras' channel-last (H, W, C) order: flattening the NCHW tensor instead
permutes them, and the features differ.  The JAX tree's shapes come from
``jax.eval_shape`` and are filled from a numpy seed; the tree goes through
``state_dict_from_jax`` (built with the test's ``input_size``) into the
port.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.models.vgg import VGG16 as JaxVGG16, VGG19 as JaxVGG19
from sparkdl_tpu_torch.models import convert, get_model_spec, load_model
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19

# f32 on both sides, sums in another order (the other zoo tests' bar)
TOL = dict(rtol=1e-3, atol=1e-3)
JAX_VGG = {"VGG16": JaxVGG16, "VGG19": JaxVGG19}
PORT_VGG = {"VGG16": VGG16, "VGG19": VGG19}


def seeded_variables(module, hw, seed):
    x = np.zeros((1,) + hw + (3,), np.float32)
    shapes = jax.eval_shape(lambda r: module.init(r, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2 / fan), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name,hw", [("VGG16", (32, 32)),
                                     ("VGG19", (32, 32)),
                                     ("VGG16", (64, 96))])
def test_features_and_logits_match_jax(name, hw):
    jm = JAX_VGG[name](num_classes=5)
    variables = seeded_variables(jm, hw, 51)
    x = (np.random.default_rng(52).random((2,) + hw + (3,)) * 255 - 120
         ).astype(np.float32)
    pm = PORT_VGG[name](num_classes=5, input_size=hw)
    pm.load_state_dict(convert.state_dict_from_jax(name, variables,
                                                   input_size=hw))
    pm.eval()
    flat = (hw[0] // 32) * (hw[1] // 32) * 512
    assert pm.fc1.in_features == flat
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        feats = pm(xt, features=True)
        logits = pm(xt, logits=True)
        probs = pm(xt)
    apply = jax.jit(lambda v, a, **kw: jm.apply(v, a, train=False, **kw),
                    static_argnames=("features", "logits"))
    want_f = np.asarray(apply(variables, x, features=True))
    want_l = np.asarray(apply(variables, x, logits=True))
    assert feats.shape == (2, 4096) and logits.shape == (2, 5)
    assert np.abs(want_f).mean() > 0.01
    np.testing.assert_allclose(feats.numpy(), want_f, **TOL)
    np.testing.assert_allclose(logits.numpy(), want_l, **TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    if flat > 512:
        # the NCHW flatten (x.reshape(B, -1) of the NCHW tensor) is the
        # right flatten with fc1's columns read in (C, H, W) order: it
        # misses the JAX features by far more than the tolerance
        wrong = copy.deepcopy(pm)
        h, w = hw[0] // 32, hw[1] // 32
        with torch.no_grad():
            wrong.fc1.weight.copy_(pm.fc1.weight.reshape(
                4096, 512, h, w).permute(0, 2, 3, 1).reshape(4096, -1))
            bad = wrong(xt, features=True).numpy()
        assert not np.allclose(bad, want_f, **TOL)


def test_registry_matches_jax():
    for name in ("VGG16", "VGG19"):
        spec, jspec = get_model_spec(name), jax_spec(name)
        assert (spec.input_size, spec.feature_size, spec.preprocess_mode,
                spec.keras_app) == ((224, 224), 4096, "caffe", name) == (
            jspec.input_size, jspec.feature_size, jspec.preprocess_mode,
            jspec.keras_app)
        with torch.device("meta"):
            m = spec.build()
        assert m.fc1.in_features == 7 * 7 * 512
        assert m.predictions.out_features == 1000


def test_seeded_init_is_deterministic():
    a = load_model("VGG16", input_size=(32, 32)).state_dict()
    b = load_model("VGG16", input_size=(32, 32)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["block1_conv1.bias"].abs().sum() > 0
