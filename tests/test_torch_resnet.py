"""The port's ResNet (sparkdl_tpu_torch/models/resnet.py) held against the
JAX package's on the CPU, from the same variables.

The JAX module is narrowed through its ``stages`` attribute to two stages
of two blocks (64 and 128 filters, the second at stride 2), at a 64x64
input with 5 classes: every kind of unit the full nets have (the padded
7x7/2 stem, the -inf-padded max pool, projecting and identity bottlenecks,
a stride on the first 1x1), at seconds of CPU time.  Its variable tree's
shapes come from ``jax.eval_shape`` and are filled from a numpy seed, and
go through ``state_dict_from_jax`` into the port.  The full depths are
checked for shape only.
"""

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.models.resnet import ResNet50 as JaxResNet
from sparkdl_tpu_torch.models import (convert, get_model_spec,
                                      import_keras_weights, keras_import,
                                      model_variant_key)
from sparkdl_tpu_torch.models.resnet import RESNET_STAGES, ResNet50

SIZE = 64
STAGES = ((64, 2, 1), (128, 2, 2))
# f32 on both sides, sums in another order (the other zoo tests' bar)
TOL = dict(rtol=1e-3, atol=1e-3)


def seeded_variables(module, size, seed):
    """``module``'s variable tree at a ``size`` input: shapes from
    ``eval_shape``, values from a numpy seed (He-scaled kernels, BN
    scales and variances near 1)."""
    x = np.zeros((1, size, size, 3), np.float32)
    shapes = jax.eval_shape(lambda r: module.init(r, x, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']") or key.endswith("['scale']"):
            return rng.uniform(0.6, 1.2, s.shape).astype(np.float32)
        if key.endswith("['kernel']"):
            fan = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2 / fan), s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_setup():
    x = (np.random.default_rng(41).random((2, SIZE, SIZE, 3)) * 255 - 120
         ).astype(np.float32)
    return x, seeded_variables(JaxResNet(num_classes=5, stages=STAGES),
                               SIZE, 42)


def _port(variables, fused):
    m = ResNet50(num_classes=5, stages=STAGES, fused_shortcut=fused)
    m.load_state_dict(convert.state_dict_from_jax("ResNet50", variables,
                                                  stages=STAGES))
    return m.eval()


@pytest.mark.parametrize("fused", [False, True])
def test_features_and_logits_match_jax(jax_setup, fused):
    x, variables = jax_setup
    jm = JaxResNet(num_classes=5, stages=STAGES, fused_shortcut=fused)
    pm = _port(variables, fused)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        feats = pm(xt, features=True)
        logits = pm(xt, logits=True)
        probs = pm(xt)
    want_f = np.asarray(jm.apply(variables, x, train=False, features=True))
    want_l = np.asarray(jm.apply(variables, x, train=False, logits=True))
    assert feats.shape == (2, 512) and logits.shape == (2, 5)
    assert np.abs(want_f).mean() > 0.1  # activations kept their size
    np.testing.assert_allclose(feats.numpy(), want_f, **TOL)
    np.testing.assert_allclose(logits.numpy(), want_l, **TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_fused_shortcut_matches_unfused_and_folds_once(jax_setup):
    """The fused-shortcut route computes the unfused route's function from
    the same parameters (f32: 1e-3); it folds each projecting block once
    per weights version, and an in-place edit refolds; train mode takes the
    unfused route."""
    x, variables = jax_setup
    pm = _port(variables, True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fused = pm(xt, features=True)
        blocks = [pm.conv2_block1, pm.conv3_block1]
        entries = [b._folds["shortcut"] for b in blocks]
        assert all(not b._folds for b in (pm.conv2_block2, pm.conv3_block2))
        pm(xt, features=True)
        assert [b._folds["shortcut"] for b in blocks] == entries
        pm.fused_inference = False
        plain = pm(xt, features=True)
        pm.fused_inference = True
        pm.conv3_block1.conv3_block1_0_bn.running_var.mul_(2.0)
        edited = pm(xt, features=True)
        assert pm.conv3_block1._folds["shortcut"] is not entries[1]
        pm.fused_inference = False
        edited_plain = pm(xt, features=True)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(edited.numpy(), edited_plain.numpy(), **TOL)
    assert not np.allclose(edited.numpy(), fused.numpy(), **TOL)
    pm.train()
    pm.fused_inference = True
    pm.conv2_block1._folds.clear()
    pm(xt, features=True)
    assert not pm.conv2_block1._folds


def test_bf16_matches_jax_bf16(jax_setup):
    """The module cast to bf16, as the engine's bf16 compute casts it,
    against the JAX module on bf16 variables."""
    x, variables = jax_setup
    jm = JaxResNet(num_classes=5, stages=STAGES)
    pm = _port(variables, False).to(torch.bfloat16)
    vb = jax.tree_util.tree_map(lambda a: a.astype(jax.numpy.bfloat16),
                                variables)
    want = np.asarray(jm.apply(vb, x.astype(jax.numpy.bfloat16), train=False,
                               features=True), np.float32)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).to(torch.bfloat16),
                 features=True).float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_full_depth_shapes_match_keras_table(depth):
    """Every unit of the full nets, by name and shape, against the Keras
    layer table (the importer fills each port tensor exactly once)."""
    name = f"ResNet{depth}"
    layers = [(n, cls, [np.zeros(s, np.float32) for s in shapes])
              for n, cls, shapes in keras_import.keras_layer_table()[name]]
    sd = import_keras_weights(name, layers)
    with torch.device("meta"):
        m = get_model_spec(name).build()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}
    n_blocks = sum(s[1] for s in RESNET_STAGES[depth])
    assert sum(k.endswith("_3_conv.weight") for k in sd) == n_blocks


def test_registry_and_variant_key(monkeypatch):
    for name in ("ResNet50", "ResNet101", "ResNet152"):
        spec, jspec = get_model_spec(name), jax_spec(name)
        assert (spec.input_size, spec.feature_size, spec.preprocess_mode,
                spec.keras_app) == (jspec.input_size, jspec.feature_size,
                                    jspec.preprocess_mode, jspec.keras_app)
        monkeypatch.delenv("SPARKDL_RN_FUSED_SHORTCUT", raising=False)
        assert model_variant_key(name) == "" == jspec.variant_key_fn()
        with torch.device("meta"):
            assert not spec.build().fused_shortcut
        monkeypatch.setenv("SPARKDL_RN_FUSED_SHORTCUT", "1")
        assert model_variant_key(name) == "fsc" == jspec.variant_key_fn()
        with torch.device("meta"):
            assert spec.build(num_classes=3).fused_shortcut
