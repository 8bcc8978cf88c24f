"""The port's Xception (sparkdl_tpu_torch/models/xception.py) held against
the JAX package's on the CPU, from the same variables.

JAX ``Xception(num_classes=5)`` is initialised at 96x96, its BatchNorm
variables are redrawn from a numpy seed (so the BN mapping is not an
identity), and the tree goes through ``state_dict_from_jax`` into the port.
Both run the same seeded batch of 2, on the unfused route and on the fused
route (on the CPU both packages route the fused layers to their kernel's
plain version).
"""

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu.models.xception import Xception as JaxXception
from sparkdl_tpu_torch.models import convert, layers, load_model
from sparkdl_tpu_torch.models.xception import Xception

# f32 on both sides, sums in another order: 1e-3 covers the accumulated
# rounding of ~40 conv layers.
UNFUSED_TOL = dict(rtol=1e-3, atol=1e-3)
# The fused route rounds each fused layer's depthwise sum and output to
# bf16; a value near a rounding boundary can land one bf16 step apart on
# the two sides and the step travels down the network.  The JAX package's
# own fused-vs-unfused bar (tests/test_ops_sepconv.py) is this tolerance.
FUSED_TOL = dict(rtol=5e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jax_setup():
    rng = np.random.default_rng(11)
    x = (rng.random((2, 96, 96, 3)) * 2 - 1).astype(np.float32)
    model = JaxXception(num_classes=5, fused_inference=False)
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


def _port(variables, fused):
    m = Xception(num_classes=5, fused_inference=fused)
    m.load_state_dict(convert.state_dict_from_jax("Xception", variables))
    return m.eval()


@pytest.mark.parametrize("fused,tol", [(False, UNFUSED_TOL),
                                       (True, FUSED_TOL)])
def test_features_and_logits_match_jax(jax_setup, fused, tol):
    x, variables = jax_setup
    jm = JaxXception(num_classes=5, fused_inference=fused)
    pm = _port(variables, fused)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        feats = pm(xt, features=True)
        logits = pm(xt, logits=True)
        probs = pm(xt)
    want_f = np.asarray(jm.apply(variables, x, train=False, features=True))
    want_l = np.asarray(jm.apply(variables, x, train=False, logits=True),
                        np.float32)
    assert feats.shape == (2, 2048) and logits.shape == (2, 5)
    np.testing.assert_allclose(feats.float().numpy(),
                               want_f.astype(np.float32), **tol)
    np.testing.assert_allclose(logits.float().numpy(), want_l, **tol)
    np.testing.assert_allclose(probs.float().sum(-1).numpy(), 1.0, rtol=1e-5)
    # the dtypes JAX's promotion gives: bf16 features on the fused route
    # (its last layer is the kernel), f32 logits
    want_dtype = "bfloat16" if fused else "float32"
    assert want_f.dtype.name == want_dtype
    assert feats.dtype == getattr(torch, want_dtype)
    assert logits.dtype == torch.float32


def test_fused_route_layer_counts(monkeypatch):
    """The route rule fuses the same layers as JAX: 34 at 96x96 (every
    block) and 30 at the published 299x299 (entry blocks 2-3 plain).  The
    299 forward runs on the meta device with a counting stand-in for the
    kernel, so no full-size compute happens here."""
    calls = []

    def stub(x, dwk, pw, scale, shift, pre_relu=False, post_relu=False,
             row_tile=None):
        calls.append((tuple(x.shape), pw.shape[-1], pre_relu, post_relu,
                      row_tile))
        return torch.empty(x.shape[:3] + (pw.shape[-1],), dtype=torch.bfloat16,
                           device=x.device)

    monkeypatch.setattr(layers, "fused_sepconv", stub)
    # without autograd: a forward that autograd records takes the unfused
    # route (the fused kernels have no backward)
    with torch.device("meta"), torch.no_grad():
        m = Xception(fused_inference=True).eval()
        for size, want in ((96, 34), (299, 30)):
            calls.clear()
            out = m(torch.empty(2, size, size, 3), features=True)
            assert out.shape == (2, 2048)
            assert len(calls) == want
    # at 299: block4 at 37x37, middle flow and block13 at 19x19, block14
    # at 10x10 with the post-ReLU
    assert calls[0][0][1:] == (37, 37, 256) and calls[0][1] == 728
    assert calls[-1][0][1:] == (10, 10, 1536) and calls[-1][1:] == (
        2048, False, True, None)
    assert all(c[-1] is None for c in calls)


def test_tiled_entry_layer_counts(monkeypatch):
    """With ``tiled_entry`` the 299x299 forward also fuses entry blocks
    2-3 through the tiled route (row_tile 16, as JAX picks it): 4 more
    layers, at 147x147 (64->128 without the pre-ReLU, 128->128) and 74x74
    (128->256, 256->256); the other 30 stay on the whole-image kernel."""
    calls = []

    def stub(x, dwk, pw, scale, shift, pre_relu=False, post_relu=False,
             row_tile=None):
        calls.append((tuple(x.shape[1:]), pw.shape[-1], pre_relu, row_tile))
        return torch.empty(x.shape[:3] + (pw.shape[-1],), dtype=torch.bfloat16,
                           device=x.device)

    monkeypatch.setattr(layers, "fused_sepconv", stub)
    with torch.device("meta"), torch.no_grad():  # no autograd: fused route
        m = Xception(fused_inference=True, tiled_entry=True).eval()
        m(torch.empty(2, 299, 299, 3), features=True)
    tiled = [c for c in calls if c[-1] is not None]
    assert len(calls) == 34 and len(tiled) == 4
    assert tiled == [((147, 147, 64), 128, False, 16),
                     ((147, 147, 128), 128, True, 16),
                     ((74, 74, 128), 256, True, 16),
                     ((74, 74, 256), 256, True, 16)]


def test_tiled_entry_matches_jax_and_unfused(jax_setup):
    """``Xception(fused_inference=True, tiled_entry=True)`` at 224x224, so
    block2 (111x111) takes the tiled route, held against JAX's same
    configuration (both run their kernel's plain version on the CPU) and
    against the port's unfused route, from the same variables."""
    _, variables = jax_setup
    x = (np.random.default_rng(12).random((1, 224, 224, 3)) * 2 - 1
         ).astype(np.float32)
    jm = JaxXception(num_classes=5, fused_inference=True, tiled_entry=True)
    want = np.asarray(jm.apply(variables, x, train=False, features=True),
                      np.float32)
    pm = _port(variables, True)
    pm.tiled_entry = True
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = pm(xt, features=True).float().numpy()
        pm.fused_inference = False
        plain = pm(xt, features=True).float().numpy()
    assert got.shape == (1, 2048)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, plain, **FUSED_TOL)


def test_convert_raises_on_unmatched_leaves(jax_setup):
    _, variables = jax_setup
    params = dict(variables["params"])
    params["extra_layer"] = {"kernel": np.zeros((1, 1, 3, 3), np.float32)}
    with pytest.raises(ValueError, match="extra_layer"):
        convert.state_dict_from_jax(
            "Xception", {"params": params,
                         "batch_stats": variables["batch_stats"]})
    params = dict(variables["params"])
    del params["block5_sepconv1"]
    with pytest.raises(ValueError, match="block5_sepconv1"):
        convert.state_dict_from_jax(
            "Xception", {"params": params,
                         "batch_stats": variables["batch_stats"]})


def test_load_model_is_seeded(monkeypatch):
    a = load_model("Xception", num_classes=3,
                   generator=torch.Generator().manual_seed(5))
    b = load_model("xception", num_classes=3,
                   generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    # "imagenet" with no offline weights file: the seeded init (seed 0), as
    # the JAX package falls back to Keras' random init; an explicit path
    # must exist
    monkeypatch.delenv("SPARKDL_WEIGHTS_DIR", raising=False)
    c = load_model("Xception", num_classes=3, weights="imagenet")
    d = load_model("Xception", num_classes=3)
    for k, v in d.state_dict().items():
        torch.testing.assert_close(c.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_model("Xception", weights="/no/such/xception.h5")


def _count_folds(monkeypatch):
    """Count ``BatchNorm.folded`` calls: every fold of the fused route
    (sepconv operands and BN affines) starts with one."""
    calls = []
    real = layers.BatchNorm.folded

    def counting(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(layers.BatchNorm, "folded", counting)
    return calls


def test_fused_route_folds_once_per_weights_version(jax_setup, monkeypatch):
    """The fused route folds on its first forward only: a second forward
    computes no fold and gives bit-identical outputs, equal to a fresh
    model's, and the cached route still meets JAX's fused route."""
    x, variables = jax_setup
    pm = _port(variables, True)
    folds = _count_folds(monkeypatch)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        first = pm(xt, features=True)
        n_first = len(folds)
        second = pm(xt, features=True)
        n_second = len(folds) - n_first
        fresh = _port(variables, True)(xt, features=True)
    # 34 fused sepconvs at 96x96 and the 6 plain convs' BN affines
    assert n_first == 34 + 6 and n_second == 0
    torch.testing.assert_close(second, first, rtol=0, atol=0)
    torch.testing.assert_close(fresh, first, rtol=0, atol=0)
    jm = JaxXception(num_classes=5, fused_inference=True)
    want = np.asarray(jm.apply(variables, x, train=False, features=True),
                      np.float32)
    np.testing.assert_allclose(first.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    # the operands are cached as the kernel takes them: bf16 taps and
    # pointwise, f32 scale and shift, all contiguous
    dwk, pw, scale, shift = pm._folds["block5_sepconv1"][2]
    assert (dwk.dtype, pw.dtype) == (torch.bfloat16, torch.bfloat16)
    assert (scale.dtype, shift.dtype) == (torch.float32, torch.float32)
    assert dwk.shape == (3, 3, 728) and pw.shape == (728, 728)
    assert all(t.is_contiguous() for t in (dwk, pw, scale, shift))


def test_fold_cache_follows_load_state_dict_and_edits(jax_setup,
                                                      monkeypatch):
    """``load_state_dict`` with other weights and an in-place edit of one
    BatchNorm both refold: the output is then a fresh model's from those
    weights, never a stale fold."""
    x, variables = jax_setup
    rng = np.random.default_rng(13)
    other = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.9, 1.1, a.shape)).astype(a.dtype),
        variables)
    pm = _port(variables, True)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        before = pm(xt, features=True)
    pm.load_state_dict(convert.state_dict_from_jax("Xception", other))
    folds = _count_folds(monkeypatch)
    with torch.inference_mode():
        got = pm(xt, features=True)
        fresh = _port(other, True)(xt, features=True)
    assert len(folds) == 2 * (34 + 6)  # pm refolded all; fresh folded all
    torch.testing.assert_close(got, fresh, rtol=0, atol=0)
    assert not torch.equal(got, before)
    folds.clear()
    with torch.no_grad():
        pm.block5_sepconv1_bn.running_var.mul_(0.5)
        pm.block1_conv1_bn.weight.mul_(1.5)
    edited = pm.state_dict()
    with torch.inference_mode():
        got = pm(xt, features=True)
        n_refolds = len(folds)
        again = Xception(num_classes=5, fused_inference=True)
        again.load_state_dict(edited)
        fresh = again.eval()(xt, features=True)
    assert n_refolds == 2  # only the two edited BatchNorms' folds
    torch.testing.assert_close(got, fresh, rtol=0, atol=0)
