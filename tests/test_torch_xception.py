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

    def stub(x, dwk, pw, scale, shift, pre_relu=False, post_relu=False):
        calls.append((tuple(x.shape), pw.shape[-1], pre_relu, post_relu))
        return torch.empty(x.shape[:3] + (pw.shape[-1],), dtype=torch.bfloat16,
                           device=x.device)

    monkeypatch.setattr(layers, "fused_sepconv", stub)
    with torch.device("meta"):
        m = Xception(fused_inference=True).eval()
        for size, want in ((96, 34), (299, 30)):
            calls.clear()
            out = m(torch.empty(2, size, size, 3), features=True)
            assert out.shape == (2, 2048)
            assert len(calls) == want
    # at 299: block4 at 37x37, middle flow and block13 at 19x19, block14
    # at 10x10 with the post-ReLU
    assert calls[0][0][1:] == (37, 37, 256) and calls[0][1] == 728
    assert calls[-1][0][1:] == (10, 10, 1536) and calls[-1][1:] == (2048,
                                                                    False, True)


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


def test_load_model_is_seeded():
    a = load_model("Xception", num_classes=3,
                   generator=torch.Generator().manual_seed(5))
    b = load_model("xception", num_classes=3,
                   generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        load_model("Xception", weights="imagenet")
