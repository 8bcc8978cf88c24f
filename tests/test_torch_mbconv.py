"""The port's fused mbconv (sparkdl_tpu_torch/ops/sepconv.py) held against the
JAX package's on the CPU.

On the CPU the port's dispatcher takes its plain PyTorch version, so these
tests pin that version's math and rounding points to JAX's
``mbconv_reference`` and to the real Pallas kernel (``_mbconv_kernel``)
run through the Pallas interpreter.  The CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.ops.sepconv import fused_mbconv_flat, pad_to_flat, unflatten
from sparkdl_tpu.ops.sepconv import mbconv_reference as jax_reference
from sparkdl_tpu_torch.ops import sepconv as port

# Both sides round the clamped depthwise to bf16 and return bf16; the sums
# are taken in another order, so a value near a bf16 rounding boundary may
# round one bf16 step apart (relative 2^-8) and that step is carried
# through the pointwise sum.  2e-2 covers a few such steps at |y| ~ 1.
TOL = dict(rtol=2e-2, atol=2e-2)
# The Pallas kernel's bar against its own reference in tests/test_ops_sepconv.py.
KERNEL_TOL = dict(rtol=0.08, atol=0.05)

# (h, w, c, f): the two shapes of test_mbconv_kernel_parity_interpreted, and
# a residual block's tail (the expanded C = 6F projected back to F).
SHAPES = [(13, 11, 16, 24), (14, 14, 48, 32), (9, 9, 96, 16)]


def _inputs(seed, n, h, w, c, f):
    """Folded weights as test_ops_sepconv.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    dwk = rng.normal(0, 0.3, (3, 3, c)).astype(np.float32)
    pw = rng.normal(0, 0.1, (c, f)).astype(np.float32)
    mid = rng.normal(0, 0.5, (c,)).astype(np.float32)
    shift = rng.normal(0, 0.2, (f,)).astype(np.float32)
    return x, dwk, pw, mid, shift


def _port(arrs, fn=port.fused_mbconv):
    out = fn(*[torch.from_numpy(a) for a in arrs])
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("h,w,c,f", SHAPES)
def test_reference_matches_jax_reference(h, w, c, f):
    arrs = _inputs(h * 100 + c, 2, h, w, c, f)
    got = _port(arrs, port.mbconv_reference)
    want = np.asarray(jax_reference(*[jnp.asarray(a) for a in arrs]),
                      np.float32)
    assert got.shape == want.shape == (2, h, w, f)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w,c,f", SHAPES)
def test_dispatcher_matches_interpreted_kernel(h, w, c, f):
    """``fused_mbconv`` on a CPU tensor == the Pallas kernel, interpreted
    on the padded-flat layout and unflattened."""
    arrs = _inputs(h * 100 + c + 1, 2, h, w, c, f)
    got = _port(arrs)
    jx = [jnp.asarray(a) for a in arrs]
    kern = fused_mbconv_flat(pad_to_flat(jx[0], h, w), *jx[1:], h, w,
                             force="interpret")
    kern = np.asarray(unflatten(kern, h, w), np.float32)
    assert got.shape == kern.shape
    np.testing.assert_allclose(got, kern, **KERNEL_TOL)


def test_keras_layout_weights_and_counter():
    """Keras-shaped weights ([3,3,C,1], [1,1,C,F]) reshape as in JAX, and
    the CPU route launches no kernel: the count stays put."""
    arrs = list(_inputs(5, 1, 6, 5, 8, 16))
    before = port.fused_mbconv.launches
    flat = _port(arrs)
    arrs[1] = arrs[1][..., None]
    arrs[2] = arrs[2][None, None]
    np.testing.assert_array_equal(_port(arrs), flat)
    assert port.fused_mbconv.launches == before


def test_clamp_and_rounding_points():
    """relu6 sits between the stages: a depthwise sum far above 6 or
    below 0 contributes 6 or 0 to the product, and the output is the
    bf16 rounding of the f32 sum + shift."""
    c, f = 8, 8
    x = torch.ones(1, 3, 3, c)
    dwk = torch.full((3, 3, c), 10.0)      # centre pixel sums 9 taps: 90
    pw = torch.eye(c, f)
    mid = torch.zeros(c)
    mid[1] = -200.0                       # channel 1 clamps to 0
    shift = torch.full((f,), 0.5)
    got = port.fused_mbconv(x, dwk, pw, mid, shift).float()
    assert got[0, 1, 1, 0].item() == 6.5 and got[0, 1, 1, 1].item() == 0.5


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: it raises."""
    x, dwk, pw, mid, sh = [torch.from_numpy(a)
                           for a in _inputs(4, 1, 4, 4, 8, 8)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        port._fused_mbconv_cuda(x.bfloat16(), dwk.bfloat16(), pw.bfloat16(),
                                mid, sh)
