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


# The shapes the mbconv kernel's launch plan must take (n, h, w, c, f,
# forced tile kind): MobileNetV2's eight stride-1 classes at batch 32 and
# the ragged shapes chip_smoke.py holds B2 to (a pixel count that is not a
# multiple of 64 under a split, a ragged 2-D tile, a non-square image on
# both tile kinds, C = 968, F = 320 under a split).
CLASSES = [(32, 112, 112, 32, 16), (32, 56, 56, 144, 24),
           (32, 28, 28, 192, 32), (32, 14, 14, 384, 64),
           (32, 14, 14, 384, 96), (32, 14, 14, 576, 96),
           (32, 7, 7, 960, 160), (32, 7, 7, 960, 320)]
PLAN_SHAPES = [(*s, None) for s in CLASSES] + [
    (3, 7, 7, 960, 160, None), (32, 28, 28, 192, 32, "2d"),
    (2, 13, 11, 144, 24, None), (2, 13, 11, 144, 24, "2d"),
    (3, 7, 7, 968, 160, None), (3, 14, 14, 384, 320, None),
]


@pytest.mark.parametrize("n,h,w,c,f,tile", PLAN_SHAPES)
def test_mbconv_plan_fits_and_covers(n, h, w, c, f, tile):
    """Every plan is one the library instantiates, fits one block's shared
    memory (the kernel's own formula), covers F with whole tiles, C with
    one non-empty slice of KC chunks per cluster member and every pixel
    tile once, and launches whole clusters of at most 8 blocks."""
    plan = port._mbconv_plan(n, h, w, c, f, tile)
    tile2d = plan["tile"] == "2d"
    assert tile is None or plan["tile"] == tile
    s, tf, kc = plan["cluster"], plan["f_tile"], plan["kc"]
    assert s in port._MB_CLUSTERS and s <= 8
    assert tf in port._MB_F_TILES and kc in port._MB_CHUNKS
    assert plan["stages"] in port._MB_STAGES
    assert plan["smem"] == port._mbconv_smem(tile2d, w, tf, kc,
                                             plan["stages"], s)
    assert plan["smem"] <= 232448
    # F: whole tiles, less than one tile past F
    f_tiles = -(-f // tf)
    assert 0 <= f_tiles * tf - f < tf
    # C: the kernel's split of the chunks over the S members
    nk = -(-c // kc)
    slices = [(r * nk // s, (r + 1) * nk // s) for r in range(s)]
    assert slices[0][0] == 0 and slices[-1][1] == nk
    assert all(a < b for a, b in slices)          # no member without work
    assert all(b == a2 for (_, b), (a2, _) in zip(slices, slices[1:]))
    assert max(b - a for a, b in slices) == plan["chunks"]
    # pixels: block y walks tiles y, y + G, ... (one tile under a split)
    tiles = (n * -(-h // 8) * -(-w // 8)) if tile2d else -(-(n * h * w) // 64)
    g = plan["grid_y"]
    assert 1 <= g <= min(tiles, 65535)
    walked = sorted(t for y in range(g) for t in range(y, tiles, g))
    assert walked == list(range(tiles))
    assert plan["tiles_per_block"] == -(-tiles // g)
    if s > 1:
        assert g == tiles
    # grid x = S x F tiles: whole clusters
    assert plan["blocks"] == g * f_tiles * s and (f_tiles * s) % s == 0


def test_mbconv_plan_splits_c_at_small_images_and_tiles_wide_ones():
    """At 7x7 and 14x14 a batch of 32 has 25 and 98 flattened tiles for
    132 SMs: the plan splits C across a cluster there; at 112x112 and
    56x56 it takes 2-D tiles (fewer staged pixels) and no split; at 28x28
    and below it keeps the flattened tile."""
    plans = {(h, c, f): port._mbconv_plan(n, h, w, c, f)
             for n, h, w, c, f in CLASSES}
    for (h, c, f), plan in plans.items():
        assert (plan["cluster"] > 1) == (h <= 14), (h, c, f, plan)
        assert (plan["tile"] == "2d") == (h >= 56), (h, c, f, plan)
    assert plans[(112, 32, 16)]["cluster"] == 1
    assert plans[(7, 960, 160)]["cluster"] >= 4


def test_mbconv_plan_takes_2d_tiles_where_a_row_is_too_wide():
    """The flattened window grows with W; the 2-D tile's frame does not."""
    plan = port._mbconv_plan(1, 8, 6000, 256, 256)
    assert plan["tile"] == "2d" and plan["smem"] <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        port._mbconv_plan(1, 8, 6000, 256, 256, "flat")


@pytest.mark.parametrize("n,h,w,c,f,why", [
    (2, 5, 5, 12, 16, "multiples of 8"),
    (2, 5, 5, 16, 20, "multiples of 8"),
])
def test_untakeable_mbconv_shape_raises_in_the_wrapper(monkeypatch, n, h, w,
                                                       c, f, why):
    """A shape no launch plan fits raises ``ValueError`` with the reason,
    from the plan and from the CUDA wrapper before any launch."""
    with pytest.raises(ValueError, match=why):
        port._mbconv_plan(n, h, w, c, f)
    # the wrapper's operand checks need a card; past them it must plan
    monkeypatch.setattr(port, "_check_mbconv_operands",
                        lambda *a: (n, h, w, c, f))
    monkeypatch.setattr(port, "_launch", lambda *a: pytest.fail(
        "launched an untakeable shape"))
    x = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    before = port.fused_mbconv.launches
    with pytest.raises(ValueError, match=why):
        port._fused_mbconv_cuda(x, None, None, None, None)
    assert port.fused_mbconv.launches == before


def test_mbconv_wrapper_refuses_shapes_past_its_index_range(monkeypatch):
    """Offsets inside the kernel are 32-bit: a batch of 2**31 or more
    elements in x or out raises before any plan or launch."""
    n, h, w, c, f = 4096, 128, 128, 32, 16    # 2**31 elements of x
    monkeypatch.setattr(port, "_check_mbconv_operands",
                        lambda *a: (n, h, w, c, f))
    monkeypatch.setattr(port, "_launch", lambda *a: pytest.fail(
        "launched past the index range"))
    x = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="index range"):
        port._fused_mbconv_cuda(x, None, None, None, None)
