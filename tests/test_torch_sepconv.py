"""The port's fused sepconv (sparkdl_tpu_torch/ops/sepconv.py) held against
the JAX package's on the CPU.

On the CPU the port's dispatcher takes its plain PyTorch version, so these
tests pin that version's math and rounding points to JAX's
``sepconv_reference`` and to the real Pallas kernel run through the Pallas
interpreter.  The CUDA kernel itself is held against the same plain version
on the card by ``chip_smoke.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.ops.sepconv import fused_sepconv_flat, pad_to_flat, unflatten
from sparkdl_tpu.ops.sepconv import sepconv_reference as jax_reference
from sparkdl_tpu_torch.ops import sepconv as port

# The SHAPES of tests/test_ops_sepconv.py: (h, w, c, f)
SHAPES = [
    (19, 19, 32, 40),
    (10, 10, 24, 48),
    (12, 9, 16, 16),
]
FLAGS = [(False, False), (True, False), (False, True)]

# Both sides round the depthwise sum to bf16 and return bf16; the sums are
# taken in another order, so a value that lands near a bf16 rounding
# boundary may round one bf16 step apart (relative 2^-8 = 0.4%), and that
# step is carried through the pointwise sum.  2e-2 covers a few such steps
# on outputs of magnitude ~1.
TOL = dict(rtol=2e-2, atol=2e-2)
# The Pallas kernel's bar against its own reference in tests/test_ops_sepconv.py.
KERNEL_TOL = dict(rtol=0.08, atol=0.05)


def _inputs(seed, n, h, w, c, f):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    dwk = rng.normal(0, 0.2, (3, 3, c)).astype(np.float32)
    pw = rng.normal(0, 0.05, (c, f)).astype(np.float32)
    scale = rng.normal(1, 0.1, (f,)).astype(np.float32)
    shift = rng.normal(0, 0.1, (f,)).astype(np.float32)
    return x, dwk, pw, scale, shift


def _port(arrs, pre_relu, post_relu, fn=port.fused_sepconv):
    out = fn(*[torch.from_numpy(a) for a in arrs], pre_relu=pre_relu,
             post_relu=post_relu)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("h,w,c,f", SHAPES)
@pytest.mark.parametrize("pre_relu,post_relu", FLAGS)
def test_port_matches_jax(h, w, c, f, pre_relu, post_relu):
    """Port reference == JAX reference, and == the Pallas kernel
    (interpreted, then unflattened)."""
    arrs = _inputs(h * 1000 + c, 2, h, w, c, f)
    got = _port(arrs, pre_relu, post_relu)
    assert got.shape == (2, h, w, f)

    jx = [jnp.asarray(a) for a in arrs]
    want = np.asarray(jax_reference(*jx, pre_relu=pre_relu,
                                    post_relu=post_relu), np.float32)
    np.testing.assert_allclose(got, want, **TOL)

    kern = fused_sepconv_flat(pad_to_flat(jx[0], h, w), *jx[1:], h, w,
                              pre_relu, post_relu, force="interpret")
    kern = np.asarray(unflatten(kern, h, w), np.float32)
    np.testing.assert_allclose(got, kern, **KERNEL_TOL)


def test_two_layer_chain_matches_jax():
    """Two chained layers (the Xception middle-flow pattern): the port's
    bf16 output feeds the next layer as the Pallas kernel's does."""
    h, w, c = 13, 13, 16
    x, dwk1, pw1, s1, t1 = _inputs(7, 2, h, w, c, c)
    _, dwk2, pw2, s2, t2 = _inputs(8, 2, h, w, c, c)
    a = port.fused_sepconv(*[torch.from_numpy(v) for v in
                             (x, dwk1, pw1, s1, t1)], pre_relu=True)
    b = port.fused_sepconv(a, *[torch.from_numpy(v) for v in
                                (dwk2, pw2, s2, t2)], pre_relu=True)
    xf = pad_to_flat(jnp.asarray(x), h, w)
    ka = fused_sepconv_flat(xf, jnp.asarray(dwk1), jnp.asarray(pw1),
                            jnp.asarray(s1), jnp.asarray(t1), h, w, True,
                            False, force="interpret")
    kb = fused_sepconv_flat(ka, jnp.asarray(dwk2), jnp.asarray(pw2),
                            jnp.asarray(s2), jnp.asarray(t2), h, w, True,
                            False, force="interpret")
    want = np.asarray(unflatten(kb, h, w), np.float32)
    # the Pallas kernel's chain bar in tests/test_ops_sepconv.py
    np.testing.assert_allclose(b.float().numpy(), want, rtol=0.1, atol=0.08)


def test_keras_layout_weights_and_counter():
    """Keras-shaped weights ([3,3,C,1], [1,1,C,F]) reshape as in JAX, and
    the CPU route launches no kernel: the count stays put."""
    arrs = list(_inputs(3, 1, 6, 5, 8, 12))
    before = port.fused_sepconv.launches
    flat = _port(arrs, True, True)
    arrs[1] = arrs[1][..., None]
    arrs[2] = arrs[2][None, None]
    np.testing.assert_array_equal(_port(arrs, True, True), flat)
    assert port.fused_sepconv.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: it raises."""
    x, dwk, pw, s, t = [torch.from_numpy(a) for a in _inputs(4, 1, 4, 4, 8, 8)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        port._fused_sepconv_cuda(x.bfloat16(), dwk.bfloat16(), pw.bfloat16(),
                                 s, t, False, False)


# The shapes the whole-image kernel's launch plan must take (n, h=w, c, f):
# Xception's six classes at batch 32, the tiled kernel's four entry classes
# (chip_smoke.py times B1 there too), a batch whose pixels are not a
# multiple of 64, an F that is not a multiple of any tile width, and the
# other ragged shapes chip_smoke.py holds B1 to (small batches at 10x10 and
# 19x19).
PLAN_SHAPES = [
    (32, 37, 256, 728), (32, 37, 728, 728), (32, 19, 728, 728),
    (32, 19, 728, 1024), (32, 10, 1024, 1536), (32, 10, 1536, 2048),
    (32, 147, 64, 128), (32, 147, 128, 128), (32, 74, 128, 256),
    (32, 74, 256, 256), (3, 19, 728, 728), (32, 19, 728, 200),
    (2, 10, 1024, 1536), (4, 19, 256, 728),
]


@pytest.mark.parametrize("n,hw,c,f", PLAN_SHAPES)
def test_sepconv_plan_fits_and_covers_f(n, hw, c, f):
    """Every plan fits one block's shared memory (the kernel's own formula)
    and its F groups and tiles cover F exactly: each 3*NT-wide F tile once,
    no group empty, less than one tile past F."""
    plan = port._sepconv_plan(n, hw, hw, c, f)
    tn = port._WGS * plan["n_tile"]
    assert plan["n_tile"] in port._N_TILES
    assert plan["kc"] in port._CHUNKS and plan["stages"] in port._STAGES
    assert plan["smem"] == port._sepconv_smem(hw, c, tn, plan["kc"],
                                              plan["stages"])
    assert plan["smem"] <= 232448
    groups, tpg = plan["groups"], plan["tiles_per_group"]
    tiles = []
    for g in range(groups):
        first = g * tpg * tn
        assert first < f, "a group starts past F"
        tiles += [first + t * tn for t in range(tpg) if first + t * tn < f]
    assert tiles == list(range(0, f, tn))
    assert 0 <= len(tiles) * tn - f < tn
    assert plan["blocks"] == -(-(n * hw * hw) // 64) * groups
    assert plan["waves"] == -(-plan["blocks"] // 132)


def test_sepconv_plan_fills_the_card_at_small_images():
    """At 10x10 a batch of 32 has only 50 pixel tiles for 132 SMs: the plan
    splits F over several blocks per pixel tile there, and at 37x37 (685
    tiles) it computes each pixel's depthwise once."""
    assert port._sepconv_plan(32, 10, 10, 1536, 2048)["groups"] >= 2
    assert port._sepconv_plan(32, 10, 10, 1024, 1536)["groups"] >= 2
    assert port._sepconv_plan(32, 37, 37, 728, 728)["groups"] == 1


@pytest.mark.parametrize("n,h,w,c,f,why", [
    (32, 10, 10, 2048, 2048, "depthwise tile"),   # 64x2048 bf16 > 227 KB
    (1, 8, 6000, 256, 256, "input window"),       # window of a 6000-wide row
    (2, 5, 5, 12, 16, "multiples of 8"),
])
def test_untakeable_shape_raises_in_the_wrapper(monkeypatch, n, h, w, c, f,
                                                why):
    """A shape no launch plan fits raises ``ValueError`` with the reason,
    from the plan and from the CUDA wrapper before any launch."""
    with pytest.raises(ValueError, match=why):
        port._sepconv_plan(n, h, w, c, f)
    if c % 8 == 0:
        # the wrapper's operand checks need a card; past them it must plan
        monkeypatch.setattr(port, "_check_sepconv_operands",
                            lambda *a: (n, h, w, c, f))
        monkeypatch.setattr(port, "_launch", lambda *a: pytest.fail(
            "launched an untakeable shape"))
        x = torch.zeros(n, h, w, c, dtype=torch.bfloat16)
        affine = torch.ones(f)
        before = port.fused_sepconv.launches
        with pytest.raises(ValueError, match=why):
            port._fused_sepconv_cuda(x, None, None, affine, affine, True,
                                     False)
        assert port.fused_sepconv.launches == before


# The TILED_SHAPES of tests/test_ops_sepconv.py: (h, w, c, f, row tile)
TILED_SHAPES = [
    (13, 11, 16, 16, 5),
    (19, 19, 32, 40, 7),
    (12, 9, 16, 24, 7),
]


@pytest.mark.parametrize("h,w,c,f,th", TILED_SHAPES)
@pytest.mark.parametrize("pre_relu,post_relu", [(True, False),
                                                (False, True)])
def test_tiled_route_matches_interpreted_kernel(h, w, c, f, th, pre_relu,
                                                post_relu):
    """``fused_sepconv(row_tile=th)`` == the row-tiled Pallas kernel,
    interpreted on its rows-rounded-up padded-flat layout and
    unflattened."""
    arrs = _inputs(h * 1000 + c + th, 2, h, w, c, f)
    x = torch.from_numpy(arrs[0])
    got = port.fused_sepconv(x, *[torch.from_numpy(a) for a in arrs[1:]],
                             pre_relu=pre_relu, post_relu=post_relu,
                             row_tile=th)
    assert got.dtype == torch.bfloat16 and got.shape == (2, h, w, f)
    jx = [jnp.asarray(a) for a in arrs]
    kern = fused_sepconv_flat(pad_to_flat(jx[0], h, w, row_tile=th), *jx[1:],
                              h, w, pre_relu, post_relu, force="interpret",
                              row_tile=th)
    kern = np.asarray(unflatten(kern, h, w), np.float32)
    np.testing.assert_allclose(got.float().numpy(), kern, **KERNEL_TOL)


def test_tiled_two_layer_chain_matches_jax():
    """sepconv1 -> sepconv2 of an entry block on the tiled route: the
    port's bf16 output feeds the next layer as the tiled Pallas kernel's
    does (no repacking between them there either)."""
    h, w, c, th = 13, 13, 16, 5
    x, dwk1, pw1, s1, t1 = _inputs(17, 2, h, w, c, c)
    _, dwk2, pw2, s2, t2 = _inputs(18, 2, h, w, c, c)
    a = port.fused_sepconv(*[torch.from_numpy(v) for v in
                             (x, dwk1, pw1, s1, t1)], row_tile=th)
    b = port.fused_sepconv(a, *[torch.from_numpy(v) for v in
                                (dwk2, pw2, s2, t2)], pre_relu=True,
                           row_tile=th)
    xf = pad_to_flat(jnp.asarray(x), h, w, row_tile=th)
    ka = fused_sepconv_flat(xf, jnp.asarray(dwk1), jnp.asarray(pw1),
                            jnp.asarray(s1), jnp.asarray(t1), h, w, False,
                            False, force="interpret", row_tile=th)
    kb = fused_sepconv_flat(ka, jnp.asarray(dwk2), jnp.asarray(pw2),
                            jnp.asarray(s2), jnp.asarray(t2), h, w, True,
                            False, force="interpret", row_tile=th)
    want = np.asarray(unflatten(kb, h, w), np.float32)
    # the tiled Pallas kernel's chain bar in tests/test_ops_sepconv.py
    np.testing.assert_allclose(b.float().numpy(), want, rtol=0.1, atol=0.08)


# The shapes the tiled kernel's launch plan must take (n, h, w, c, f): B3's
# four classes at batch 32, chip_smoke.py's TILED_RAGGED shapes and the
# 6000-pixel row the whole-image kernel refuses.
TILED_PLAN_SHAPES = [
    (32, 147, 147, 64, 128), (32, 147, 147, 128, 128),
    (32, 74, 74, 128, 256), (32, 74, 74, 256, 256),
    (3, 147, 147, 64, 128), (2, 13, 11, 128, 128), (4, 74, 74, 128, 200),
    (2, 37, 37, 72, 128), (2, 19, 23, 128, 328), (1, 8, 6000, 256, 256),
]


def _tiled_plans(n, h, w, c, f):
    """The plan's choice and every other plan the library instantiates."""
    yield port._sepconv_tiled_plan(n, h, w, c, f)
    for (th, tw), tf, st in itertools.product(port._T3_TILES,
                                              port._T3_F_TILES, range(2, 7)):
        plan = port._sepconv_tiled_candidate(n, h, w, c, f, th, tw, tf, st)
        if plan is not None:
            yield plan


@pytest.mark.parametrize("n,h,w,c,f", TILED_PLAN_SHAPES)
def test_sepconv_tiled_plan_fits_and_covers(n, h, w, c, f):
    """Every plan fits one block's shared memory by the kernel's own
    formula; its persistent grid's blocks walk every (image, tile, F tile)
    exactly once; its TMA box obeys the copy engine's limits."""
    for plan in _tiled_plans(n, h, w, c, f):
        th, tw, tf, st = (plan["tile_h"], plan["tile_w"], plan["f_tile"],
                          plan["stages"])
        assert (th, tw) in port._T3_TILES and th * tw == 64
        assert tf in port._T3_F_TILES and 2 <= st <= 6
        kp = -(-c // 64) * 64
        slot = -(-(th + 2) * (tw + 2) * 128 // 1024) * 1024
        assert plan["smem"] == port._sepconv_tiled_smem(th, tw, c, tf, st) \
            == st * slot + 256 * kp + 2 * kp * tf + 18 * kp + 8 * tf \
            + 24 * st + 1024
        assert plan["smem"] <= 232448
        # the kernel's walk: block b takes F tile b % FT and spatial tiles
        # b // FT, + S, + 2S, ... (S = grid / FT)
        ft = plan["f_tiles"]
        assert ft == -(-f // tf) and plan["grid"] % ft == 0
        walkers = plan["grid"] // ft
        tiles_h, tiles_w = -(-h // th), -(-w // tw)
        tiles = n * tiles_h * tiles_w
        assert plan["tiles"] == tiles
        seen = np.zeros((tiles, ft), np.int64)
        most = 0
        for b in range(plan["grid"]):
            mine = np.arange(b // ft, tiles, walkers)
            seen[mine, b % ft] += 1
            most = max(most, len(mine))
        assert (seen == 1).all() and most == plan["items"]
        # each item's 64 pixels and F tile cover the image and F: tile t
        # is image t // (tiles_h * tiles_w), origin (row, col) * (th, tw)
        assert tiles_h * th >= h > (tiles_h - 1) * th
        assert tiles_w * tw >= w > (tiles_w - 1) * tw
        assert ft * tf >= f > (ft - 1) * tf
        # the TMA box (64 channels, tw+2 columns, th+2 rows, one image):
        # inner box 128 bytes (a multiple of 16, the 128-byte swizzle's
        # span), each box side at most 256, global strides multiples of 16
        # bytes, and the slot a whole number of 1024-byte swizzle atoms
        box = (64, tw + 2, th + 2, 1)
        assert box[0] * 2 == 128 and all(1 <= b <= 256 for b in box)
        assert all(s % 16 == 0 for s in (c * 2, w * c * 2, h * w * c * 2))
        assert slot % 1024 == 0 and slot >= box[1] * box[2] * 128


def test_sepconv_tiled_plan_choices():
    """The entry classes' plans: one F tile each (the depthwise computed
    once per pixel), a two-stage ring, and at 256->256 the 128 KB
    pointwise slice with 8x8 tiles."""
    for n, h, w, c, f in TILED_PLAN_SHAPES[:4]:
        assert port._sepconv_tiled_plan(n, h, w, c, f)["f_tiles"] == 1
        assert port._sepconv_tiled_plan(n, h, w, c, f)["stages"] == 2
    plan = port._sepconv_tiled_plan(32, 74, 74, 256, 256)
    assert plan["f_tile"] == 256 and plan["tile_h"] == 8
    assert port._sepconv_tiled_plan(2, 19, 23, 128, 328)["f_tiles"] >= 2


@pytest.mark.parametrize("n,h,w,c,f,why", [
    (32, 74, 74, 1024, 256, "shared memory"),   # A and B of C = 1024
    (2, 5, 5, 12, 16, "multiples of 8"),
])
def test_untakeable_tiled_shape_raises_in_the_wrapper(monkeypatch, n, h, w,
                                                      c, f, why):
    """A shape no tiled plan fits raises ``ValueError`` with the reason,
    from the plan and from the CUDA wrapper before any launch."""
    with pytest.raises(ValueError, match=why):
        port._sepconv_tiled_plan(n, h, w, c, f)
    monkeypatch.setattr(port, "_check_sepconv_operands",
                        lambda *a: (n, h, w, c, f))
    monkeypatch.setattr(port, "_launch", lambda *a: pytest.fail(
        "launched an untakeable shape"))
    x = torch.zeros(n, h, w, c, dtype=torch.bfloat16)
    affine = torch.ones(f)
    before = port.fused_sepconv.tiled_launches
    with pytest.raises(ValueError, match=why):
        port._fused_sepconv_tiled_cuda(x, None, None, affine, affine, True,
                                       False)
    assert port.fused_sepconv.tiled_launches == before


def test_tiled_cuda_wrapper_refuses_cpu_tensors():
    x, dwk, pw, s, t = [torch.from_numpy(a) for a in _inputs(4, 1, 4, 4, 8, 8)]
    before = port.fused_sepconv.tiled_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        port._fused_sepconv_tiled_cuda(x.bfloat16(), dwk.bfloat16(),
                                       pw.bfloat16(), s, t, True, False)
    assert port.fused_sepconv.tiled_launches == before
