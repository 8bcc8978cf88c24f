"""The inputs are the seed's: the same seed gives the same images and
weights.  The struct column is the program's image schema."""

import numpy as np
import pytest
import torch

from bench_port.lib.harness import sub_seed
from bench_port.lib.images import smooth_images, struct_column
from bench_port.lib.weights import make_weights
from bench_port.reference import xception

BIG = 2**31 + 4321


def gen(seed):
    return torch.Generator().manual_seed(sub_seed(seed, "images"))


def test_images_and_weights_follow_the_seed():
    a = smooth_images(3, 32, 40, gen(BIG), torch.device("cpu"))
    b = smooth_images(3, 32, 40, gen(BIG), torch.device("cpu"))
    c = smooth_images(3, 32, 40, gen(BIG + 1), torch.device("cpu"))
    assert a.shape == (3, 32, 40, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    specs = xception.param_specs()[:8]
    w1 = make_weights(specs, torch.Generator().manual_seed(5),
                      torch.device("cpu"))
    w2 = make_weights(specs, torch.Generator().manual_seed(5),
                      torch.device("cpu"))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def test_sub_seeds_take_seeds_past_32_bits():
    assert sub_seed(2**33 + 7, "a") != sub_seed(7, "a")
    assert sub_seed(BIG, "a") != sub_seed(BIG, "b")
    assert 0 <= sub_seed(BIG, "a") < 2**63


def test_struct_column_is_the_programs_image_struct():
    from sparkdl_tpu_torch.image.io import arrowStructsToBatch
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                imageSchema)

    bgr = smooth_images(4, 6, 5, gen(3), torch.device("cpu")).numpy()
    valid = np.array([True, False, True, True])
    col = struct_column(bgr, valid)
    assert col.type == imageSchema
    assert col.to_pylist()[1] is None
    want = imageArrayToStruct(bgr[2])
    got = col.to_pylist()[2]
    assert got == want
    batch, ok = arrowStructsToBatch(col, 6, 5, compact=True)
    assert ok.tolist() == valid.tolist()
    assert np.array_equal(batch, bgr[valid][..., ::-1])
