"""The port's ImageNet preprocess modes (sparkdl_tpu_torch/models/
preprocess.py) held against the JAX package's on the same seeded uint8
batch."""

import numpy as np
import pytest
import torch

from sparkdl_tpu.models.preprocess import get_preprocess_fn as jax_fn
from sparkdl_tpu_torch.models.preprocess import (PREPROCESS_MODES,
                                                 get_preprocess_fn)


@pytest.mark.parametrize("mode", PREPROCESS_MODES)
def test_mode_matches_jax(mode):
    x = np.random.default_rng(5).integers(0, 256, (2, 7, 5, 3), np.uint8)
    got = get_preprocess_fn(mode)(torch.from_numpy(x))
    want = np.asarray(jax_fn(mode)(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    # the same f32 operations in the same order: equal to float rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unknown preprocess mode"):
        get_preprocess_fn("keras")
