"""The plain references: their FLOP counts recounted, their agreement with
the program's plain CPU route on seeded weights, and the float8 rounding
of the control."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.lib.harness import load_json, row_gaps
from bench_port.lib.images import smooth_images
from bench_port.lib.weights import make_weights
from bench_port.reference import inceptionv3, xception
from bench_port.reference.common import fp8_e4m3

ROOT = Path(__file__).resolve().parents[2]
ARCHS = {"inceptionv3": inceptionv3, "xception": xception}
CONFIGS = {"inceptionv3": "inceptionv3-bf16", "xception": "xception-bf16"}
MODEL = {"inceptionv3": "InceptionV3", "xception": "Xception"}


def weights(arch, seed=3):
    return make_weights(ARCHS[arch].param_specs(),
                        torch.Generator().manual_seed(seed),
                        torch.device("cpu"))


def images(n, seed=4):
    return smooth_images(n, 299, 299, torch.Generator().manual_seed(seed),
                         torch.device("cpu"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_frozen_flops_are_the_references(arch):
    cfg = load_json(ROOT / f"bench_port/configs/{CONFIGS[arch]}.json")
    w = weights(arch)
    x = torch.zeros(1, 299, 299, 3, dtype=torch.uint8)
    for cut, flops in cfg["flops_per_image"].items():
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            ARCHS[arch].forward(w, x, cut == "features")
        assert counter.get_total_flops() == flops


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reference_matches_the_programs_plain_route(arch):
    from sparkdl_tpu_torch.models import get_model_spec

    spec = get_model_spec(MODEL[arch])
    module = spec.build().eval()
    w = weights(arch)
    res = module.load_state_dict(w, strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    x = images(2)
    with torch.no_grad():
        for features in (True, False):
            got = module(spec.preprocess(x), features=features)
            want = ARCHS[arch].forward(w, x, features)
            assert row_gaps(got.numpy(), want.numpy()).max() < 1e-5


def test_b1_costs_are_the_programs():
    from sparkdl_tpu_torch.ops.sepconv import sepconv_cost

    cfg = load_json(ROOT / "bench_port/configs/xception-bf16.json")
    for c in cfg["b1_launch_classes"]:
        assert (c["flops"], c["bytes"]) == sepconv_cost(
            c["n"], c["hw"], c["hw"], c["c"], c["f"])


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([1.0, 1.0625, 1.125, -448.0, 3.0e-3])
    q = fp8_e4m3(t)
    assert q[0] == 1.0 and q[3] == -448.0
    assert abs(q[1] - 1.0) < 1e-6  # 1 + 1/16 rounds to 1 (3 bits)
    assert math.isclose(q[2].item(), 1.125)
    assert np.isfinite(q.numpy()).all()
