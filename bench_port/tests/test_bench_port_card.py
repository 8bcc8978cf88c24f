"""On the card only (skipped elsewhere, decided inside the test): kernel B1
alone at each of its launch classes at batch 64, timed as chip_smoke.py
times it (CUDA graphs between CUDA events), against the benchmark's frozen
operations and bytes.  A share of the bound above 100% would mean the
frozen counts are too high.

    python -m pytest bench_port/tests/test_bench_port_card.py -m cuda
"""

import json
from pathlib import Path

import pytest
import torch

from bench_port.lib.yardstick import bound, graph_ms

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_b1_alone_stays_under_its_frozen_bound():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from sparkdl_tpu_torch.ops.sepconv import fused_sepconv

    cfg = json.loads((ROOT / "bench_port/configs/xception-bf16.json")
                     .read_text())
    g = torch.Generator(device="cuda").manual_seed(1)
    for c in cfg["b1_launch_classes"]:
        n, hw, ci, f = c["n"], c["hw"], c["c"], c["f"]
        x = torch.randn(n, hw, hw, ci, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        dwk = torch.randn(3, 3, ci, generator=g, device="cuda",
                          dtype=torch.bfloat16) / 3
        pw = torch.randn(ci, f, generator=g, device="cuda",
                         dtype=torch.bfloat16) / ci ** 0.5
        scale = torch.ones(f, device="cuda")
        shift = torch.zeros(f, device="cuda")
        with torch.no_grad():
            ms = graph_ms(lambda: fused_sepconv(x, dwk, pw, scale, shift,
                                                pre_relu=True))
        least_s, _ = bound(c["flops"], c["bytes"])
        share = least_s * 1e3 / ms * 100
        print(f"B1 {c['layers']}: {ms:.4f} ms, {share:.2f}% of its bound")
        assert 0 < share <= 100
