"""The port's InferenceEngine (sparkdl_tpu_torch/parallel/engine.py) held
against the JAX package's on the CPU: same pieces, same pad/trim, same
``engine.rows`` / ``engine.pad_rows`` ledger, same outputs."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

import sparkdl_tpu_torch as port_pkg
from sparkdl_tpu.parallel import mesh as jax_mesh
from sparkdl_tpu.parallel.engine import InferenceEngine as JaxEngine
from sparkdl_tpu_torch.parallel.engine import InferenceEngine

# f32 matmul of 6-wide rows on both sides: only the summation order differs.
TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(batch, rng, **kw):
    w = rng.normal(size=(6, 3)).astype(np.float32)
    jeng = JaxEngine(lambda v, x: x @ v["w"], {"w": w},
                     mesh=jax_mesh.get_mesh(num_devices=1),
                     device_batch_size=batch, **kw)
    lin = nn.Linear(6, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    peng = InferenceEngine(lambda m, x: m(x), lin, device="cpu",
                           device_batch_size=batch)
    return jeng, peng


def _ledger(eng):
    return {k: eng.metrics.counters.get(k, 0.0)
            for k in ("engine.rows", "engine.pad_rows")}


@pytest.mark.parametrize("chunks", [[10], [3, 5], [4, 4], [1]])
def test_map_batches_matches_jax(chunks):
    rng = np.random.default_rng(len(chunks) * 10 + chunks[0])
    jeng, peng = _pair(4, rng)
    data = [rng.normal(size=(n, 6)).astype(np.float32) for n in chunks]
    want = list(jeng.map_batches(data, pipeline=False))
    got = list(peng.map_batches(data))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert _ledger(peng) == _ledger(jeng)
    # rows are the real rows; pad tops each ragged piece up to the bucket
    assert _ledger(peng)["engine.rows"] == sum(chunks)
    pieces = [min(4, n - off) for n in chunks for off in range(0, n, 4)]
    assert _ledger(peng)["engine.pad_rows"] == sum(4 - p for p in pieces)


def test_call_pads_and_trims_like_jax():
    rng = np.random.default_rng(1)
    jeng, peng = _pair(8, rng)
    x = rng.normal(size=(19, 6)).astype(np.float32)
    np.testing.assert_allclose(peng(x), np.asarray(jeng(x, pipeline=False)),
                               **TOL)
    assert _ledger(peng) == _ledger(jeng) == {"engine.rows": 19.0,
                                              "engine.pad_rows": 5.0}
    with pytest.raises(ValueError):
        peng.run_padded(x[:3])
    with pytest.raises(ValueError):
        peng(x[:0])


def test_compute_dtype_fetch_then_widen_on_host():
    """bf16 compute: weights cast on the engine's copy only, output
    fetched as bf16 and widened to f32 on the host — the same values JAX's
    engine returns under the same contract."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    jeng = JaxEngine(lambda v, a: a.astype(jnp.bfloat16) @ v["w"], {"w": w},
                     mesh=jax_mesh.get_mesh(num_devices=1),
                     device_batch_size=4, compute_dtype=jnp.bfloat16,
                     output_host_dtype=np.float32)
    lin = nn.Linear(6, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    peng = InferenceEngine(lambda m, a: m(a.to(torch.bfloat16)), lin,
                           device="cpu", device_batch_size=4,
                           compute_dtype=torch.bfloat16,
                           output_host_dtype=np.float32)
    got = peng(x)
    assert got.dtype == np.float32
    assert lin.weight.dtype == torch.float32  # the caller's module is untouched
    # a bf16 product of 6 terms, accumulated in another order: one bf16 step
    np.testing.assert_allclose(got, np.asarray(jeng(x, pipeline=False)),
                               rtol=1e-2, atol=1e-2)


def test_default_device_context():
    lin = nn.Linear(2, 2)
    with port_pkg.default_device("cpu"):
        eng = InferenceEngine(lambda m, x: m(x), lin, device_batch_size=2)
    assert eng.device == torch.device("cpu")
    assert eng.num_devices == 1
