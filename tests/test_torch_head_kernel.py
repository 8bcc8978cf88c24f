"""Kernel H1's plain version (``sparkdl_tpu_torch/ops/head.py``) on the
CPU, held against the JAX package's head pass and against its own
contract.

The same seeded features (N(0, 1)) and heads (kernels N(0, 1/D)) go
through JAX's vmapped ``build_head_fanout_jit(dense_head_row)`` and through
``head_pass``: within 1e-6 at D = 16, C = 4 and 1e-4 at D = 2048, C = 100
(sums in another order).  Then the port's own contract, bit for bit: the
documented order (partials of D, each summed in order, added in order,
then the bias; every product and addition rounded on its own), spelled
out in numpy float32 scalars; a row's bits whatever the batch it rides
in; the dispatcher's device rule and refusals.  The kernel itself runs
only on the card: ``tests/test_torch_cuda.py::
test_head_kernel_equals_plain_bit_for_bit`` (marker ``cuda``) and
``chip_smoke.py``'s ``[kernel] H1``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.parallel import engine as jengine
from sparkdl_tpu_torch.ops import head as ph
from sparkdl_tpu_torch.ops import head_pass, head_pass_reference


def _bank(seed, n, d, c, cap):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    kernel = (rng.normal(size=(cap, d, c)) / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=(cap, c)).astype(np.float32)
    idx = rng.integers(0, cap, size=n).astype(np.int32)
    return feats, idx, kernel, bias


def _port(feats, idx, kernel, bias):
    return head_pass(*(torch.from_numpy(a) for a in (feats, idx, kernel,
                                                      bias))).numpy()


@pytest.mark.parametrize("d,c,atol", [(16, 4, 1e-6), (2048, 100, 1e-4)])
def test_plain_matches_jax_fanout(d, c, atol):
    """H1's plain version against JAX's stacked-head program
    (gather-by-index + vmap of ``dense_head_row``) on the same bank."""
    feats, idx, kernel, bias = _bank(1, 16, d, c, 8)
    fanout = jengine.build_head_fanout_jit(
        jengine.dense_head_row, jengine.resolve_engine_mesh(None))
    want = np.asarray(fanout({"kernel": kernel, "bias": bias},
                             jnp.asarray(idx), jnp.asarray(feats)))
    got = _port(feats, idx, kernel, bias)
    assert got.shape == (16, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("d,p", [(2048, 16), (24, 8), (12, 4), (6, 2),
                                 (15, 1), (0, 16)])
def test_partials_depend_on_d_only(d, p):
    assert ph.head_partials(d) == p


@pytest.mark.parametrize("d", [24, 15, 16])
def test_order_is_the_documented_one(d):
    """The plain version's bits are those of the order the kernel's source
    documents, written out with numpy float32 scalars: partial q sums
    d = q*L .. q*L+L-1 in order from +0.0, the partials are added in
    order, then the bias, each operation rounded on its own."""
    feats, idx, kernel, bias = _bank(2, 3, d, 3, 4)
    got = _port(feats, idx, kernel, bias)
    p = ph.head_partials(d)
    length = d // p
    f32 = np.float32
    for r in range(3):
        h = idx[r]
        for c in range(3):
            parts = []
            for q in range(p):
                acc = f32(0.0)
                for j in range(q * length, (q + 1) * length):
                    acc = f32(acc + f32(feats[r, j] * kernel[h, j, c]))
                parts.append(acc)
            y = parts[0]
            for part in parts[1:]:
                y = f32(y + part)
            y = f32(y + bias[h, c])
            assert got[r, c].tobytes() == y.tobytes(), (r, c)


@pytest.mark.parametrize("n", [1, 7, 32])
def test_row_bits_do_not_move_with_the_batch(n):
    """Each row of an n-row mixed-tenant pass equals that row alone (a
    pass of one, the per-tenant oracle's form) and the same row at another
    position in a shuffled pass, bit for bit."""
    feats, idx, kernel, bias = _bank(3, n, 256, 100, 64)
    whole = _port(feats, idx, kernel, bias)
    for r in range(n):
        alone = _port(feats[r:r + 1], idx[r:r + 1], kernel, bias)
        assert alone.tobytes() == whole[r:r + 1].tobytes()
    perm = np.random.default_rng(4).permutation(n)
    shuffled = _port(feats[perm], idx[perm], kernel, bias)
    assert shuffled.tobytes() == whole[perm].tobytes()


def test_repeated_tenants_and_dtypes():
    """Rows sharing a head read the same head; float64 runs in float64 on
    the CPU (the plain version takes any float dtype)."""
    feats, idx, kernel, bias = _bank(5, 6, 32, 5, 2)
    idx[:] = [1, 1, 0, 1, 0, 0]
    out = _port(feats, idx, kernel, bias)
    want = np.einsum("nd,ndc->nc", feats.astype(np.float64),
                     kernel[idx].astype(np.float64)) + bias[idx]
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    out64 = _port(feats.astype(np.float64), idx, kernel.astype(np.float64),
                  bias.astype(np.float64))
    assert out64.dtype == np.float64
    np.testing.assert_allclose(out64, want, rtol=0, atol=1e-12)


def test_dispatcher_device_rule_and_refusals():
    """A CPU tensor takes the plain version without counting a launch; a
    meta tensor takes the meta path (the kernel's output shape and dtype,
    one recorded node, no launch) and is held to the operand contract;
    grad-requiring operands raise (no backward); the CUDA wrapper refuses
    wrong dtypes and shapes before any launch."""
    from sparkdl_tpu_torch.ops import sepconv as psep

    feats, idx, kernel, bias = (torch.from_numpy(a)
                                for a in _bank(6, 4, 16, 3, 2))
    before = head_pass.launches
    assert torch.equal(head_pass(feats, idx, kernel, bias),
                       head_pass_reference(feats, idx, kernel, bias))
    assert head_pass.launches == before
    nodes = []
    with psep.meta_nodes(lambda *node: nodes.append(node)):
        out = head_pass(feats.to("meta"), idx.to("meta"), kernel.to("meta"),
                        bias.to("meta"))
        with pytest.raises(TypeError, match="int32"):
            head_pass(feats.to("meta"), idx.long().to("meta"),
                      kernel.to("meta"), bias.to("meta"))
    assert out.is_meta and out.shape == (4, 3) and out.dtype == torch.float32
    assert [n[0] for n in nodes] == ["H1"]
    assert nodes[0][3:] == ph.head_pass_cost(4, 16, 3, 2)
    assert head_pass.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        head_pass(feats, idx, kernel.clone().requires_grad_(), bias)
    with pytest.raises(TypeError, match="float32"):
        ph._head_pass_cuda(feats.double(), idx, kernel, bias)
    with pytest.raises(TypeError, match="int32"):
        ph._head_pass_cuda(feats, idx.long(), kernel, bias)
    with pytest.raises(ValueError, match="do not agree"):
        ph._head_pass_cuda(feats, idx, kernel, bias[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ph._head_pass_cuda(feats, idx, kernel.transpose(1, 2), bias)
    assert head_pass.launches == before

