"""bf16 heads in the port's head fan-out, held against the JAX package on
the CPU.

The JAX package serves a head whose kernel and bias are bfloat16 (ml_dtypes
arrays) over f32 feature rows and returns f32 rows; the port takes the same
heads as ml_dtypes arrays or as torch bf16 tensors.  Held here, with
features N(0, 1) and kernels N(0, 1/D) made by numpy from a seed:

* H1's plain version on bf16 weights against JAX's
  ``build_head_fanout_jit(dense_head_row)`` on the same ml_dtypes bank:
  within 1e-6 at D = 16, C = 4 and 1e-4 at D = 2048, C = 100 (only the sum
  order differs, as in ``tests/test_torch_head_kernel.py``);
* the bf16 pass equals the f32 pass over the widened weights bit for bit
  (an f32 x bf16 product promotes the weight exactly), so the kernel's
  bf16 bits are the plain version's;
* ``HeadBank``, ``HeadFanoutServer`` and ``Fleet`` with bf16 heads in both
  forms: rows within 1e-4 of JAX's ``HeadBank.dispatch``, bit for bit
  their per-tenant oracles (``dense_head_row``, a bank of one), and the
  bank's bytes (2 a weight) equal to JAX's; an f32 / bf16 mix falls back
  as JAX's does; the card's dtype refusals;
* digests of a torch bf16 tensor equal to JAX's of the ml_dtypes array.

The bf16 kernel itself runs only on the card:
``tests/test_torch_cuda.py::test_head_kernel_bf16_equals_plain_bit_for_bit``
and ``chip_smoke.py``'s ``[kernel] H1``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sparkdl_tpu_torch
from sparkdl_tpu.parallel import engine as jengine
from sparkdl_tpu.utils import digest as jdigest
from sparkdl_tpu_torch.ops import head as ph
from sparkdl_tpu_torch.ops import head_pass, head_pass_reference
from sparkdl_tpu_torch.parallel.engine import (HeadBank, dense_head_row,
                                               head_fanout_backbone_fn,
                                               head_fanout_module)
from sparkdl_tpu_torch.serving import HeadFanoutServer
from sparkdl_tpu_torch.serving.fleet import Fleet
from sparkdl_tpu_torch.utils import digest as pdigest

BF16 = jnp.bfloat16                 # ml_dtypes' bfloat16, a numpy dtype
D_IN, D_FEAT, CLASSES = 12, 16, 4
JAX_TOL = dict(rtol=0, atol=1e-4)   # the bank against JAX's: sum order only


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _torch_bf16(a: np.ndarray) -> torch.Tensor:
    """The torch bf16 tensor of an ml_dtypes array's bits."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _bank(seed, n, d, c, cap):
    """f32 features, int32 tenant rows and an ml_dtypes bf16 bank."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    kernel = (rng.normal(size=(cap, d, c)) / np.sqrt(d)).astype(BF16)
    bias = rng.normal(size=(cap, c)).astype(BF16)
    idx = rng.integers(0, cap, size=n).astype(np.int32)
    return feats, idx, kernel, bias


def _port(feats, idx, kernel, bias):
    return head_pass(torch.from_numpy(feats), torch.from_numpy(idx),
                     _torch_bf16(kernel), _torch_bf16(bias)).numpy()


def _head(seed, classes=CLASSES, dtype=BF16):
    rng = np.random.default_rng(300 + seed)
    return {"kernel": (rng.normal(size=(D_FEAT, classes))
                       / np.sqrt(D_FEAT)).astype(dtype),
            "bias": rng.normal(size=(classes,)).astype(dtype)}


def _as_torch(head):
    return {k: _torch_bf16(v) for k, v in head.items()}


def _feats(seed, n):
    return np.random.default_rng(400 + seed).normal(
        size=(n, D_FEAT)).astype(np.float32)


def _oracle(head, row):
    """The per-tenant oracle: one row through ``dense_head_row``."""
    with torch.inference_mode():
        return dense_head_row(head, torch.from_numpy(row)).numpy()


def _variables():
    rng = np.random.default_rng(0)
    return {"backbone": rng.normal(size=(D_IN, D_FEAT)).astype(np.float32)}


def _payload(seed):
    return np.random.default_rng(500 + seed).normal(
        size=(D_IN,)).astype(np.float32)


def _feature(x):
    with torch.inference_mode():
        return head_fanout_backbone_fn(head_fanout_module(_variables()),
                                       torch.from_numpy(x)).numpy()


# -- the head pass ---------------------------------------------------------

@pytest.mark.parametrize("d,c,atol", [(16, 4, 1e-6), (2048, 100, 1e-4)])
def test_bf16_plain_matches_jax_fanout(d, c, atol):
    """H1's plain version on a bf16 bank against JAX's stacked-head program
    on the same ml_dtypes bank: f32 rows, within ``atol``."""
    feats, idx, kernel, bias = _bank(1, 16, d, c, 8)
    fanout = jengine.build_head_fanout_jit(
        jengine.dense_head_row, jengine.resolve_engine_mesh(None))
    want = np.asarray(fanout({"kernel": kernel, "bias": bias},
                             jnp.asarray(idx), jnp.asarray(feats)))
    got = _port(feats, idx, kernel, bias)
    assert want.dtype == np.float32
    assert got.shape == (16, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("n,d,c", [(7, 2048, 100), (5, 24, 3), (3, 15, 129),
                                   (32, 256, 1000)])
def test_bf16_equals_f32_on_widened_weights(n, d, c):
    """A bf16 pass equals the f32 pass over the same weights widened, bit
    for bit, and its rows do not move with the batch."""
    feats, idx, kernel, bias = _bank(2, n, d, c, 6)
    got = _port(feats, idx, kernel, bias)
    wide = head_pass(torch.from_numpy(feats), torch.from_numpy(idx),
                     torch.from_numpy(kernel.astype(np.float32)),
                     torch.from_numpy(bias.astype(np.float32))).numpy()
    assert got.tobytes() == wide.tobytes()
    for r in range(n):
        alone = _port(feats[r:r + 1], idx[r:r + 1], kernel, bias)
        assert alone.tobytes() == got[r:r + 1].tobytes()


def test_cost_counts_the_weight_bytes():
    """``head_pass_cost`` counts 2 bytes a bf16 weight and 4 an f32 one
    (the f32 count is the one PROGRAMS_TORCH.lock.json's records hold),
    and the meta path passes the weight type on."""
    from sparkdl_tpu_torch.ops import sepconv as psep

    n, d, c, k = 5, 24, 3, 4
    f32 = ph.head_pass_cost(n, d, c, k)
    assert f32 == (2.0 * n * d * c,
                   4.0 * (n * d + k * (d * c + c) + n + n * c))
    assert ph.head_pass_cost(n, d, c, k, 4) == f32
    assert ph.head_pass_cost(n, d, c, k, 2) == (
        f32[0], 4.0 * (n * d + n + n * c) + 2.0 * k * (d * c + c))
    nodes = []
    feats = torch.zeros((n, d), device="meta")
    idx = torch.zeros(n, dtype=torch.int32, device="meta")
    with psep.meta_nodes(lambda *node: nodes.append(node)):
        for dtype in (torch.float32, torch.bfloat16):
            out = head_pass(feats, idx,
                            torch.zeros((k, d, c), dtype=dtype,
                                        device="meta"),
                            torch.zeros((k, c), dtype=dtype, device="meta"))
            assert out.dtype == torch.float32 and out.shape == (n, c)
    assert [node[3:] for node in nodes] == [
        ph.head_pass_cost(n, d, c, k, 4), ph.head_pass_cost(n, d, c, k, 2)]


@pytest.mark.parametrize("n,d,c,s", [
    (1, 2048, 100, 16), (1, 2048, 1000, 8), (7, 2048, 100, 8),
    (7, 2048, 1000, 1), (32, 2048, 129, 2), (32, 2048, 1000, 1),
    (1, 24, 3, 8), (2, 15, 129, 1), (400, 2048, 1, 1)])
def test_head_plan_spreads_short_passes_and_streams_long_ones(n, d, c, s):
    """The cluster size H1 is launched with: the largest of 1, 2, 4, 8, 16
    dividing P whose grid of n x ceil(C / 32) x S blocks stays within 320
    blocks (a one-row pass is spread over 64 blocks, a 32-row 1000-class
    pass streams from 1024)."""
    assert ph._head_plan(n, d, c) == s
    assert ph.head_partials(d) % s == 0


@pytest.mark.parametrize("feats_dtype,kernel_dtype,bias_dtype,match", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, "float32"),
    (torch.float32, torch.bfloat16, torch.float32, "bfloat16"),
    (torch.float32, torch.float32, torch.bfloat16, "float32"),
    (torch.float32, torch.float16, torch.float16, "bfloat16 weights"),
    (torch.float32, torch.float64, torch.float64, "bfloat16 weights"),
])
def test_kernel_contract_refuses_other_types(feats_dtype, kernel_dtype,
                                             bias_dtype, match):
    """The CUDA wrapper takes f32 features and f32 or bf16 weights of one
    type; anything else raises before any launch, nothing is cast."""
    before = head_pass.launches
    with pytest.raises(TypeError, match=match):
        ph._head_pass_cuda(torch.zeros((2, 8), dtype=feats_dtype),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros((1, 8, 3), dtype=kernel_dtype),
                           torch.zeros((1, 3), dtype=bias_dtype))
    assert head_pass.launches == before


# -- the entry points ------------------------------------------------------

@pytest.mark.parametrize("form", ["ml_dtypes", "torch"])
def test_head_bank_bf16_matches_jax(form):
    """One add / swap / remove sequence of bf16 heads through both banks:
    rows within 1e-4 of JAX's, every row its per-tenant oracle bit for
    bit, the bank stacked, and its bytes (2 a weight) equal to JAX's."""
    wrap = _as_torch if form == "torch" else dict
    jbank, pbank = jengine.HeadBank(), HeadBank()
    feats = _feats(1, 6)
    heads = {}
    for op, tenant, seed in [("add", "a", 0), ("add", "b", 1),
                             ("add", "c", 2), ("swap", "b", 7),
                             ("remove", "a", None), ("add", "d", 3)]:
        if seed is None:
            jbank.remove_head(tenant)
            pbank.remove_head(tenant)
            del heads[tenant]
            continue
        heads[tenant] = _head(seed)
        getattr(jbank, f"{op}_head")(tenant, heads[tenant])
        getattr(pbank, f"{op}_head")(tenant, wrap(heads[tenant]))
        ts = [pbank.tenants()[i % len(pbank)] for i in range(6)]
        got = pbank.dispatch(feats, ts)
        want = np.asarray(jbank.dispatch(feats, ts))
        assert got.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got, want, **JAX_TOL)
        for r, t in enumerate(ts):
            assert got[r].tobytes() == _oracle(heads[t], feats[r]).tobytes()
        pst, jst = pbank.stats(), jbank.stats()
        assert pbank.mode == jbank.mode == "stacked"
        assert (pst["param_bytes_total"], pst["param_bytes_per_chip"],
                pst["capacity"]) == (jst["param_bytes_total"],
                                     jst["param_bytes_per_chip"],
                                     jst["capacity"])
    one_head = (D_FEAT * CLASSES + CLASSES) * 2
    assert pbank.stats()["param_bytes_total"] == 4 * one_head


def test_both_forms_of_a_bf16_head_serve_the_same_bits():
    """A head given as ml_dtypes arrays and the same head as torch bf16
    tensors (on the CPU or as a view of other storage) give one bank, one
    signature and the same rows bit for bit."""
    head = _head(4)
    banks = [HeadBank() for _ in range(3)]
    banks[0].add_head("a", head)
    banks[1].add_head("a", _as_torch(head))
    storage = torch.zeros(D_FEAT * CLASSES + 1, dtype=torch.bfloat16)
    storage[1:] = _torch_bf16(head["kernel"]).reshape(-1)
    banks[2].add_head("a", {"kernel": storage[1:].view(D_FEAT, CLASSES),
                            "bias": _torch_bf16(head["bias"])})
    feats = _feats(2, 3)
    rows = [b.dispatch(feats, ["a"] * 3) for b in banks]
    assert rows[0].tobytes() == rows[1].tobytes() == rows[2].tobytes()
    for b in banks:
        b.add_head("b", _as_torch(_head(5)))
        assert b.mode == "stacked"


def test_bf16_feature_rows_are_widened():
    """bf16 feature rows (ml_dtypes or torch) serve as their f32 widening,
    bit for bit; the output is f32 (JAX's is bf16: it rounds bf16 x bf16
    products, ROADMAP.md §C)."""
    bank = HeadBank()
    bank.add_head("a", _head(6))
    rows16 = _feats(3, 4).astype(BF16)
    want = bank.dispatch(rows16.astype(np.float32), ["a"] * 4)
    for rows in (rows16, _torch_bf16(rows16)):
        got = bank.dispatch(rows, ["a"] * 4)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    one = _oracle(_head(6), rows16[0].astype(np.float32))
    with torch.inference_mode():
        assert dense_head_row(_head(6), _torch_bf16(
            rows16[0])).numpy().tobytes() == one.tobytes()


def test_mixed_f32_and_bf16_heads_fall_back_as_jax():
    """An f32 head and a bf16 head do not stack: both banks degrade to
    per-tenant dispatch, and every row is its oracle's bits (within 1e-4
    of JAX's)."""
    jbank, pbank = jengine.HeadBank(), HeadBank()
    heads = {"a": _head(0, dtype=np.float32), "b": _head(1)}
    for t, h in heads.items():
        jbank.add_head(t, h)
        pbank.add_head(t, h)
    assert pbank.mode == jbank.mode == "fallback"
    assert "mismatch" in pbank.stats()["fallback_reason"]
    feats = _feats(4, 4)
    ts = ["a", "b", "b", "a"]
    got = pbank.dispatch(feats, ts)
    np.testing.assert_allclose(got, np.asarray(jbank.dispatch(feats, ts)),
                               **JAX_TOL)
    for r, t in enumerate(ts):
        assert got[r].tobytes() == _oracle(heads[t], feats[r]).tobytes()
    pst, jst = pbank.stats(), jbank.stats()
    assert pst["param_bytes_total"] == jst["param_bytes_total"]


@pytest.mark.parametrize("weights,accepted", [
    ("bf16", True), ("f32", True), ("f64", False), ("f16", False),
    ("bf16 kernel, f32 bias", False)])
def test_card_takes_f32_or_bf16_heads_only(weights, accepted):
    """On the card a head of f32 or bf16 (kernel and bias of one type) is
    taken; float64, float16 or a mixed head raises NotImplementedError
    naming H1 before any copy, and the bank is unchanged."""
    head = _head(2, dtype=np.float32)
    head = {"bf16": _as_torch(_head(2)), "f32": head,
            "f64": {k: v.astype(np.float64) for k, v in head.items()},
            "f16": {k: v.astype(np.float16) for k, v in head.items()},
            "bf16 kernel, f32 bias": {"kernel": _head(2)["kernel"],
                                      "bias": head["bias"]}}[weights]
    bank = HeadBank()
    bank.device = torch.device("cuda")  # the refusal comes before any copy
    if accepted:
        bank.add_head("a", head)
        assert bank.tenants() == ["a"]
    else:
        with pytest.raises(NotImplementedError, match="H1"):
            bank.add_head("a", head)
        assert bank.tenants() == []


def _server(**kw):
    return HeadFanoutServer(head_fanout_backbone_fn,
                            head_fanout_module(_variables()),
                            model_desc="headfanout", max_batch_size=8,
                            max_wait_ms=0.5, cache=False, **kw)


@pytest.mark.parametrize("form", ["ml_dtypes", "torch"])
def test_fanout_server_serves_bf16_heads(form):
    """``HeadFanoutServer.add_head`` / ``swap_head`` and ``predict_batch``
    / ``predict`` with bf16 heads: one head pass a batch, rows within 1e-4
    of JAX's bank on the same feature rows and bit for bit their oracles,
    bank bytes equal to JAX's, a swap that recompiles no backbone."""
    wrap = _as_torch if form == "torch" else dict
    heads = {t: _head(i) for i, t in enumerate("abc")}
    jbank = jengine.HeadBank()
    xs = [_payload(i) for i in range(6)]
    ts = ["a", "b", "c", "a", "c", "b"]
    feats = np.stack([_feature(x) for x in xs])
    with _server() as srv:
        for t, h in heads.items():
            srv.add_head(t, wrap(h))
            jbank.add_head(t, h)
        rows = np.stack(srv.predict_batch(xs, ts))
        assert srv.metrics.counters["headfanout.head_passes"] == 1
        np.testing.assert_allclose(rows, np.asarray(jbank.dispatch(
            feats, ts)), **JAX_TOL)
        for r, t in enumerate(ts):
            assert rows[r].tobytes() == _oracle(heads[t],
                                                feats[r]).tobytes()
        assert (srv.head_stats()["param_bytes_total"]
                == jbank.stats()["param_bytes_total"])
        heads["b"] = _head(9)
        rep = srv.swap_head("b", wrap(heads["b"]))
        assert rep["no_backbone_recompile"] is True
        assert srv.predict(xs[1], "b").tobytes() == _oracle(
            heads["b"], feats[1]).tobytes()
        assert srv.head_stats()["mode"] == "stacked"


@pytest.mark.parametrize("form", ["ml_dtypes", "torch"])
def test_fleet_add_head_serves_bf16_heads(form):
    """``Fleet.add_head`` of bf16 heads on a fan-out entry: head versions
    whose digests do not depend on the head's form, rows bit for bit their
    oracles and within 1e-4 of JAX's bank."""
    wrap = _as_torch if form == "torch" else dict
    heads = {"a": _head(1), "b": _head(2)}
    jbank = jengine.HeadBank()
    with Fleet(max_batch_size=8, max_wait_ms=0.5) as fleet:
        fleet.add_fanout_model("multi", head_fanout_backbone_fn,
                               head_fanout_module(_variables()),
                               model_desc="headfanout")
        for t, h in heads.items():
            rep = fleet.add_head("multi", t, wrap(h))
            assert rep["head_version"] == 1
            jbank.add_head(t, h)
        entry = fleet.registry.entry("multi")
        for t, h in heads.items():
            assert (entry.heads[t][0].weights_digest
                    == pdigest.content_digest(h))
        for i, t in enumerate(["a", "b", "b"]):
            x = _payload(i)
            got = fleet.predict("multi", x, tenant=t)
            f = _feature(x)
            assert got.tobytes() == _oracle(heads[t], f).tobytes()
            np.testing.assert_allclose(
                got, np.asarray(jbank.dispatch(f[None], [t]))[0], **JAX_TOL)


# -- digests ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (16, 4), (2, 3, 5)])
def test_digest_of_a_torch_bf16_tensor_is_jaxs(shape):
    """``array_digest`` / ``content_digest`` of a torch bf16 tensor equal
    JAX's of the same values in an ml_dtypes array (dtype ``bfloat16``,
    the shape, the bytes), and differ from the f32 widening's."""
    a = np.random.default_rng(len(shape)).normal(size=shape).astype(BF16)
    t = _torch_bf16(a)
    want = jdigest.array_digest(a)
    assert pdigest.array_digest(t) == want == pdigest.array_digest(a)
    assert pdigest.content_digest(t) == jdigest.content_digest(a) == want
    assert pdigest.array_digest(t.float()) != want
    assert pdigest.content_digest(
        {"kernel": t}) == pdigest.content_digest({"kernel": a})
