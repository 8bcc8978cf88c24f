"""Scoring on a mesh of several devices in one process: the port's engine,
servers and fleet (``sparkdl_tpu_torch/parallel/{mesh,shard,engine}.py``)
held against the JAX package's ``tests/test_mesh_shard.py`` runtime tests
on the conftest's 8 virtual CPU devices.

The port's meshes are slots of the CPU (``["cpu"] * n``) of the same
shape as JAX's.  Each case runs the same numpy-seeded inputs through both
engines: the port is held to JAX at 1e-6 relative (the engine tests'
limit), and bit for bit to its own replicated oracle on the
broadcast-multiply-reduce model (``x @ w`` spelled as a broadcast multiply
and a sum, whose rows and columns keep their arithmetic wherever they sit;
the CPU's GEMM picks its micro-kernels by shape).  ``sharding_info()``'s
JAX keys are JAX's for the same mesh and rules.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import sparkdl_tpu_torch
from sparkdl_tpu.parallel import engine as jengine
from sparkdl_tpu.parallel import mesh as jmesh
from sparkdl_tpu_torch.parallel import mesh as mesh_lib
from sparkdl_tpu_torch.parallel import shard
from sparkdl_tpu_torch.parallel.engine import InferenceEngine

P = mesh_lib.P
RTOL = dict(rtol=1e-6, atol=1e-6)
# the budget buster's ``x @ kernel`` (128-term dots, 4,194,304 outputs):
# the CPU's GEMM sums a dot in an order that depends on the matrix's
# width, so a column slice moves a handful of outputs by up to ~1e-6
BUSTER_TOL = dict(rtol=1e-6, atol=2e-6)
JAX_INFO_KEYS = ("mesh_shape", "param_bytes_total", "param_bytes_per_chip",
                 "largest_replicated_leaf_bytes", "sharded_leaves",
                 "total_leaves", "sharded_vs_replicated_ratio", "sharded",
                 "sharding_digest")


@pytest.fixture(autouse=True)
def cpu():
    jengine.clear_engine_jit_cache()
    with sparkdl_tpu_torch.default_device("cpu"):
        yield
    jengine.clear_engine_jit_cache()


def _jwide(v, x):
    return jnp.tanh(x @ v["dense"]["kernel"] + v["dense"]["bias"])


def _wide(m, x):
    return torch.tanh(x @ m.dense.kernel + m.dense.bias)


def _bmr(m, x):
    """``_wide`` as a broadcast multiply and a sum along the contiguous
    last dimension: each output element sums its D products in an order
    fixed by D alone, whatever the rows or the columns beside it."""
    return torch.tanh((x[..., None, :] * m.dense.kernel.t()).contiguous()
                      .sum(-1) + m.dense.bias)


def _variables(rng, d=16, out=None):
    return {"dense": {
        "kernel": rng.normal(size=(d, out or d)).astype(np.float32),
        "bias": rng.normal(size=(out or d,)).astype(np.float32),
    }}


def _module(v):
    m = nn.Module()
    m.dense = nn.Module()
    for k in sorted(v["dense"]):
        m.dense.register_buffer(k, torch.from_numpy(
            np.array(v["dense"][k], copy=True)))
    return m


def _meshes(data, model):
    n = data * model
    return (mesh_lib.get_mesh(devices=["cpu"] * n, model_parallel=model),
            jmesh.get_mesh(num_devices=n, model_parallel=model))


def _same_jax_keys(info, jinfo, keys=JAX_INFO_KEYS):
    for k in keys:
        assert info[k] == jinfo[k], k


# ---------------------------------------------------------------------------
# the default mesh and placement
# ---------------------------------------------------------------------------

def test_default_mesh_is_one_device_on_the_cpu():
    m = mesh_lib.get_mesh()
    assert m.size == 1 and m.devices.flat[0] == torch.device("cpu")
    eng = InferenceEngine(_bmr, _module(_variables(np.random.default_rng(0))),
                          device_batch_size=4)
    assert eng.mesh.shape == {"data": 1, "model": 1}
    assert eng.num_devices == 1 and eng.sharding_info()["slots"] == ["cpu"]


def test_default_mesh_lists_every_visible_card(monkeypatch):
    """With N cards visible and ``cuda`` the default, the default mesh
    (and an engine's) is ``cuda:0 ... cuda:N-1``; a default device that
    names one card, or ``device=``, keeps that one card."""
    from sparkdl_tpu_torch.parallel.engine import resolve_engine_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with sparkdl_tpu_torch.default_device(None):
        m = mesh_lib.get_mesh()
        assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1",
                                                    "cuda:2"]
        assert m.shape == {"data": 3, "model": 1}
        assert resolve_engine_mesh().size == 3
        assert [str(d) for d in resolve_engine_mesh(
            device="cuda:1").devices.flat] == ["cuda:1"]
    with sparkdl_tpu_torch.default_device("cuda:2"):
        assert [str(d) for d in mesh_lib.get_mesh().devices.flat] == \
            ["cuda:2"]


def test_place_slices_per_slot_and_shares_replicated_copies():
    """``place`` is ``jax.device_put`` under NamedShardings: the same
    slices per slot as JAX's ``addressable_shards``, one copy per distinct
    device of a replicated leaf."""
    rng = np.random.default_rng(0)
    v = _variables(rng, d=8)
    pm, jm = _meshes(2, 4)
    specs = {"dense": {"kernel": P(None, "model"), "bias": P()}}
    placed = mesh_lib.place(v, {"dense": {
        k: mesh_lib.NamedSharding(pm, s) for k, s in specs["dense"].items()}})
    jplaced = jax.device_put(v, {"dense": {
        "kernel": jax.sharding.NamedSharding(jm, JP(None, "model")),
        "bias": jax.sharding.NamedSharding(jm, JP())}})
    for k in ("kernel", "bias"):
        got = placed["dense"][k].addressable_shards
        want = sorted(jplaced["dense"][k].addressable_shards,
                      key=lambda s: list(jm.devices.flat).index(s.device))
        assert [s.index for s in got] == [s.index for s in want]
        for s, w in zip(got, want):
            np.testing.assert_array_equal(s.data.numpy(), np.asarray(w.data))
    kernel = placed["dense"]["kernel"]
    assert kernel.slot(0, 2) is kernel.slot(1, 2)  # one copy per device
    assert len({id(t) for t in kernel.slots}) == 4  # one a column slice
    bias = placed["dense"]["bias"]
    assert len({id(t) for t in bias.slots}) == 1


def test_sharded_tensor_partitioned_forms_and_gathers():
    """Ops with a partitioned form run per shard and keep the split;
    every other op, and every kernel wrapper, gathers first; a write to
    any shard moves the version the fold caches key on."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    st = shard.ShardedTensor([w[:4].clone(), w[4:].clone()], 0)
    x = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    with torch.inference_mode():
        y = torch.nn.functional.linear(x, st, b)
        assert isinstance(y, shard.ShardedTensor) and y.split_dim == 1
        z = torch.relu(y * 2.0 + b)
        assert isinstance(z, shard.ShardedTensor)
        np.testing.assert_allclose(
            z.gather().numpy(),
            torch.relu((x @ w.t() + b) * 2.0 + b).numpy(), **RTOL)
        s = z.sum(0)  # across the rows, not the split: per shard
        assert isinstance(s, shard.ShardedTensor) and s.split_dim == 0
        t = z.t()  # the split moves with its dimension
        assert isinstance(t, shard.ShardedTensor) and t.split_dim == 0
        flat = z.reshape(-1)  # a view across the split: gathered
        assert not isinstance(flat, shard.ShardedTensor)
        np.testing.assert_array_equal(flat.numpy(),
                                      z.gather().reshape(-1).numpy())
    assert st.data_ptr() == st.shards[0].data_ptr()
    v0 = st._version
    st.copy_(torch.zeros(8, 6))
    assert st._version > v0 and float(st.shards[1].abs().sum()) == 0.0
    dwk = shard.ShardedTensor([torch.zeros(3, 3, 4), torch.zeros(3, 3, 4)], 2)
    assert not isinstance(shard.gathered(dwk)[0], shard.ShardedTensor)


# ---------------------------------------------------------------------------
# engine parity (tests/test_mesh_shard.py:122, :151)
# ---------------------------------------------------------------------------

def test_engine_sharded_vs_replicated_tp8():
    rng = np.random.default_rng(1)
    v = _variables(rng)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    pm, jm = _meshes(1, 8)
    rules = mesh_lib.default_partition_rules
    e_rep = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=16)
    e_tp = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=16,
                           partition_rules=rules)
    # the kernel really is split: each slot holds a (16, 2) column slice
    shards = e_tp.leaf_shards("dense/kernel")
    assert len(shards) == 8 and shards[0].data.shape == (16, 2)
    assert shards[3].index[1] == slice(6, 8)
    np.testing.assert_array_equal(shards[3].data.numpy(),
                                  v["dense"]["kernel"][:, 6:8])
    assert e_tp.sharding_digest != e_rep.sharding_digest
    assert e_tp._layout != e_rep._layout
    np.testing.assert_array_equal(e_tp(x), e_rep(x))
    # JAX's engine on its 8 devices, and the port's matmul spelling
    j_tp = jengine.InferenceEngine(_jwide, v, mesh=jm, device_batch_size=16,
                                   partition_rules=jmesh.
                                   default_partition_rules)
    p_tp = InferenceEngine(_wide, _module(v), mesh=pm, device_batch_size=16,
                           partition_rules=rules)
    want = np.asarray(j_tp(x))
    np.testing.assert_allclose(p_tp(x), want, **RTOL)
    np.testing.assert_allclose(e_tp(x), want, **RTOL)
    info = e_tp.sharding_info()
    _same_jax_keys(info, j_tp.sharding_info())
    assert info["sharded"] and info["sharded_leaves"] == 1
    assert info["param_bytes_per_chip"] == (16 * 16 * 4 - 16 * 16 * 4
                                            + 16 * 16 * 4 // 8 + 16 * 4)
    # measured: the fullest slot reads its slice and the bias; the CPU
    # holds each byte once however many slots share it
    assert info["param_bytes_per_slot"] == info["param_bytes_per_chip"]
    assert info["bytes_per_device"] == {"cpu": 16 * 16 * 4 + 16 * 4}


def test_engine_explicit_param_shardings_and_grouped_dispatch():
    rng = np.random.default_rng(2)
    v = _variables(rng)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    pm, jm = _meshes(2, 4)  # dp2 x tp4
    ref = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=16)(x)
    one = InferenceEngine(_bmr, _module(v), device_batch_size=16)(x)
    np.testing.assert_array_equal(ref, one)
    e_exp = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=16,
                            param_shardings={"dense.bias": P(),
                                             "dense.kernel": P(None,
                                                               "model")})
    assert e_exp.sharding_info()["sharded_leaves"] == 1
    np.testing.assert_array_equal(e_exp(x), ref)
    # the grouped dispatch shards the same way
    e_grp = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=16,
                            partition_rules=mesh_lib.default_partition_rules,
                            batches_per_dispatch=2)
    got = np.concatenate(list(e_grp.map_batches([x], pipeline=False)))
    np.testing.assert_array_equal(got, ref)
    j_grp = jengine.InferenceEngine(
        _jwide, v, mesh=jm, device_batch_size=16,
        partition_rules=jmesh.default_partition_rules,
        batches_per_dispatch=2)
    want = np.concatenate(list(j_grp.map_batches([x])))
    np.testing.assert_allclose(got, want, **RTOL)
    _same_jax_keys(e_grp.sharding_info(), j_grp.sharding_info())


# ---------------------------------------------------------------------------
# servers and the fleet (tests/test_mesh_shard.py:173, :201, :485)
# ---------------------------------------------------------------------------

def test_server_sharded_parity_dp2tp4():
    """Sharded and replicated servers on the same dp2 x tp4 mesh serve the
    same rows bit for bit (JAX's own pair misses by an ulp there), within
    1e-6 of JAX's sharded server, and varz reports the layout."""
    from sparkdl_tpu.serving.server import Server as JServer
    from sparkdl_tpu_torch.serving.server import Server

    rng = np.random.default_rng(3)
    v = _variables(rng, d=8)
    rows = [rng.normal(size=(8,)).astype(np.float32) for _ in range(12)]
    pm, jm = _meshes(2, 4)
    kw = dict(max_batch_size=8, max_wait_ms=2, bucket_sizes=[4, 8],
              cache=False)

    def run(rules):
        with Server(_bmr, _module(v), mesh=pm, partition_rules=rules,
                    **kw) as srv:
            srv.warmup(rows[0])
            return ([srv.predict(r) for r in rows],
                    srv.varz()["sharding"])

    tp_outs, tp_info = run(mesh_lib.default_partition_rules)
    rep_outs, rep_info = run(None)
    for a, b in zip(tp_outs, rep_outs):
        np.testing.assert_array_equal(a, b)
    assert tp_info["sharded"] and not rep_info["sharded"]
    assert tp_info["mesh_shape"] == {"data": 2, "model": 4}
    assert tp_info["param_bytes_per_chip"] < rep_info["param_bytes_per_chip"]
    with JServer(_jwide, v, mesh=jm,
                 partition_rules=jmesh.default_partition_rules,
                 **kw) as jsrv:
        jsrv.warmup(rows[0])
        want = [np.asarray(jsrv.predict(r)) for r in rows]
        jinfo = jsrv.varz()["sharding"]
    for a, b in zip(tp_outs, want):
        np.testing.assert_allclose(a, b, **RTOL)
    _same_jax_keys(tp_info, jinfo)


def test_fleet_exposes_partition_rules_knob():
    from sparkdl_tpu.serving.fleet import Fleet as JFleet
    from sparkdl_tpu_torch.serving.fleet import Fleet

    rng = np.random.default_rng(4)
    v = _variables(rng, d=8)
    row = rng.normal(size=(8,)).astype(np.float32)
    pm, jm = _meshes(1, 8)
    kw = dict(max_batch_size=8, bucket_sizes=[8], max_wait_ms=2,
              warm_example=np.zeros((8,), np.float32))
    fleet = Fleet(cache=False)
    try:
        fleet.add_model("wide", _bmr, _module(v), mesh=pm,
                        partition_rules=mesh_lib.default_partition_rules,
                        **kw)
        out = fleet.submit("wide", row, tenant="t").result(timeout=30)
        assert out.shape == (8,)
        info = fleet._state("wide").server.sharding_info()
        assert info["sharded"] and info["mesh_shape"]["model"] == 8
    finally:
        fleet.close()
    jfleet = JFleet(cache=False)
    try:
        jfleet.add_model("wide", _jwide, v, mesh=jm,
                         partition_rules=jmesh.default_partition_rules,
                         **kw)
        want = np.asarray(jfleet.submit("wide", row, tenant="t").result(
            timeout=30))
        jinfo = jfleet._state("wide").server.sharding_info()
    finally:
        jfleet.close()
    np.testing.assert_allclose(out, want, **RTOL)
    _same_jax_keys(info, jinfo)


def test_fleet_zoo_overrides_survive_explicit_dtype():
    """A caller pinning ``compute_dtype`` does not drop the entry's other
    overrides (``partition_rules``, ``donate_batch``), on a real
    model-split mesh, as in JAX's fleet."""
    from sparkdl_tpu_torch.serving.fleet import Fleet

    v = _variables(np.random.default_rng(11), d=8)
    pm, _ = _meshes(1, 8)
    module = _module(v)
    entry = SimpleNamespace(
        fn=_bmr, engine_overrides={
            "donate_batch": False,
            "partition_rules": mesh_lib.default_partition_rules,
            "compute_dtype": torch.bfloat16,
            "output_host_dtype": np.float32},
        version_module=lambda mv: module)
    mv = SimpleNamespace(version=1, variables=None)
    fleet = Fleet(cache=False, donate_batch=True)
    try:
        srv = fleet._build_server(
            entry, mv, {"compute_dtype": None, "mesh": pm,
                        "max_batch_size": 8, "bucket_sizes": [8]})
        try:
            assert srv._compute_dtype is None
            assert srv._partition_rules is mesh_lib.default_partition_rules
            assert srv._donate_batch is False
            out = srv.predict(np.ones(8, np.float32))
            assert out.dtype == np.float32 and out.shape == (8,)
            assert srv.sharding_info()["sharded_leaves"] == 1
        finally:
            srv.close(drain=False)
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the budget buster (tests/test_mesh_shard.py:282)
# ---------------------------------------------------------------------------

def test_budget_buster_serves_split_under_the_budget():
    """The wide-dense model at the lockfile's 128 x 131072 shape (a 64 MB
    kernel, over GC005's 32 MB budget) on dp1 x tp8: each slot holds 8 MiB
    of kernel and the bias, and the rows are the one-device engine's and
    JAX's tensor-parallel engine's."""
    from sparkdl_tpu.analysis.program import inventory as jinv
    from sparkdl_tpu_torch.analysis.program.audit import (
        REPLICATED_PARAM_BUDGET_BYTES)
    from sparkdl_tpu_torch.analysis.program.inventory import (
        WIDE_DENSE_IN, WIDE_DENSE_OUT, wide_dense_fn)

    rng = np.random.default_rng(8)
    v = {"dense": {"kernel": rng.normal(
        scale=0.05, size=(WIDE_DENSE_IN, WIDE_DENSE_OUT)).astype(
            np.float32),
        "bias": rng.normal(size=(WIDE_DENSE_OUT,)).astype(np.float32)}}
    x = rng.normal(size=(32, WIDE_DENSE_IN)).astype(np.float32)
    pm, jm = _meshes(1, 8)
    tp = InferenceEngine(wide_dense_fn, _module(v), mesh=pm,
                         device_batch_size=32,
                         partition_rules=mesh_lib.default_partition_rules)
    info = tp.sharding_info()
    assert info["param_bytes_total"] > REPLICATED_PARAM_BUDGET_BYTES
    assert info["param_bytes_per_chip"] < REPLICATED_PARAM_BUDGET_BYTES
    assert info["param_bytes_per_slot"] == (
        WIDE_DENSE_IN * WIDE_DENSE_OUT * 4 // 8 + WIDE_DENSE_OUT * 4)
    got = tp(x)
    del tp
    oracle = InferenceEngine(wide_dense_fn, _module(v), device_batch_size=32)
    np.testing.assert_allclose(got, oracle(x), **BUSTER_TOL)
    del oracle
    j_tp = jengine.InferenceEngine(
        jinv.wide_dense_fn, v, mesh=jm, device_batch_size=32,
        partition_rules=jmesh.default_partition_rules)
    np.testing.assert_allclose(got, np.asarray(j_tp(x)), **BUSTER_TOL)
    _same_jax_keys(info, j_tp.sharding_info())


# ---------------------------------------------------------------------------
# ragged cuts on dp4 (tests/test_mesh_shard.py:390)
# ---------------------------------------------------------------------------

def test_ragged_cuts_stay_mesh_aligned_dp4():
    """On dp4 every ragged cut lands on a mesh-rounded bucket: a 20-deep
    queue dispatches as 12 + 8 with zero pad rows and a 5-deep residual
    pads 3 rows to the 8 bucket, JAX's exact pad rows."""
    from sparkdl_tpu_torch.serving.server import Server
    from sparkdl_tpu_torch.utils.metrics import Metrics

    rng = np.random.default_rng(5)
    v = _variables(rng, d=8)
    pm, _ = _meshes(4, 1)
    rows = [rng.normal(size=(8,)).astype(np.float32) for _ in range(25)]
    metrics = Metrics()
    with Server(_bmr, _module(v), mesh=pm, max_batch_size=24,
                max_wait_ms=25, bucket_sizes=[6, 12, 24], ragged=True,
                cache=False, max_inflight_batches=1,
                metrics=metrics) as srv:
        assert srv.bucket_sizes == [8, 12, 24]  # mesh-rounded
        assert srv._batcher.bucket_plan == [8, 12, 24]
        assert srv._batcher.align == 4
        srv.warmup(rows[0])
        warm = dict(metrics.snapshot_raw()["counters"])
        futs = [srv.submit(r) for r in rows[:20]]
        outs = [f.result(timeout=30) for f in futs]
        counters = metrics.snapshot_raw()["counters"]
        assert counters.get("engine.pad_rows", 0) == warm.get(
            "engine.pad_rows", 0)
        futs = [srv.submit(r) for r in rows[20:]]
        outs += [f.result(timeout=30) for f in futs]
        counters = metrics.snapshot_raw()["counters"]
        assert (counters.get("engine.pad_rows", 0)
                - warm.get("engine.pad_rows", 0)) == 3
    ref = np.tanh(np.stack(rows) @ v["dense"]["kernel"]
                  + v["dense"]["bias"]).astype(np.float32)
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o, r, **RTOL)


# ---------------------------------------------------------------------------
# spec fallbacks (tests/test_mesh_shard.py:435, :463)
# ---------------------------------------------------------------------------

def test_engine_indivisible_explicit_spec_falls_back_to_replicated():
    rng = np.random.default_rng(9)
    v = {"dense": {"kernel": rng.normal(size=(16, 12)).astype(np.float32),
                   "bias": rng.normal(size=(12,)).astype(np.float32)}}

    def fn(m, x):
        return torch.tanh(x @ m.dense.kernel)

    def jfn(vv, x):
        return jnp.tanh(x @ vv["dense"]["kernel"])

    pm, jm = _meshes(1, 8)  # 12 % 8 != 0
    eng = InferenceEngine(fn, _module(v), mesh=pm, device_batch_size=8,
                          param_shardings={"dense.bias": P(),
                                           "dense.kernel": P(None, "model")})
    assert eng._param_specs is None  # both leaves fell back -> collapse
    assert not eng.sharding_info()["sharded"]
    x = rng.normal(size=(8, 16)).astype(np.float32)
    jeng = jengine.InferenceEngine(
        jfn, v, mesh=jm, device_batch_size=8,
        param_shardings={"dense": {"kernel": JP(None, "model"),
                                   "bias": JP()}})
    assert jeng.param_shardings is None
    np.testing.assert_allclose(eng(x), np.tanh(x @ v["dense"]["kernel"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(eng(x), np.asarray(jeng(x)), **RTOL)
    with pytest.raises(ValueError, match="mirror the params"):
        InferenceEngine(fn, _module(v), mesh=pm, device_batch_size=8,
                        param_shardings=[P(None, "model"), P()])


def test_none_only_specs_collapse_like_empty():
    """``P(None, None)`` names no axis: it collapses as ``P()`` does, to
    the same digest, policy string and graph layout key as no policy."""
    v = _variables(np.random.default_rng(10))
    pm, jm = _meshes(1, 8)
    e_spelled = InferenceEngine(
        _bmr, _module(v), mesh=pm, device_batch_size=8,
        param_shardings={"dense.bias": P(), "dense.kernel": P(None, None)})
    e_plain = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=8)
    j_spelled = jengine.InferenceEngine(
        _jwide, v, mesh=jm, device_batch_size=8,
        param_shardings={"dense": {"kernel": JP(None, None),
                                   "bias": JP()}})
    assert e_spelled.sharding_digest == "replicated" == \
        j_spelled.sharding_digest
    assert e_spelled.compile_policy() == e_plain.compile_policy() == \
        j_spelled.compile_policy()
    assert e_spelled._layout == e_plain._layout
    assert e_spelled.sharding_info()["split_groups"] is None


# ---------------------------------------------------------------------------
# the compile cache's policy on a real two-device mesh
# ---------------------------------------------------------------------------

def test_compile_cache_policy_flip_purges_on_a_two_slot_mesh(tmp_path):
    from sparkdl_tpu_torch.parallel import compile_cache

    v = _variables(np.random.default_rng(6))
    pm, jm = _meshes(1, 2)
    e_rep = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=8)
    e_tp = InferenceEngine(_bmr, _module(v), mesh=pm, device_batch_size=8,
                           partition_rules=mesh_lib.default_partition_rules)
    j_tp = jengine.InferenceEngine(
        _jwide, v, mesh=jm, device_batch_size=8,
        partition_rules=jmesh.default_partition_rules)
    assert e_tp.compile_policy() == j_tp.compile_policy()
    assert e_rep.compile_policy() != e_tp.compile_policy()
    d = str(tmp_path / "cc")
    try:
        st = compile_cache.configure(d, policy=e_rep.compile_policy())
        assert st["invalidated"] is False
        st = compile_cache.configure(d, policy=e_tp.compile_policy())
        assert st["invalidated"] is True and st["drift_rules"] == ["GC005"]
    finally:
        compile_cache._reset_for_tests()


# ---------------------------------------------------------------------------
# the head bank on a data axis
# ---------------------------------------------------------------------------

def test_head_bank_rows_split_over_the_data_axis():
    """dp4: a pass's rows pad to a multiple of 4 and split over the four
    groups (one head pass each); every row is the one-device bank's."""
    from sparkdl_tpu_torch.ops import head as head_ops
    from sparkdl_tpu_torch.parallel.engine import HeadBank

    rng = np.random.default_rng(12)
    heads = {t: {"kernel": rng.normal(size=(6, 3)).astype(np.float32),
                 "bias": rng.normal(size=(3,)).astype(np.float32)}
             for t in "abc"}
    feats = rng.normal(size=(7, 6)).astype(np.float32)
    tenants = list("abcabca")
    banks = HeadBank(mesh=_meshes(4, 1)[0]), HeadBank(device="cpu")
    for b in banks:
        for t, h in heads.items():
            b.add_head(t, h)
    calls = []
    real = head_ops.head_pass_reference

    def spy(f, *a):
        calls.append(f.shape[0])
        return real(f, *a)

    head_ops.head_pass_reference = spy
    try:
        got = banks[0].dispatch(feats, tenants)
    finally:
        head_ops.head_pass_reference = real
    assert calls == [2, 2, 2, 2]
    np.testing.assert_array_equal(got, banks[1].dispatch(feats, tenants))
    assert banks[0].stats()["mesh_shape"] == {"data": 4, "model": 1}


# ---------------------------------------------------------------------------
# the zoo: Xception (B1's plain version on the CPU) on two slots
# ---------------------------------------------------------------------------

FUSED_TOL = dict(rtol=5e-2, atol=2e-2)  # tests/test_torch_xception.py's


@pytest.fixture(scope="module")
def xception_setup():
    """JAX Xception's variables at 71x71 (its smallest input) from
    ``eval_shape`` shapes filled by numpy, and the port's module of
    them."""
    from sparkdl_tpu.models.xception import Xception as JaxXception
    from sparkdl_tpu_torch.models import convert
    from sparkdl_tpu_torch.models.xception import Xception

    rng = np.random.default_rng(21)
    x = (rng.random((4, 71, 71, 3)) * 2 - 1).astype(np.float32)
    jm = JaxXception(num_classes=1000, fused_inference=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            train=False))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        scale = 1.0 if "scale" in name else 0.05
        base = 1.0 if "scale" in name else 0.0
        return (base + rng.normal(0, scale if base == 0 else 0.1,
                                  leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pm = Xception(num_classes=1000, fused_inference=True)
    pm.load_state_dict(convert.state_dict_from_jax("Xception", variables))
    return x, jm, variables, pm.eval()


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_zoo_xception_on_two_slots(xception_setup, data, model):
    """Xception's fused route (B1's plain version) at 71x71, batch 4, on
    dp2 x tp1 and dp1 x tp2 of ``["cpu"] * 2`` under the zoo's default
    rules: held to the port's one-device engine, and to JAX's engine on
    the same mesh shape, at the fused route's CPU tolerance."""
    from sparkdl_tpu_torch.ops import sepconv

    x, jm, variables, module = xception_setup

    def fn(m, xb):
        return m(xb, features=True)

    def jfn(v, xb):
        return jm.apply(v, xb, train=False, features=True)

    pmesh, jmesh_ = _meshes(data, model)
    rules = mesh_lib.default_partition_rules
    calls = []
    real = sepconv.sepconv_reference

    def spy(xx, *a, **k):
        calls.append(xx.shape[0])
        return real(xx, *a, **k)

    sepconv.sepconv_reference = spy
    try:
        one = InferenceEngine(fn, module, device_batch_size=4)(x)
        per_forward = len(calls)
        del calls[:]
        eng = InferenceEngine(fn, module, mesh=pmesh, device_batch_size=4,
                              partition_rules=rules)
        got = eng(x)
    finally:
        sepconv.sepconv_reference = real
    # B1's plain version: every fused sepconv once a forward (34 at 71x71,
    # where the entry blocks take it too) in each data group
    assert per_forward == 34
    assert calls == [4 // data] * (per_forward * data)
    info = eng.sharding_info()
    if model > 1:
        assert info["sharded_leaves"] > 0
        assert info["param_bytes_per_chip"] < info["param_bytes_total"]
    np.testing.assert_allclose(got, one, **FUSED_TOL)
    jeng = jengine.InferenceEngine(jfn, variables, mesh=jmesh_,
                                   device_batch_size=4,
                                   partition_rules=jmesh.
                                   default_partition_rules)
    want = np.asarray(jeng(x)).astype(np.float32)
    np.testing.assert_allclose(got, want, **FUSED_TOL)
    # the digest hashes leaf paths, and a module's are torch's names
    # (``weight``, ``running_mean``) where JAX's are flax's
    _same_jax_keys(info, jeng.sharding_info(),
                   [k for k in JAX_INFO_KEYS if k != "sharding_digest"])
