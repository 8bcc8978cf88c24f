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


# -- failure domain: the same plan through both engines ---------------------

def _fault_pair(rng, **kw):
    """A JAX and a port engine over the same seeded ``tanh(x @ w)``, batch
    8, with the same failure-domain arguments."""
    w = rng.normal(size=(6, 4)).astype(np.float32)
    jeng = JaxEngine(lambda v, x: jnp.tanh(x @ v["w"]), {"w": w},
                     mesh=jax_mesh.get_mesh(num_devices=1),
                     device_batch_size=8, **kw)
    lin = nn.Linear(6, 4, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    peng = InferenceEngine(lambda m, x: torch.tanh(m(x)), lin, device="cpu",
                           device_batch_size=8, **kw)
    return jeng, peng


_DOMAIN_COUNTERS = ("engine.dispatch_errors", "engine.gather_errors",
                    "engine.dispatch_retries", "engine.breaker_opened")


def _domain(eng):
    st = eng.breaker_state()
    return ({k: eng.metrics.counters.get(k, 0.0) for k in _DOMAIN_COUNTERS},
            {k: st[k] for k in ("state", "consecutive_failures",
                                "opened_count", "enabled")})


def _drive(eng, xb, spec, calls, jax_faults, port_faults, is_jax):
    """``calls`` serial calls under ``spec``; the outcome of each (the
    error's type name or "ok")."""
    pkg = jax_faults if is_jax else port_faults
    out = []
    with pkg.active(pkg.FaultPlan.parse(spec)):
        for _ in range(calls):
            try:
                eng(xb, pipeline=False)
                out.append("ok")
            except Exception as e:  # noqa: BLE001 — the outcome is the test
                out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("spec,kw,calls", [
    ("engine.dispatch:error:exc=transient,at=2",
     dict(dispatch_retries=2, dispatch_backoff_s=0.001), 3),
    ("engine.dispatch:error:exc=fatal,at=1",
     dict(dispatch_retries=3, dispatch_backoff_s=0.001), 2),
    ("engine.dispatch:dead:at=1",
     dict(breaker_threshold=2, breaker_cooldown_s=30.0), 4),
    ("engine.gather:dead:at=1",
     dict(breaker_threshold=2, breaker_cooldown_s=30.0), 4),
    ("seed=5;engine.dispatch:error:p=0.5",
     dict(dispatch_retries=1, dispatch_backoff_s=0.001, dispatch_jitter=0.0,
          breaker_threshold=3), 12),
    ("seed=1;engine.gather:error:every=2",
     dict(breaker_threshold=0), 6),
])
def test_failure_domain_matches_jax(spec, kw, calls):
    """Under the same fault plan the two engines end with the same
    counters and breaker state, call by call the same outcomes."""
    from sparkdl_tpu import faults as jax_faults
    from sparkdl_tpu_torch import faults as port_faults

    rng = np.random.default_rng(21)
    jeng, peng = _fault_pair(rng, **kw)
    xb = rng.normal(size=(8, 6)).astype(np.float32)
    jeng(xb, pipeline=False)
    peng(xb, pipeline=False)
    want = _drive(jeng, xb, spec, calls, jax_faults, port_faults, True)
    got = _drive(peng, xb, spec, calls, jax_faults, port_faults, False)
    assert got == want
    assert _domain(peng) == _domain(jeng)


def test_breaker_half_open_recovers():
    from sparkdl_tpu_torch import faults
    from sparkdl_tpu_torch.parallel.engine import CircuitOpenError

    rng = np.random.default_rng(3)
    _, eng = _fault_pair(rng, breaker_threshold=2, breaker_cooldown_s=0.2)
    xb = rng.normal(size=(8, 6)).astype(np.float32)
    eng(xb)
    with faults.active(faults.FaultPlan.parse("engine.dispatch:dead:at=1")):
        for _ in range(2):
            with pytest.raises(faults.InjectedDeadDeviceError):
                eng(xb)
        assert eng.breaker_state()["state"] == "open"
        with pytest.raises(CircuitOpenError) as ei:
            eng(xb)
        assert ei.value.retry_after_s > 0
    import time

    time.sleep(0.25)
    assert eng.breaker_state()["state"] == "half_open"
    with faults.active(faults.FaultPlan.parse(
            "engine.dispatch:error:exc=fatal")):
        with pytest.raises(faults.InjectedFatalError):
            eng(xb)
    assert eng.breaker_state()["state"] == "half_open"  # trial handed back
    assert eng(xb).shape == (8, 4)
    assert eng.breaker_state()["state"] == "closed"


@pytest.mark.parametrize("pipeline", [False, True])
def test_on_metered_fires_once_per_call(pipeline):
    rng = np.random.default_rng(4)
    jeng, peng = _fault_pair(rng)
    x = rng.normal(size=(37, 6)).astype(np.float32)
    seen = []
    out = peng(x, pipeline=pipeline, on_metered=seen.append)
    assert len(seen) == 1 and seen[0] > 0
    assert peng.metrics.counters["engine.device_time_s"] == pytest.approx(
        seen[0])
    assert peng.metrics.counters["items"] == 37
    assert peng.metrics.summary()["engine_call.count"] == 1
    np.testing.assert_allclose(out, np.asarray(jeng(x, pipeline=pipeline)),
                               **TOL)


def test_batches_per_dispatch_env_parity(monkeypatch):
    from sparkdl_tpu.parallel.engine import \
        batches_per_dispatch_from_env as jax_bpd
    from sparkdl_tpu_torch.parallel.engine import \
        batches_per_dispatch_from_env as port_bpd

    for raw in ("", "1", "3", "0", "-2"):
        monkeypatch.setenv("SPARKDL_BATCHES_PER_DISPATCH", raw)
        assert port_bpd() == jax_bpd()


@pytest.mark.parametrize("k", [2, 3])
def test_grouped_dispatch_matches_jax(k):
    """k pieces stacked into one dispatch: the same outputs and pad ledger
    as JAX's grouped engine, ragged tail group on the per-batch path."""
    rng = np.random.default_rng(5)
    jeng, peng = _fault_pair(rng, batches_per_dispatch=k)
    data = [rng.normal(size=(n, 6)).astype(np.float32) for n in (30, 11)]
    want = list(jeng.map_batches(data, pipeline=False))
    got = list(peng.map_batches(data, pipeline=False))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert _ledger(peng) == _ledger(jeng)


def test_graph_key_moves_with_weights_and_precision_flags():
    """What keys a captured forward: an in-place edit, ``load_state_dict``
    and each precision flag cuDNN and cuBLAS read at capture."""
    from sparkdl_tpu_torch.parallel.engine import graph_key

    lin = nn.Linear(4, 3)
    state = [*lin.parameters(), *lin.buffers()]
    k0 = graph_key(state)
    assert graph_key(state) == k0
    with torch.no_grad():
        lin.weight.mul_(1.0)
    k1 = graph_key(state)
    assert k1 != k0
    lin.load_state_dict(nn.Linear(4, 3).state_dict())
    k2 = graph_key(state)
    assert k2 not in (k0, k1)
    flags = [(torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cuda.matmul,
              "allow_bf16_reduced_precision_reduction")]
    for mod, attr in flags:
        old = getattr(mod, attr)
        setattr(mod, attr, not old)
        try:
            assert graph_key(state) != k2
        finally:
            setattr(mod, attr, old)
        assert graph_key(state) == k2
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium" if old != "medium"
                                       else "highest")
    try:
        assert graph_key(state) != k2
    finally:
        torch.set_float32_matmul_precision(old)
    assert graph_key(state) == k2


def test_graph_key_moves_when_a_fold_cache_is_cleared():
    """A write through ``.data`` moves no version counter, so the graph key
    also reads the fold caches: clearing one changes the key, and so does
    refilling it while the old entries are held (as a graph holds them)."""
    from sparkdl_tpu_torch.models.layers import cached_fold
    from sparkdl_tpu_torch.parallel.engine import fold_entries, graph_key

    lin = nn.Linear(4, 3)
    lin._folds = {}
    owners = [lin]
    state = [*lin.parameters()]

    def fold():
        cached_fold(lin._folds, "w", [lin.weight, lin.bias],
                    lambda: lin.weight * 2)

    fold()
    k0 = graph_key(state, owners)
    held = fold_entries(owners)
    assert len(held) == 1
    fold()  # a hit: the same entry
    assert graph_key(state, owners) == k0
    with torch.no_grad():
        lin.weight.data.mul_(3.0)  # no version bump: the key cannot see it
    assert graph_key(state, owners) == k0
    lin._folds.clear()
    assert graph_key(state, owners) != k0
    fold()
    assert graph_key(state, owners) != k0
    assert graph_key(state) == graph_key(state, ())


def test_tree_helpers_visit_leaves_in_one_order():
    """``_tree_map`` calls ``fn`` in ``_tree_leaves``' order (dict keys
    sorted, as JAX flattens), so a leaf list zipped back into a tree lands
    on the right leaves whatever the dicts' insertion order."""
    from sparkdl_tpu_torch.parallel.engine import _tree_leaves, _tree_map

    tree = {"z": np.zeros(1), "a": (np.ones(1), [np.full(1, 2.0), None]),
            "m": {"y": np.full(1, 3.0), "b": np.full(1, 4.0)}}
    leaves = _tree_leaves(tree)
    assert [float(a[0]) for a in leaves] == [1.0, 2.0, 4.0, 3.0, 0.0]
    seen = []
    out = _tree_map(lambda a: seen.append(float(a[0])) or a * 10, tree)
    assert seen == [float(a[0]) for a in leaves]
    it = iter(range(len(leaves)))
    idx = _tree_map(lambda _: next(it), tree)
    assert idx == {"a": (0, [1, None]), "m": {"b": 2, "y": 3}, "z": 4}
    assert float(out["m"]["y"][0]) == 30.0 and out["a"][1][1] is None
