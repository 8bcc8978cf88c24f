"""The port's head fan-out (``HeadFanoutServer``, ``HeadBank``, the
feature-cut cache namespace, ``head_swap_report``) held against the JAX
package's, on the CPU.

Held to JAX on the same inputs: ``HeadBank`` over one add / swap / remove
sequence (rows within 1e-6; tenants, capacity, mode, the bank's bytes and
the ``KeyError`` / ``ValueError`` cases equal), ``feature_namespace``,
``head_swap_report``, ``head_fanout_benchmark``'s deterministic keys, and a
96x96 zoo Xception behind both servers (1e-3, the zoo tests' limit).  Then
the JAX package's ``tests/test_headfanout.py`` contracts on the port's own
side, bit for bit against an independent per-tenant oracle
(``head_fanout_oracle_fn``, one unbatched row): one head pass for a
mixed-tenant batch, a hot swap under load, the feature cache across a
swap, a weight change rotating the namespace, eviction, both fallbacks
(where the JAX twins miss by an ulp: its fallback runs another reduction),
the fault sites, the ``feature_cut`` bundle and the device rule.  Every
port object runs under ``default_device("cpu")``; sleeps stay at or
under 0.05 s.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax

import sparkdl_tpu.serving as jserving
import sparkdl_tpu.transformers.named_image as jax_ni
import sparkdl_tpu_torch
from sparkdl_tpu_torch.parallel import mesh as mesh_lib
import sparkdl_tpu_torch.transformers.named_image as port_ni
from sparkdl_tpu.models import get_model_spec as jax_spec
from sparkdl_tpu.parallel import engine as jengine
from sparkdl_tpu.serving import cache as jcache
from sparkdl_tpu.serving.fleet import rollout as jrollout
from sparkdl_tpu_torch import faults
from sparkdl_tpu_torch.models import get_model_spec as port_spec
from sparkdl_tpu_torch.models.convert import state_dict_from_jax
from sparkdl_tpu_torch.models.xception import Xception
from sparkdl_tpu_torch.ops import head_pass
from sparkdl_tpu_torch.parallel.engine import (HeadBank, build_head_fanout,
                                               dense_head_row,
                                               head_fanout_backbone_fn,
                                               head_fanout_module,
                                               head_fanout_oracle_fn)
from sparkdl_tpu_torch.serving import (HeadFanoutServer, InferenceCache,
                                       Server)
from sparkdl_tpu_torch.serving.cache import (feature_namespace,
                                             head_fanout_benchmark,
                                             lockfile_model_fingerprint)
from sparkdl_tpu_torch.serving.fleet.rollout import head_swap_report

D_IN, D_FEAT, CLASSES = 12, 16, 4
TOL = dict(rtol=0, atol=1e-6)          # the dense head, JAX vs port
ZOO_TOL = dict(rtol=1e-3, atol=1e-3)   # tests/test_torch_serving.py's
SIZE = 96                              # Xception narrowed as there


def _variables(seed=0):
    rng = np.random.default_rng(seed)
    return {"backbone": rng.normal(size=(D_IN, D_FEAT)).astype(np.float32)}


def _head(seed, classes=CLASSES):
    """Kernels N(0, 1/D), as the kernel tests draw them."""
    rng = np.random.default_rng(100 + seed)
    return {"kernel": (rng.normal(size=(D_FEAT, classes))
                       / np.sqrt(D_FEAT)).astype(np.float32),
            "bias": rng.normal(size=(classes,)).astype(np.float32)}


def _payload(seed):
    return np.random.default_rng(200 + seed).normal(
        size=(D_IN,)).astype(np.float32)


@pytest.fixture(autouse=True)
def cpu():
    with sparkdl_tpu_torch.default_device("cpu"):
        yield


def _server(cache=False, variables=None, **kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_wait_ms", 0.5)
    return HeadFanoutServer(
        head_fanout_backbone_fn,
        head_fanout_module(variables if variables is not None
                           else _variables()),
        model_desc="headfanout", cache=cache, **kw)


def _oracle(variables, head, x):
    """The independent full-model oracle: ONE unbatched row through the
    fused weights, never through the fan-out."""
    fused = head_fanout_module({**variables, **head})
    with torch.inference_mode():
        return head_fanout_oracle_fn(fused, torch.from_numpy(x)).numpy()


def _feature(variables, x):
    with torch.inference_mode():
        return head_fanout_backbone_fn(head_fanout_module(variables),
                                       torch.from_numpy(x)).numpy()


def _wrap_slow(srv, sleep_s=0.0):
    """Count (and optionally slow) the BACKBONE's dispatches."""
    calls = [0]
    for b in srv.bucket_sizes:
        eng = srv.backbone._engine_for(b)
        real = eng.run_padded

        def slow(batch, _real=real):
            calls[0] += 1
            if sleep_s:
                time.sleep(sleep_s)
            return _real(batch)

        eng.run_padded = slow
    return calls


# -- held to the JAX package -------------------------------------------------

def _bank_view(bank):
    st = bank.stats()
    return dict(tenants=bank.tenants(), capacity=st["capacity"],
                mode=bank.mode, total=st["param_bytes_total"],
                per_chip=st["param_bytes_per_chip"], n=len(bank))


def _raises(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("budget_heads", [None, 3])
def test_head_bank_matches_jax_over_add_swap_remove(budget_heads):
    """One add / swap / remove sequence through both banks: rows within
    1e-6 after every step, and tenants, capacity, mode, bytes and the
    refused calls equal.  With a budget of three heads the third add
    degrades both banks to per-tenant dispatch."""
    one_head = (D_FEAT * CLASSES + CLASSES) * 4
    budget = None if budget_heads is None else budget_heads * one_head
    jbank = jengine.HeadBank(hbm_budget_bytes=budget)
    pbank = HeadBank(hbm_budget_bytes=budget)
    feats = np.random.default_rng(9).normal(
        size=(5, D_FEAT)).astype(np.float32)
    steps = [("add", "a", _head(0)), ("add", "b", _head(1)),
             ("add", "c", _head(2)), ("swap", "b", _head(7)),
             ("remove", "a", None), ("add", "d", _head(3))]
    for op, tenant, head in steps:
        for bank in (jbank, pbank):
            getattr(bank, f"{op}_head")(
                *((tenant,) if head is None else (tenant, head)))
        assert _bank_view(pbank) == _bank_view(jbank), (op, tenant)
        ts = [pbank.tenants()[i % len(pbank)] for i in range(5)]
        np.testing.assert_allclose(pbank.dispatch(feats, ts),
                                   np.asarray(jbank.dispatch(feats, ts)),
                                   **TOL)
    assert pbank.mode == ("stacked" if budget is None else "fallback")
    for call in (lambda b: b.add_head("b", _head(1)),
                 lambda b: b.swap_head("zz", _head(1)),
                 lambda b: b.remove_head("zz"),
                 lambda b: b.dispatch(feats[:1], ["a"]),
                 lambda b: b.dispatch(feats[:2], ["b"])):
        assert _raises(lambda: call(pbank)) == _raises(lambda: call(jbank))
    assert _bank_view(pbank) == _bank_view(jbank)


def test_feature_namespace_and_fingerprint_match_jax(tmp_path):
    """The namespace tuple is JAX's; ``lockfile_model_fingerprint`` over
    one lockfile given to both packages is JAX's (dispatch records of the
    model only, a model with none or a missing file None); by default the
    port reads its own committed ``PROGRAMS_TORCH.lock.json``, which pins
    the zoo Xception and the fan-out backbone."""
    from sparkdl_tpu_torch.analysis.program.lockfile import (
        DEFAULT_LOCKFILE, read_lockfile, write_lockfile)

    for args in (("headfanout", "fp", "digest"),
                 ("headfanout", None, "d"), ("Xception", "", "w")):
        assert feature_namespace(*args) == jcache.feature_namespace(*args)
    assert feature_namespace("headfanout", None, "d") == (
        "features", "headfanout", "unpinned", "d")
    committed = read_lockfile(DEFAULT_LOCKFILE)["programs"]
    records = [dict(rec, name=name) for name, rec in committed.items()
               if name.startswith(("zoo/Xception/", "headfanout/"))]
    path = str(tmp_path / "lock.json")
    write_lockfile(records, path)
    for model in ("Xception", "headfanout", "VGG16", "nope"):
        fp = lockfile_model_fingerprint(model, path)
        assert fp == jcache.lockfile_model_fingerprint(model, path)
        assert (fp is None) == (model in ("VGG16", "nope"))
    missing = str(tmp_path / "none.json")
    assert lockfile_model_fingerprint("Xception", missing) is None
    assert jcache.lockfile_model_fingerprint("Xception", missing) is None
    # the port's default lockfile pins both (the predict cut and the head
    # program carry no model tag and stay out, as in JAX's)
    assert lockfile_model_fingerprint("Xception") == \
        lockfile_model_fingerprint("Xception", path)
    assert lockfile_model_fingerprint("headfanout") == \
        lockfile_model_fingerprint("headfanout", path) is not None


_EXEC = {8: {"jit_id": 11, "executables": 1},
         16: {"jit_id": 12, "executables": 1}}


@pytest.mark.parametrize("now,bank_now,fp", [
    (_EXEC, {"jit_id": 5, "executables": None, "mode": "stacked"},
     (None, None)),
    (_EXEC, {"jit_id": 5, "executables": 3, "mode": "fallback"},
     ("abc", "abc")),
    ({8: {"jit_id": 99, "executables": 1}, 16: _EXEC[16]},
     {"jit_id": 5, "executables": None, "mode": "stacked"}, (None, None)),
    ({8: {"jit_id": 11, "executables": 2}, 16: _EXEC[16]},
     {"jit_id": 5, "executables": None, "mode": "stacked"}, (None, None)),
    (_EXEC, {"jit_id": 6, "executables": None, "mode": "stacked"},
     ("abc", "abd")),
    ({**_EXEC, 32: {"jit_id": 13, "executables": 1}},
     {"jit_id": 5, "executables": 1, "mode": "stacked"}, ("x", "x")),
    ({}, {"jit_id": 5, "executables": None, "mode": "stacked"},
     (None, None)),
])
def test_head_swap_report_matches_jax(now, bank_now, fp):
    bank_before = {"jit_id": 5, "executables": None, "mode": "stacked"}
    args = ("headfanout", "t1", "swap", _EXEC, now, bank_before, bank_now,
            fp[0], fp[1])
    assert head_swap_report(*args) == jrollout.head_swap_report(*args)


def test_benchmark_deterministic_keys_match_jax():
    """The seeded replay's counts are JAX's; every port row equals its
    per-tenant oracle bit for bit."""
    kw = dict(n_requests=96, universe=12, tenants=64, dispatch_ms=2.0,
              seed=0)
    got = head_fanout_benchmark(device="cpu", **kw)
    want = jcache.head_fanout_benchmark(**kw)
    for key in ("distinct", "backbone_dispatches", "baseline_dispatches",
                "feature_hits", "bank_capacity",
                "bank_param_bytes_per_chip", "bank_mode", "dispatch_ratio"):
        assert got[key] == want[key], key
    assert got["bit_identical"] is True
    assert got["backbone_dispatches"] == got["distinct"]
    assert got["baseline_dispatches"] == got["n_requests"]
    assert got["warm_p50_ms"] < got["baseline_p50_ms"]


@pytest.fixture(scope="module")
def xc_variables():
    spec = jax_spec("Xception")
    module = spec.build()
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda r, a: module.init(r, a, train=False))(
            jax.random.PRNGKey(3), x))


@pytest.fixture
def zoo(monkeypatch, xc_variables):
    """Both zoos serve the same Xception weights at a 96x96 input."""
    narrow_jax = dataclasses.replace(jax_spec("Xception"),
                                     input_size=(SIZE, SIZE))
    narrow_port = dataclasses.replace(port_spec("Xception"),
                                      input_size=(SIZE, SIZE))
    monkeypatch.setattr(jax_ni, "get_model_spec", lambda name: narrow_jax)
    monkeypatch.setattr(port_ni, "get_model_spec", lambda name: narrow_port)
    monkeypatch.setattr(jax_ni, "_ENGINE_CACHE", {})
    monkeypatch.setattr(port_ni, "_ENGINE_CACHE", port_ni.new_engine_cache())
    monkeypatch.setitem(jax_ni._MODEL_CACHE, ("Xception", ""),
                        (narrow_jax.build(), xc_variables))
    model = Xception()
    model.load_state_dict(state_dict_from_jax("Xception", xc_variables))
    monkeypatch.setitem(port_ni._MODEL_CACHE, ("Xception", ""),
                        model.eval())


def test_zoo_xception_fanout_matches_jax(zoo):
    """``HeadFanoutServer("Xception")`` at 96x96 with three tenants' 2048-d
    heads: the port's rows within 1e-3 of JAX's on the same weights and
    images, one mixed-tenant head pass, each row its tenant's head over
    the zoo engine's feature row bit for bit, and a warm repeat served
    from the feature cache."""
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    heads = {f"t{i}": {
        "kernel": (rng.normal(size=(2048, 10)) / np.sqrt(2048)).astype(
            np.float32),
        "bias": rng.normal(size=(10,)).astype(np.float32)} for i in range(3)}
    ts = ["t0", "t1", "t2", "t1"]
    kw = dict(max_batch_size=4, bucket_sizes=[4], max_wait_ms=200)
    with jserving.HeadFanoutServer("Xception",
                                   cache=jserving.InferenceCache(),
                                   **kw) as jsrv:
        for t, h in heads.items():
            jsrv.add_head(t, h)
        want = np.stack([np.asarray(r)
                         for r in jsrv.predict_batch(list(imgs), ts)])
    with HeadFanoutServer("Xception", cache=InferenceCache(), **kw) as srv:
        assert srv.feature_namespace[:3] == (
            "features", "Xception", lockfile_model_fingerprint("Xception"))
        for t, h in heads.items():
            srv.add_head(t, h)
        got = np.stack(srv.predict_batch(list(imgs), ts))
        counters = srv.metrics.counters
        assert counters["headfanout.head_passes"] == 1
        assert counters["headbank.dispatches"] == 1
        assert counters["serving.batches"] == 1
        report = srv.swap_head("t0", heads["t0"])
        assert report["no_backbone_recompile"] is True
        assert list(report["buckets"]) == [4]
        again = srv.predict(imgs[2], "t2")
        assert srv.metrics.counters["headfanout.feature_hits"] == 1
    assert got.shape == (4, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ZOO_TOL)
    feats = port_ni._zoo_engine("Xception", True, 4)(imgs)
    for i, t in enumerate(ts):
        ref = dense_head_row(heads[t], torch.from_numpy(feats[i])).numpy()
        assert got[i].tobytes() == ref.tobytes()
    assert again.tobytes() == got[2].tobytes()


# -- the port's own contracts, bit for bit ---------------------------------

def test_mixed_tenant_batch_one_head_pass_bit_identical():
    """K tenants' rows in one ``predict_batch`` cost ONE head pass, and
    every row equals its tenant's own oracle bit for bit."""
    variables = _variables()
    with _server(variables=variables) as srv:
        heads = {f"t{i}": _head(i) for i in range(5)}
        for t, h in heads.items():
            srv.add_head(t, h)
        srv.warmup(_payload(0))
        xs = [_payload(i % 3) for i in range(7)]
        ts = [f"t{i % 5}" for i in range(7)]
        before = dict(srv.metrics.counters)
        rows = srv.predict_batch(xs, ts)
        after = srv.metrics.counters
        for key in ("headfanout.head_passes", "headbank.dispatches"):
            assert after[key] - before.get(key, 0) == 1
        assert after["headbank.rows"] - before.get("headbank.rows", 0) == 7
        for x, t, y in zip(xs, ts, rows):
            assert np.asarray(y).tobytes() == _oracle(
                variables, heads[t], x).tobytes()


def test_head_hot_swap_under_load_proof_and_bit_correctness():
    """Swap a tenant's head under load: zero failed futures, every row the
    OLD or the NEW oracle's bits (never a torn head), the new head served
    afterwards, and a report whose bucket and head witnesses hold and
    whose backbone fingerprint is pinned by the port's program lockfile
    (as JAX's report is by its own)."""
    variables = _variables()
    old, new = _head(1), _head(99)
    with _server(variables=variables, cache=InferenceCache()) as srv:
        srv.add_head("a", old)
        srv.add_head("b", _head(2))
        srv.warmup(_payload(0))
        srv.warm_head(np.zeros(D_FEAT, np.float32))
        x = _payload(0)
        srv.predict(x, "a")  # warm the feature cache for this digest
        results, errors = [], []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    results.append(np.asarray(srv.predict(x, "a")))
                except BaseException as e:  # noqa: BLE001 — asserted empty
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        state = srv.executable_state()
        report = srv.swap_head("a", new)
        time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join()
        assert not errors, errors
        assert results
        ref_old = _oracle(variables, old, x).tobytes()
        ref_new = _oracle(variables, new, x).tobytes()
        assert all(y.tobytes() in (ref_old, ref_new) for y in results)
        assert np.asarray(srv.predict(x, "a")).tobytes() == ref_new
        assert report["no_backbone_recompile"] is True
        assert report["head_jit_shared"] is True
        assert report["fingerprint_pinned"] is True
        assert report["fingerprint_before"] == lockfile_model_fingerprint(
            "headfanout") is not None
        assert all(b["shared_jit"] for b in report["buckets"].values())
        assert srv.executable_state() == state
        assert srv.varz()["headfanout"]["last_head_swap_report"] == report


def test_feature_cache_survives_head_swap():
    """A head swap keeps the feature entries serving: zero new backbone
    dispatches, the post-swap row already the NEW head's."""
    variables = _variables()
    cache = InferenceCache()
    with _server(variables=variables, cache=cache) as srv:
        srv.add_head("a", _head(1))
        srv.warmup(_payload(0))
        calls = _wrap_slow(srv)
        x = _payload(5)
        srv.predict(x, "a")
        assert calls[0] == 1
        entries_before = len(cache)
        srv.swap_head("a", _head(7))
        assert len(cache) == entries_before  # nothing invalidated
        got = np.asarray(srv.predict(x, "a"))
        assert calls[0] == 1, "a feature hit must skip the backbone"
        assert got.tobytes() == _oracle(variables, _head(7), x).tobytes()
        varz = srv.varz()
        assert varz["cache"]["counters"]["cache.feature_hits"] == 1
        assert varz["headfanout"]["feature_hits"] == 1


def test_backbone_weight_change_rotates_feature_namespace():
    """Other backbone weights give another weight digest and another
    namespace; ``close()`` leaves the namespace, so a restarted server over
    the SAME backbone serves the entries warm."""
    cache = InferenceCache()
    with _server(variables=_variables(0), cache=cache) as srv1:
        srv1.add_head("a", _head(1))
        srv1.warmup(_payload(0))
        srv1.predict(_payload(5), "a")
        ns1 = srv1.feature_namespace
    assert len(cache) == 1
    with _server(variables=_variables(0), cache=cache) as srv2:
        srv2.add_head("a", _head(1))
        srv2.warmup(_payload(0))
        calls = _wrap_slow(srv2)
        srv2.predict(_payload(5), "a")
        assert srv2.feature_namespace == ns1
        assert calls[0] == 0, "the same backbone must inherit warm entries"
    with _server(variables=_variables(3), cache=cache) as srv3:
        srv3.add_head("a", _head(1))
        srv3.warmup(_payload(0))
        calls = _wrap_slow(srv3)
        assert srv3.feature_namespace != ns1
        assert srv3.feature_namespace[:3] == ns1[:3]
        srv3.predict(_payload(5), "a")
        assert calls[0] == 1, "new backbone weights must re-featurize"


def test_stacked_bank_evicts_departed_tenant():
    """Eviction re-stacks the survivors; the departed tenant fails loudly
    with ``KeyError`` instead of serving a stale row."""
    variables = _variables()
    with _server(variables=variables) as srv:
        heads = {f"t{i}": _head(i) for i in range(3)}
        for t, h in heads.items():
            srv.add_head(t, h)
        assert srv.head_stats()["capacity"] == 4
        srv.warmup(_payload(0))
        report = srv.remove_head("t1")
        assert report["op"] == "remove"
        assert srv.tenants() == ["t0", "t2"]
        assert srv.head_stats()["capacity"] == 2
        with pytest.raises(KeyError):
            srv.predict(_payload(0), "t1")
        for t in ("t0", "t2"):
            got = np.asarray(srv.predict(_payload(1), t))
            assert got.tobytes() == _oracle(variables, heads[t],
                                            _payload(1)).tobytes()


def test_indivisible_head_falls_back_bit_identical():
    """A head that cannot stack flips the bank to per-tenant fallback: both
    shapes keep serving through the SAME fan-out callable, bit-identical to
    the head alone (the JAX twin misses by an ulp here)."""
    bank = HeadBank()
    h0 = _head(0)
    bank.add_head("a", h0)
    jit_before = bank.jit_info()["jit_id"]
    odd = _head(9, classes=CLASSES + 3)
    bank.add_head("weird", odd)
    assert bank.mode == "fallback"
    assert bank.jit_info()["jit_id"] == jit_before
    assert "mismatch" in bank.stats()["fallback_reason"]
    feats = np.random.default_rng(3).normal(
        size=(D_FEAT,)).astype(np.float32)
    for tenant, head in (("a", h0), ("weird", odd)):
        got = bank.dispatch(feats[None], [tenant])[0]
        ref = dense_head_row(head, torch.from_numpy(feats)).numpy()
        assert got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


def test_oversized_bank_falls_back_within_budget_bit_identical():
    one_head = (D_FEAT * CLASSES + CLASSES) * 4
    bank = HeadBank(hbm_budget_bytes=3 * one_head)
    bank.add_head("a", _head(1))
    bank.add_head("b", _head(2))
    assert bank.mode == "stacked"  # capacity 2 fits
    bank.add_head("c", _head(3))   # capacity 4 would not
    assert bank.mode == "fallback"
    assert "hbm_budget_bytes" in bank.stats()["fallback_reason"]
    feats = np.random.default_rng(4).normal(
        size=(3, D_FEAT)).astype(np.float32)
    out = bank.dispatch(feats, ["a", "c", "a"])
    for i, seed in enumerate((1, 3, 1)):
        ref = dense_head_row(_head(seed), torch.from_numpy(feats[i]))
        assert out[i].tobytes() == ref.numpy().tobytes()


def test_head_fault_sites_abort_with_bank_unchanged():
    for site in ("head.dispatch", "head.swap"):
        assert site in faults.SITE_HELP
        faults.validate_site(site)
    variables = _variables()
    old = _head(1)
    with _server(variables=variables) as srv:
        srv.add_head("a", old)
        srv.warmup(_payload(0))
        x = _payload(0)
        view = (srv.tenants(), srv.head_stats(), srv.head_state())
        with faults.active(faults.FaultPlan.parse(
                "seed=8;head.swap:error:exc=fatal,times=2")):
            with pytest.raises(faults.InjectedFault):
                srv.swap_head("a", _head(9))
            with pytest.raises(faults.InjectedFault):
                srv.add_head("b", _head(9))
        assert (srv.tenants(), srv.head_stats(), srv.head_state()) == view
        ref = _oracle(variables, old, x).tobytes()
        assert np.asarray(srv.predict(x, "a")).tobytes() == ref
        with faults.active(faults.FaultPlan.parse(
                "seed=8;head.dispatch:error:exc=fatal,times=1")):
            with pytest.raises(faults.InjectedFault):
                srv.predict_batch([x], ["a"])
        assert np.asarray(srv.predict(x, "a")).tobytes() == ref


def test_custom_head_fn_runs_vmapped_over_the_bank():
    """A caller's head function runs as plain PyTorch over the gathered
    heads (one pass for a mixed batch), equal to JAX's vmapped program on
    the same bank within 1e-6."""
    def phead(h, f):
        return torch.relu((f[:, None] * h["kernel"]).sum(0)) * h["scale"]

    def jhead(h, f):
        import jax.numpy as jnp

        return jnp.maximum((f[:, None] * h["kernel"]).sum(0), 0) * h["scale"]

    rng = np.random.default_rng(5)
    heads = {t: {"kernel": rng.normal(size=(D_FEAT, 3)).astype(np.float32),
                 "scale": rng.normal(size=(3,)).astype(np.float32)}
             for t in ("x", "y")}
    pbank, jbank = HeadBank(head_fn=phead), jengine.HeadBank(head_fn=jhead)
    for t, h in heads.items():
        pbank.add_head(t, h)
        jbank.add_head(t, h)
    feats = rng.normal(size=(4, D_FEAT)).astype(np.float32)
    ts = ["x", "y", "y", "x"]
    np.testing.assert_allclose(pbank.dispatch(feats, ts),
                               np.asarray(jbank.dispatch(feats, ts)), **TOL)
    assert build_head_fanout(phead) is pbank._fanout
    assert build_head_fanout(dense_head_row) is not pbank._fanout


def test_feature_cut_bundle(zoo):
    from sparkdl_tpu_torch.transformers.named_image import \
        zoo_serving_bundle

    fn, module, overrides, head_fn = zoo_serving_bundle(
        "Xception", featurize=True, feature_cut=True)
    assert head_fn is dense_head_row
    assert module is port_ni._cached_model("Xception")
    # JAX's zoo overrides: no donation, the family's default rules
    *_, joverrides, _ = jax_ni.zoo_serving_bundle(
        "Xception", featurize=True, feature_cut=True)
    assert sorted(overrides) == sorted(joverrides)
    assert overrides["donate_batch"] is joverrides["donate_batch"] is False
    assert overrides["partition_rules"] is mesh_lib.default_partition_rules
    assert len(zoo_serving_bundle("Xception", featurize=True)) == 3
    with pytest.raises(ValueError, match="requires featurize=True"):
        zoo_serving_bundle("Xception", featurize=False, feature_cut=True)
    with pytest.raises(ValueError, match="requires featurize=True"):
        jax_ni.zoo_serving_bundle("Xception", featurize=False,
                                  feature_cut=True)


def test_device_rule_and_not_ported_arguments(monkeypatch):
    """Without a card and with no CPU asked for, the server and the bank
    raise ``RuntimeError``; ``device="cpu"`` works anywhere; ``mesh=``
    reaches the backbone and the bank (a mesh of two slots serves the
    one-device rows bit for bit) and a ``cost=`` that is
    no ``CostLedger`` is refused, as the JAX server refuses it; on CUDA a
    non-f32 dense head is refused before the bank changes."""
    module = head_fanout_module(_variables())
    with sparkdl_tpu_torch.default_device(None):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _server()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HeadBank()
        with HeadFanoutServer(head_fanout_backbone_fn, module,
                              device="cpu", cache=False) as srv:
            assert srv.device.type == "cpu"
            assert srv.bank.device.type == "cpu"
            srv.add_head("a", _head(1))
            assert srv.predict(_payload(1), "a").shape == (CLASSES,)
    two = mesh_lib.get_mesh(devices=["cpu", "cpu"])
    with _server(mesh=mesh_lib.get_mesh()) as srv:
        assert srv.device.type == "cpu"
        srv.add_head("a", _head(1))
        assert srv.predict(_payload(1), "a").shape == (CLASSES,)
        assert srv.bank.stats()["mesh_shape"] == {"data": 1, "model": 1}
        assert srv.backbone.sharding_info()["mesh_shape"] == \
            {"data": 1, "model": 1}
    # a mesh of two slots in one process: the backbone's rows split over
    # two data groups, the head pass runs once in each, and every row is
    # the one-device server's bit for bit
    with _server(mesh=mesh_lib.get_mesh()) as one, _server(mesh=two) as srv:
        for s_ in (one, srv):
            s_.add_head("a", _head(1))
            s_.add_head("b", _head(2))
        for i in range(3):
            t = "ab"[i % 2]
            np.testing.assert_array_equal(srv.predict(_payload(i), t),
                                          one.predict(_payload(i), t))
        assert srv.bank.stats()["mesh_shape"] == {"data": 2, "model": 1}
        assert srv.backbone.sharding_info()["mesh_shape"] == \
            {"data": 2, "model": 1}
    with pytest.raises(TypeError, match="CostLedger"):
        _server(cost=object())
    bank2, bank1 = HeadBank(mesh=two), HeadBank(mesh=mesh_lib.get_mesh())
    for b_ in (bank2, bank1):
        b_.add_head("a", _head(1))
        b_.add_head("b", _head(2))
    feats = np.random.default_rng(5).normal(
        size=(3, D_FEAT)).astype(np.float32)
    np.testing.assert_array_equal(bank2.dispatch(feats, ["a", "b", "a"]),
                                  bank1.dispatch(feats, ["a", "b", "a"]))
    bank = HeadBank()
    bank.add_head("a", _head(1))
    bank.device = torch.device("cuda")  # the refusal comes before any copy
    with pytest.raises(NotImplementedError, match="H1"):
        bank.add_head("b", {k: v.astype(np.float64)
                            for k, v in _head(2).items()})
    assert bank.tenants() == ["a"]


def test_oracle_rows_are_batch_invariant_on_the_cpu():
    """The stand-in backbone's rows and the head pass do not move with
    their batch: the premise of every bit-for-bit check above."""
    variables = _variables()
    xs = np.stack([_payload(i) for i in range(8)])
    whole = _feature(variables, xs)
    for i in range(8):
        assert whole[i].tobytes() == _feature(variables, xs[i]).tobytes()
    before = head_pass.launches
    bank = HeadBank()
    bank.add_head("a", _head(1))
    assert bank.dispatch(whole, ["a"] * 8).tobytes() == np.stack(
        [_oracle(variables, _head(1), x) for x in xs]).tobytes()
    assert head_pass.launches == before  # the CPU takes the plain version


# -- the two Server repairs ---------------------------------------------------

def test_server_submit_takes_the_jax_tenant_argument():
    """``Server.submit(example, timeout_ms=None, tenant=...)`` (the JAX
    call form) serves as without it and records the tenant on the
    request."""
    module = head_fanout_module(_variables())
    seen = []
    with Server(head_fanout_backbone_fn, module, max_batch_size=4,
                max_wait_ms=0.5, cache=False) as srv:
        real = srv._batcher.submit

        def spy(req):
            seen.append(req.tenant)
            return real(req)

        srv._batcher.submit = spy
        x = _payload(3)
        a = srv.submit(x, tenant="acme").result(10)
        b = srv.submit(x, None, "beta").result(10)
        c = srv.submit(x).result(10)
    assert a.tobytes() == b.tobytes() == c.tobytes()
    assert seen == ["acme", "beta", "default"]


def test_server_executable_state():
    """Per bucket: on the CPU, the bucket engine's ``id`` and 0 captures;
    the same object across calls and a head swap; empty before any
    bucket exists."""
    module = head_fanout_module(_variables())
    with Server(head_fanout_backbone_fn, module, max_batch_size=8,
                cache=False) as srv:
        assert srv.executable_state() == {}
        srv.warmup(_payload(0))
        state = srv.executable_state()
        assert sorted(state) == [2, 4, 8]
        for b, entry in state.items():
            assert entry == {"jit_id": id(srv._engine_for(b)),
                             "executables": 0}
        srv.predict(_payload(1))
        assert srv.executable_state() == state
