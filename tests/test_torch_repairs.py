"""Repairs of the port's engine caches, ``load_model``'s default and the
fused kernels under autograd, on the CPU.

* Graph memory: the zoo's engine cache is a ``ByteBoundedLRU`` sized by
  each engine's graph pool (known only after its first capture, so the
  cache reads the sizes again after each transform); eviction is least
  recently used first, and an evicted engine releases its graphs.  The
  pools are faked here (no card): ``graph_pool_bytes`` is what the cache
  reads.  A fitted model's engine lives on its transformer and goes with
  the model.
* ``load_model(name)`` defaults to ``weights="imagenet"``, as the JAX
  package's does.
* ``fused_sepconv`` / ``fused_mbconv`` refuse autograd (they have no
  backward), and a zoo model's route choice takes the unfused route
  whenever autograd records the forward; without autograd the fused
  route stays.
"""

import gc
import shutil
import types
import weakref

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
import sparkdl_tpu_torch.transformers.named_image as ni
from sparkdl_tpu_torch.models import layers
from sparkdl_tpu_torch.models import load_model
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
from sparkdl_tpu_torch.models.xception import Xception
from sparkdl_tpu_torch.ops import sepconv as ops
from sparkdl_tpu_torch.parallel import engine as engine_mod
from sparkdl_tpu_torch.utils.cache import BoundedCache, ByteBoundedLRU
from sparkdl_tpu.utils.cache import BoundedCache as JaxBoundedCache
from sparkdl_tpu.utils.cache import ByteBoundedLRU as JaxByteBoundedLRU


class _FakeEngine:
    """What the engine cache reads of an engine: its pool and its
    release."""

    def __init__(self, name, pool=0):
        self.name = name
        self.graph_pool_bytes = pool
        self.released = 0

    def release_graphs(self):
        self.released += 1
        self.graph_pool_bytes = 0


# -- ByteBoundedLRU / BoundedCache ------------------------------------------------
def test_caches_follow_the_jax_package():
    """The same puts and gets leave both packages' caches with the same
    entries in the same order and the same byte total."""
    ops_seq = [("put", "a", 30), ("put", "b", 30), ("get", "a", None),
               ("put", "c", 50), ("put", "d", 200), ("put", "b", 10),
               ("get", "c", None), ("put", "e", 40)]
    port, jax_lru = ByteBoundedLRU(100), JaxByteBoundedLRU(100)
    for op, k, n in ops_seq:
        for lru in (port, jax_lru):
            if op == "put":
                lru.put(k, np.zeros(n, np.uint8))
            else:
                lru.get(k)
        assert list(port._data) == list(jax_lru._data)
        assert port.total_bytes == jax_lru.total_bytes
    fifo, jax_fifo = BoundedCache(2), JaxBoundedCache(2)
    for k in "abcb":
        fifo.put(k, k)
        jax_fifo.put(k, k)
    assert list(fifo._data) == list(jax_fifo._data) == ["b", "c"]


def test_reaccount_evicts_least_recently_used_and_reports():
    evicted = []
    lru = ByteBoundedLRU(100, sizeof=lambda e: e.graph_pool_bytes,
                         on_evict=lambda k, e: evicted.append(k))
    engines = {k: _FakeEngine(k) for k in "abc"}
    for k in "abc":
        lru.put(k, engines[k])  # no pool before the first capture
    assert lru.total_bytes == 0 and evicted == []
    engines["a"].graph_pool_bytes = 40
    engines["b"].graph_pool_bytes = 40
    assert lru.reaccount() == [] and lru.total_bytes == 80
    lru.get("a")                     # order now b, c, a
    engines["c"].graph_pool_bytes = 40
    assert lru.reaccount(keep="c") == ["b"] and evicted == ["b"]
    assert list(lru._data) == ["c", "a"] and lru.total_bytes == 80
    # the entry in use is kept even alone over the bound; the rest go
    engines["c"].graph_pool_bytes = 150
    assert lru.reaccount(keep="c") == ["a"] and list(lru._data) == ["c"]
    assert lru.total_bytes == 150
    # without keep it goes too, and the total is back to 0
    assert lru.reaccount() == ["c"] and lru.total_bytes == 0 and len(lru) == 0
    # put evicts by the recorded sizes as the JAX cache does
    big = _FakeEngine("big", 60)
    lru.put("x", _FakeEngine("x", 50))
    lru.put("big", big)
    assert list(lru._data) == ["big"] and evicted[-1] == "x"
    assert lru.get("big") is big and lru.total_bytes == 60


def test_zoo_engine_cache_is_bounded_by_pool_bytes(monkeypatch):
    """The zoo's cache: its bound is ``ENGINE_POOL_SHARE`` of the card's
    memory (0 without a card), evicted engines release their graphs, and
    the engine just used is kept."""
    assert ni.new_engine_cache().cap_bytes == 0  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            total_memory=8 * 2**20))
    cache = ni.new_engine_cache()
    assert cache.cap_bytes == int(ni.ENGINE_POOL_SHARE * 8 * 2**20)
    assert cache.cap_bytes == 2 * 2**20
    a, b, c = (_FakeEngine(k) for k in "abc")
    for k, e in (("a", a), ("b", b)):
        cache.put(k, e)
    a.graph_pool_bytes = b.graph_pool_bytes = 1_200_000
    cache.reaccount(keep="b")
    assert a.released == 1 and b.released == 0 and list(cache._data) == ["b"]
    cache.put("c", c)
    c.graph_pool_bytes = 600_000
    cache.reaccount(keep="c")
    assert b.released == 0 and cache.total_bytes == 1_800_000


def test_zoo_transform_settles_the_cache(monkeypatch):
    """A zoo transform makes room in the cache before it builds its
    engine, and accounts the cache after it, keeping that engine."""
    seen = []
    cache = ni.new_engine_cache()
    real = cache.reaccount
    monkeypatch.setattr(cache, "reaccount",
                        lambda keep=None: seen.append(keep) or real(keep))
    monkeypatch.setattr(ni, "_ENGINE_CACHE", cache)
    monkeypatch.setattr(ni, "_MODEL_CACHE",
                        {("Xception", ""): torch.nn.Identity()})
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)

    monkeypatch.setattr(ni, "zoo_model_fn",
                        lambda name, featurize, compute_dtype=None:
                        lambda m, x: x.reshape(x.shape[0], -1)[:, :4].float())
    df = DataFrame(structsToArrow([imageArrayToStruct(
        np.zeros((299, 299, 3), np.uint8))]))
    with sparkdl_tpu_torch.default_device("cpu"):
        out = ni.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                     modelName="Xception",
                                     batchSize=1).transform(df)
        key = ni._zoo_engine_key("Xception", True, 1)
    assert len(out.table.column("f").to_pylist()[0]) == 4
    assert seen == [None, key]
    assert key in ni._ENGINE_CACHE


def test_engine_pool_accounting_and_release():
    """``graph_pool_bytes`` is the pool's bytes; ``release_graphs`` drops
    every graph and zeroes it; ``graph_pool_bytes_held`` sums the live
    engines'.  (The capture itself runs on the card only.)"""
    eng = engine_mod.InferenceEngine(lambda m, x: m(x),
                                     torch.nn.Linear(2, 2), device="cpu")
    held = engine_mod.graph_pool_bytes_held()
    assert eng.graph_pool_bytes == 0
    eng._core.graphs[("sig",)] = object()
    eng._core.pool_bytes = 1234
    assert engine_mod.graph_pool_bytes_held() == held + 1234
    eng.release_graphs()
    assert eng._core.graphs == {} and eng.graph_pool_bytes == 0
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None and engine_mod.graph_pool_bytes_held() == held


def test_dropped_fitted_model_frees_its_engine(tmp_path):
    """A fitted model's transform caches its engine (and so its graph
    pool on the card) on the model's transformer: dropping the model
    drops the engine, with no reference cycle to wait for."""
    from PIL import Image

    from sparkdl_tpu_torch.estimators import ImageFileEstimator
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction

    paths = []
    for i in range(8):
        p = str(tmp_path / f"{i}.png")
        Image.fromarray(np.full((4, 4, 3), 30 * i, np.uint8)).save(p)
        paths.append(p)
    df = DataFrame({"uri": paths,
                    "label": [[1.0, 0.0] if i % 2 else [0.0, 1.0]
                              for i in range(8)]})
    net = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(48, 2),
                              torch.nn.Softmax(-1))
    est = ImageFileEstimator(
        inputCol="uri", outputCol="p", labelCol="label",
        modelFunction=ModelFunction.from_module(net), imageLoader=_load4,
        optimizer="sgd", batchSize=8)
    # torch imports its compiler on the first optimizer it builds, and
    # that import keeps the frames it ran in: build one first
    torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    gc.disable()  # only reference counts may free it
    try:
        with sparkdl_tpu_torch.default_device("cpu"):
            model = est.fit(df)
            model.transform(df)
        (engine,) = [e for e in list(engine_mod._LIVE_ENGINES)
                     if e.module is not net and
                     e in _engines_of(model)]
        ref = weakref.ref(engine)
        del engine
        assert ref() is not None
        del model
        assert ref() is None
    finally:
        gc.enable()


def _load4(uri):
    from PIL import Image

    return np.asarray(Image.open(uri).convert("RGB"), np.float32) / 255.0


def _engines_of(model):
    t = model.__dict__["_transformer_cache"][1]
    return [entry[1] for entry in t.__dict__["_engine_cache"].values()]


# -- load_model's default --------------------------------------------------------
def test_load_model_default_reads_the_weights_dir(tmp_path, monkeypatch):
    """``load_model("ResNet50")`` with no ``weights`` reads the
    Keras-layout file in ``$SPARKDL_WEIGHTS_DIR``, as JAX's
    ``weights="imagenet"`` default does; without a file it warns and gives
    the seeded init."""
    import keras

    from sparkdl_tpu_torch import models as port_models

    model = keras.applications.ResNet50(weights=None)
    rng = np.random.default_rng(3)
    dense = model.get_layer("predictions")
    k, b = dense.get_weights()
    dense.set_weights([rng.normal(0, 0.01, k.shape).astype(np.float32),
                       rng.normal(0, 0.01, b.shape).astype(np.float32)])
    path = tmp_path / "src.weights.h5"
    model.save_weights(str(path))
    want = load_model("ResNet50", weights=str(path)).state_dict()
    wdir = tmp_path / "weights"
    wdir.mkdir()
    monkeypatch.setenv("SPARKDL_WEIGHTS_DIR", str(wdir))
    warned = []
    monkeypatch.setattr(port_models.logger, "warning",
                        lambda *a, **k: warned.append(a))
    seeded = load_model("ResNet50").state_dict()
    assert len(warned) == 1
    assert all(torch.equal(seeded[n], t) for n, t in
               load_model("ResNet50", weights=None).state_dict().items())
    shutil.copy(path, wdir / "ResNet50.weights.h5")
    got = load_model("ResNet50").state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert not torch.equal(got["predictions.weight"],
                           seeded["predictions.weight"])
    assert len(warned) == 1


# -- no silent gradient cut -------------------------------------------------------
def _sepconv_operands(seed, grad_on=None, mbconv=False):
    """(x, dwk, pw, scale, shift), or mbconv's (x, dwk, pw, mid_shift,
    shift), C = 8, F = 16; ``grad_on`` marks one to require grad."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, 4, 4, 8, generator=g)
    dwk = torch.randn(3, 3, 8, generator=g)
    pw = torch.randn(8, 16, generator=g)
    scale = torch.rand(8 if mbconv else 16, generator=g) + 0.5
    shift = torch.randn(16, generator=g)
    ops_ = [x, dwk, pw, scale, shift]
    if grad_on is not None:
        ops_[grad_on].requires_grad_(True)
    return ops_


@pytest.mark.parametrize("grad_on", range(5))
def test_fused_sepconv_refuses_autograd(grad_on):
    args = _sepconv_operands(0, grad_on)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_sepconv(*args)
    with torch.no_grad():  # without autograd it runs as before
        out = ops.fused_sepconv(*args)
    torch.testing.assert_close(
        out, ops.fused_sepconv(*_sepconv_operands(0)), rtol=0, atol=0)


@pytest.mark.parametrize("grad_on", range(5))
def test_fused_mbconv_refuses_autograd(grad_on):
    args = _sepconv_operands(1, grad_on, mbconv=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_mbconv(*args)
    with torch.inference_mode():
        out = ops.fused_mbconv(*[a.detach() for a in args])
    torch.testing.assert_close(
        out, ops.fused_mbconv(*_sepconv_operands(1, mbconv=True)),
        rtol=0, atol=0)


def test_route_choice_follows_autograd(monkeypatch):
    """A forced fused route (the CPU parity tests' route, where the
    kernels' plain versions run) is taken without autograd and left for
    the unfused route when autograd records the forward; the gradient then
    reaches every sepconv's weights."""
    calls = []
    real = ops.fused_sepconv

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(layers, "fused_sepconv", counting)
    model = Xception(num_classes=3, fused_inference=True).eval()
    layers_init(model)
    x = torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        model(x)
    assert len(calls) == 34
    calls.clear()
    model(x, logits=True)[:, 0].sum().backward()
    assert calls == []
    assert model.block5_sepconv1.pointwise_weight.grad is not None
    assert float(model.block5_sepconv1.pointwise_weight.grad.abs().sum()) > 0
    # frozen parameters and no input grad: nothing records, fused again
    model.requires_grad_(False)
    model(x)
    assert len(calls) == 34
    mnv2 = MobileNetV2(num_classes=3, fused_inference=True).eval()
    layers_init(mnv2)
    assert layers.grad_needed(mnv2, x)
    with torch.no_grad():
        assert not layers.grad_needed(mnv2, x)


def layers_init(model):
    from sparkdl_tpu_torch.models import init_weights

    init_weights(model, torch.Generator().manual_seed(0))
