"""Tests of the port's engine that need an NVIDIA GPU (marker ``cuda``):
they skip on a machine without one.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

The file imports torch and the port only (``--noconftest`` skips the
suite's JAX set-up), so it runs where JAX is not installed.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn as nn

pytestmark = pytest.mark.cuda

B = 8  # device batch
# B1 launches in one 96x96 Xception forward: the 30 stride-1 sepconvs and,
# at this size, the 4 entry ones.
XC96_B1_LAUNCHES = 34


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _conv_engine():
    """A small conv engine over uint8 NHWC images, as the zoo engines
    take them."""
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    torch.manual_seed(0)
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                        nn.AdaptiveAvgPool2d(1), nn.Flatten())

    def fn(m, x):
        return m(x.permute(0, 3, 1, 2).float() / 255)

    return InferenceEngine(fn, net, device="cuda", device_batch_size=B)


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)


def test_concurrent_pipelined_calls_on_one_engine(cuda):
    """Four threads call one engine at once, pipelined, three times each:
    every output equals that input's serial output bit for bit (each run
    stages its pieces in its own pinned buffers)."""
    eng = _conv_engine()
    xs = [_images(i, B * 12 + 5) for i in range(4)]
    want = [eng(x, pipeline=False) for x in xs]
    got, errors = [[] for _ in xs], []

    def work(i):
        try:
            for _ in range(3):
                got[i].append(eng(xs[i], pipeline=True))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for outs, w in zip(got, want):
        assert len(outs) == 3
        for o in outs:
            np.testing.assert_array_equal(o, w)


def test_run_started_while_another_is_half_consumed(cuda):
    """A pipelined run whose generator is half consumed (its threads alive,
    pieces staged ahead) and a new run on the same engine do not disturb
    each other."""
    eng = _conv_engine()
    x, y = _images(1, B * 10 + 3), _images(2, B * 10 + 3)
    want_x = eng(x, pipeline=False)
    want_y = eng(y, pipeline=False)
    it = eng.map_batches([x], pipeline=True)
    first = next(it)
    np.testing.assert_array_equal(eng(y, pipeline=True), want_y)
    np.testing.assert_array_equal(
        np.concatenate([first] + list(it)), want_x)


@pytest.mark.parametrize("k", [1, 2])
def test_pytree_two_leaves_of_one_shape_pipelined(cuda, k):
    """Two float leaves of one shape and dtype through the pipelined path:
    each gets its own pinned buffer and device slot; pipelined == serial
    bit for bit, and both within 1e-5 of the CPU engine."""
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    torch.manual_seed(0)
    lin = nn.Linear(16, 4)
    rng = np.random.default_rng(3)
    batch = {"a": rng.normal(size=(B * 6 + 3, 16)).astype(np.float32),
             "b": rng.normal(size=(B * 6 + 3, 16)).astype(np.float32)}

    def fn(m, t):
        return {"a": m(t["a"]), "b": m(t["b"])}

    ref = InferenceEngine(fn, lin, device="cpu", device_batch_size=B)(batch)
    eng = InferenceEngine(fn, lin, device="cuda", device_batch_size=B,
                          batches_per_dispatch=k)
    piped = eng(batch, pipeline=True)
    serial = eng(batch, pipeline=False)
    for key in ("a", "b"):
        np.testing.assert_array_equal(piped[key], serial[key])
        np.testing.assert_allclose(piped[key], ref[key], rtol=1e-5,
                                   atol=1e-5)
    assert not np.array_equal(piped["a"], piped["b"])


class _Folded(nn.Module):
    """A bias-free Linear with a BatchNorm folded into it once per weights
    version (``layers.cached_fold``), as the zoo models fold theirs."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(16, 8, bias=False)
        self.bn = nn.BatchNorm1d(8)
        with torch.no_grad():
            self.bn.running_var.uniform_(0.5, 2.0)
            self.bn.running_mean.uniform_(-1.0, 1.0)
        self._folds = {}

    def _fold(self):
        s = self.bn.weight / torch.sqrt(self.bn.running_var + self.bn.eps)
        t = self.bn.bias - self.bn.running_mean * s
        return self.lin.weight * s[:, None], t

    def forward(self, x):
        from sparkdl_tpu_torch.models.layers import cached_fold

        w, t = cached_fold(
            self._folds, "lin",
            [self.lin.weight, self.bn.weight, self.bn.bias,
             self.bn.running_mean, self.bn.running_var], self._fold)
        return x @ w.t() + t


def test_cleared_fold_cache_recaptures(cuda):
    """A write through ``.data`` moves no version counter; clearing the
    fold cache after it makes the engine capture again, and the graphed
    output equals the eager one with the new weights."""
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    torch.manual_seed(0)
    eng = InferenceEngine(lambda m, x: m(x), _Folded(), device="cuda",
                          device_batch_size=B)
    x = np.random.default_rng(4).normal(size=(B, 16)).astype(np.float32)

    def eager():
        eng.capture = False
        try:
            return eng.run_padded(x)
        finally:
            eng.capture = True

    first = eng.run_padded(x)
    assert torch.equal(first, eager())
    assert eng.metrics.counters["engine.graph_captures"] == 1
    eng.module.bn.running_var.data.mul_(4.0)
    eng.module._folds.clear()
    junk = [torch.full((B, 16), 7.0, device="cuda") for _ in range(8)]
    second = eng.run_padded(x)
    assert eng.metrics.counters["engine.graph_captures"] == 2
    assert torch.equal(second, eager())
    assert not torch.equal(second, first)
    del junk


@pytest.mark.parametrize("mode", ["tf", "caffe", "torch", "none"])
def test_every_preprocess_mode_runs_in_a_captured_forward(cuda, mode):
    """The zoo's preprocess modes inside the engine's captured forward: a
    per-channel constant made during the capture would be a host-to-device
    copy, which a capture refuses (caffe and torch modes make theirs once
    per device, at the eager warm-up)."""
    from sparkdl_tpu_torch.models.preprocess import get_preprocess_fn
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    pre = get_preprocess_fn(mode)
    eng = InferenceEngine(lambda m, x: m(pre(x)), nn.Identity(),
                          device="cuda", device_batch_size=B)
    x = np.random.default_rng(5).integers(0, 256, (B, 8, 8, 3),
                                          dtype=np.uint8)
    got = eng(x)
    assert eng.metrics.counters["engine.graph_captures"] == 1
    np.testing.assert_allclose(got, pre(torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-6)


def _branchy_config():
    """A branchy CNN's Keras model config (Keras 2's node form), written
    out here: the card has no Keras to make one.  Stride-2 SAME pools at
    odd sizes, H != W."""
    def layer(cls, name, cfg, *inputs):
        return {"class_name": cls, "name": name,
                "config": dict(cfg, name=name),
                "inbound_nodes": ([[[i, 0, 0, {}] for i in inputs]]
                                  if inputs else [])}

    conv = {"kernel_size": [3, 3], "strides": [1, 1], "padding": "same",
            "use_bias": True, "activation": "linear"}
    pool = {"pool_size": [3, 3], "strides": [2, 2], "padding": "same"}
    layers = [
        layer("InputLayer", "img", {"batch_input_shape": [None, 17, 15, 3]}),
        layer("Rescaling", "scale", {"scale": 1 / 127.5, "offset": -1.0},
              "img"),
        layer("Conv2D", "c1", dict(conv, filters=8, strides=[2, 2]), "scale"),
        layer("BatchNormalization", "bn1", {"axis": -1, "epsilon": 1e-3,
                                            "center": True, "scale": True},
              "c1"),
        layer("ReLU", "relu", {}, "bn1"),
        layer("SeparableConv2D", "sep", dict(conv, filters=8,
                                             depth_multiplier=1), "relu"),
        layer("DepthwiseConv2D", "dw", dict(conv, depth_multiplier=1),
              "relu"),
        layer("Add", "add", {}, "sep", "dw"),
        layer("AveragePooling2D", "avg", pool, "add"),
        layer("MaxPooling2D", "max", pool, "add"),
        layer("Concatenate", "cat", {"axis": -1}, "avg", "max"),
        layer("Conv2D", "c2", dict(conv, filters=4, kernel_size=[1, 1],
                                   activation="relu"), "cat"),
        layer("Flatten", "flat", {}, "c2"),
        layer("Dense", "d", {"units": 3, "activation": "softmax"}, "flat"),
    ]
    return {"class_name": "Functional", "config": {
        "name": "branchy", "layers": layers,
        "input_layers": [["img", 0, 0]], "output_layers": [["d", 0, 0]]}}


def _branchy_model_function():
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.graph.keras_convert import KerasModel

    module = KerasModel(_branchy_config())
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75
                    if name.endswith("running_var") else
                    torch.randn(t.shape, generator=g) * 0.3)
    return ModelFunction.from_module(module, input_names=("img",),
                                     output_names=("d",))


def test_converted_keras_model_is_captured(cuda):
    """The converter's module (NHWC tensors, a permuted view per conv and
    pool, BatchNorm on its moving statistics) runs as one captured graph:
    graphed == eager bit for bit, and the card within 1e-4 of the CPU with
    TF32 off."""
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    mf = _branchy_model_function()
    x = np.random.default_rng(2).integers(0, 256, (B, 17, 15, 3)).astype(
        np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        eng = InferenceEngine(mf.fn, mf.module, device="cuda",
                              device_batch_size=B)
        graphed = eng.run_padded(x)
        eng.capture = False
        eager = eng.run_padded(x)
        eng.capture = True
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert eng.metrics.counters["engine.graph_captures"] == 1
    assert torch.equal(graphed, eager)
    cpu = InferenceEngine(mf.fn, mf.module, device="cpu",
                          device_batch_size=B)(x)
    np.testing.assert_allclose(graphed.cpu().numpy(), cpu, rtol=1e-4,
                               atol=1e-6)


def test_image_udf_converter_stage_is_captured(cuda):
    """The image UDF's converter stage (uint8 BGR -> float RGB, inside the
    program) composed with a converted model, on an image-struct column:
    the card's UDF (its engine captures by default) equals the CPU's
    within 1e-4; a null row stays null."""
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.image.schema import (imageArrayToStruct,
                                                structsToArrow)
    from sparkdl_tpu_torch.udf import UDFRegistry, register_image_udf

    rng = np.random.default_rng(3)
    structs = [imageArrayToStruct(rng.integers(0, 256, (17, 15, 3),
                                               dtype=np.uint8))
               for _ in range(B + 3)] + [None]
    col = structsToArrow(structs).column("image")
    reg = UDFRegistry()
    udf = register_image_udf("branchy", _branchy_model_function(),
                             input_size=(17, 15), registry=reg, batch_size=B)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = udf(col)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    with sparkdl_tpu_torch.default_device("cpu"):
        cpu_reg = UDFRegistry()
        want = register_image_udf("branchy", _branchy_model_function(),
                                  input_size=(17, 15), registry=cpu_reg,
                                  batch_size=B)(col)
    assert got[-1] is None and want[-1] is None
    np.testing.assert_allclose(np.asarray(got[:-1]), np.asarray(want[:-1]),
                               rtol=1e-4, atol=1e-6)


def test_buckets_share_one_pool_and_release(cuda):
    """Two buckets (a plain batch and a group of 2) capture into the
    engine's one pool: both replay bit for bit as eager, the engine's pool
    bytes are what the pool reserved, and ``release_graphs`` drops the
    graphs and the pool; the next dispatch captures again."""
    from sparkdl_tpu_torch.parallel.engine import graph_pool_bytes_held

    eng = _conv_engine()
    eng.batches_per_dispatch = 2
    x = _images(3, 2 * B + 3)  # one group of 2 and a plain tail
    graphed = eng(x, pipeline=False)
    assert len(eng.graphs()) == 2 and eng.graph_pool_bytes > 0
    assert eng.graph_pool_bytes == sum(g["pool_bytes"] for g in eng.graphs())
    assert graph_pool_bytes_held() >= eng.graph_pool_bytes
    eng.capture = False
    eager = eng(x, pipeline=False)
    eng.capture = True
    np.testing.assert_array_equal(graphed, eager)
    eng.release_graphs()
    assert eng.graphs() == [] and eng.graph_pool_bytes == 0
    np.testing.assert_array_equal(eng(x, pipeline=False), graphed)
    assert len(eng.graphs()) == 2


@pytest.mark.parametrize("n,c", [(1, 100), (7, 129), (32, 1000)])
def test_head_kernel_equals_plain_bit_for_bit(cuda, n, c):
    """Kernel H1 (the head fan-out's head pass) equals its plain version
    on the same tensors bit for bit, and counts one launch."""
    from sparkdl_tpu_torch.ops.head import head_pass, head_pass_reference

    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.normal(size=(n, 2048)).astype(
        np.float32)).to(cuda)
    kernel = torch.from_numpy((rng.normal(size=(64, 2048, c))
                               / np.sqrt(2048)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=(64, c)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda)
    before = head_pass.launches
    out = head_pass(feats, idx, kernel, bias)
    assert head_pass.launches == before + 1
    assert torch.equal(out, head_pass_reference(feats, idx, kernel, bias))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,offset", [(1, 100, 0), (7, 129, 0),
                                        (32, 1000, 0), (7, 100, 1),
                                        (3, 64, 3)])
def test_head_kernel_bf16_equals_plain_bit_for_bit(cuda, dtype, n, c,
                                                   offset):
    """Kernel H1 on bf16 (and f32) weights equals its plain version on the
    same tensors bit for bit, and counts one launch; a bank that starts
    ``offset`` elements into its storage takes the kernel's narrower
    copies.  Rows whose tenant index lies outside the bank come back NaN."""
    from sparkdl_tpu_torch.ops.head import head_pass, head_pass_reference

    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.normal(size=(n, 2048)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy((rng.normal(size=64 * 2048 * c + offset)
                          / np.sqrt(2048)).astype(np.float32))
    kernel = w.to(cuda, dtype)[offset:].view(64, 2048, c)
    bias = torch.from_numpy(rng.normal(size=(64, c)).astype(
        np.float32)).to(cuda, dtype)
    idx = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda)
    before = head_pass.launches
    out = head_pass(feats, idx, kernel, bias)
    assert head_pass.launches == before + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, head_pass_reference(feats, idx, kernel, bias))
    bad = idx.clone()
    bad[0] = 64
    rows = head_pass(feats, bad, kernel, bias)
    assert torch.isnan(rows[0]).all()
    assert torch.equal(rows[1:], out[1:])


@pytest.mark.parametrize("pattern", ["one head", "pairs", "65 rows",
                                     "outside the bank"])
def test_head_kernel_rows_that_share_a_head(cuda, pattern):
    """Rows that name one head (their blocks read its tiles together)
    equal the plain version bit for bit, and the same rows alone: a row's
    bits do not move with who shares its head."""
    from sparkdl_tpu_torch.ops.head import head_pass, head_pass_reference

    n = 65 if pattern == "65 rows" else 32
    rng = np.random.default_rng(9)
    feats = torch.from_numpy(rng.normal(size=(n, 2048)).astype(
        np.float32)).to(cuda)
    kernel = torch.from_numpy((rng.normal(size=(8, 2048, 100))
                               / np.sqrt(2048)).astype(np.float32)).to(
                                   cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(8, 100)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    idx = {"one head": np.zeros(n), "pairs": np.arange(n) // 2 % 8,
           "65 rows": np.arange(n) % 3,
           "outside the bank": np.where(np.arange(n) % 5 == 0, 8,
                                        np.arange(n) % 2)}[pattern]
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    out = head_pass(feats, idx, kernel, bias)
    bad = idx >= 8
    assert torch.isnan(out[bad]).all()
    good = ~bad
    assert torch.equal(out[good], head_pass_reference(
        feats[good], idx[good], kernel, bias))
    for r in (0, 1, n - 1):
        alone = head_pass(feats[r:r + 1], idx[r:r + 1], kernel, bias)
        if bool(bad[r]):
            assert torch.isnan(alone).all()
        else:
            assert torch.equal(alone, out[r:r + 1])


@pytest.mark.parametrize("pipeline", [False, True])
def test_device_ms_from_timing_events_only_while_tracing(cuda, pipeline,
                                                         monkeypatch):
    """Tracing on: the span that forces each dispatch carries ``device_ms``
    from the two timing events around its replay (``engine.call`` on the
    serial path, ``pipeline.gather`` in the runner), and the outputs equal
    tracing off bit for bit.  Tracing off: no timing event is made."""
    from sparkdl_tpu_torch.obs import trace
    from sparkdl_tpu_torch.parallel import engine as engine_mod

    monkeypatch.setattr(trace, "_tracer", trace._tracer)
    eng = _conv_engine()
    x = _images(5, B * 3 + 2)
    made = []
    real = engine_mod._timing_event

    def counted(stream):
        made.append(1)
        return real(stream)

    monkeypatch.setattr(engine_mod, "_timing_event", counted)
    trace.configure(enabled=False)
    off = eng(x, pipeline=pipeline)
    assert made == []
    tracer = trace.configure(enabled=True)
    on = eng(x, pipeline=pipeline)
    np.testing.assert_array_equal(on, off)
    forcing = "pipeline.gather" if pipeline else "engine.call"
    spans = [s for s in tracer.snapshot() if s["name"] == forcing]
    ms = [s["attrs"]["device_ms"] for s in spans]
    assert len(ms) == (4 if pipeline else 1) and all(m > 0 for m in ms)
    assert len(made) == 2 * 4  # a pair around each of the 4 replays
    trace.configure(enabled=False)


def test_engine_spans_under_a_profiler(cuda, monkeypatch):
    """A profiler collecting, ``SPARKDL_TRACE`` off: each dispatch records
    ``engine.upload`` and ``engine.replay`` under ``engine.dispatch``, each
    gather ``engine.fetch`` and ``engine.trim`` under ``pipeline.gather``,
    the first dispatch ``engine.capture``; no timing event is made and the
    outputs equal those with nothing on."""
    from torch.profiler import ProfilerActivity, profile

    from sparkdl_tpu_torch.obs import trace
    from sparkdl_tpu_torch.parallel import engine as engine_mod

    monkeypatch.setattr(trace, "_tracer", trace._tracer)
    made = []
    real = engine_mod._timing_event

    def counted(stream):
        made.append(1)
        return real(stream)

    monkeypatch.setattr(engine_mod, "_timing_event", counted)
    tracer = trace.configure(enabled=False)
    x = _images(6, B * 3 + 2)
    off = _conv_engine()(x, pipeline=True)
    eng = _conv_engine()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = eng(x, pipeline=True)
    np.testing.assert_array_equal(on, off)
    assert made == []
    spans = tracer.snapshot()
    by_id = {s["span_id"]: s for s in spans}

    def parents(name):
        return [by_id[s["parent_id"]]["name"] for s in spans
                if s["name"] == name]

    assert parents("engine.upload") == ["engine.dispatch"] * 4
    assert parents("engine.replay") == ["engine.dispatch"] * 4
    assert parents("engine.capture") == ["engine.dispatch"]
    assert parents("engine.fetch") == ["pipeline.gather"] * 4
    assert parents("engine.trim") == ["pipeline.gather"] * 4
    assert all(s["attrs"]["rows"] == B for s in spans
               if s["name"] in ("engine.upload", "engine.replay"))
    assert not any("device_ms" in (s.get("attrs") or {}) for s in spans)


def _sepconv_engine(seed):
    """An engine whose forward is one B1 launch (uint8 NHWC 19x19x256 in,
    728 features out, pooled)."""
    from sparkdl_tpu_torch.ops import fused_sepconv
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    g = torch.Generator().manual_seed(seed)
    m = nn.Module()
    m.register_buffer("dwk", torch.randn(3, 3, 256, generator=g))
    m.register_buffer("pw", torch.randn(256, 728, generator=g) / 16)
    m.register_buffer("scale", torch.ones(728))
    m.register_buffer("shift", torch.zeros(728))

    def fn(m, x):
        y = fused_sepconv(x.float() / 255, m.dwk, m.pw, m.scale, m.shift,
                          True)
        return y.float().mean((1, 2))

    return InferenceEngine(fn, m, device="cuda", device_batch_size=B)


def test_capture_records_its_own_launches_while_another_engine_replays(
        cuda):
    """Engine b captures (three times) while two threads replay engine a
    without pause: each of b's captures records its own single B1 launch,
    not a's replay credits, and b's rows equal its eager forward's."""
    from sparkdl_tpu_torch.ops import sepconv as ops

    a, b = _sepconv_engine(0), _sepconv_engine(1)
    x = np.random.default_rng(0).integers(0, 256, (B, 19, 19, 256),
                                          dtype=np.uint8)
    a(x)
    assert [g["launches"] for g in a.graphs()] == [(1, 0, 0)]
    stop, errors = threading.Event(), []

    def hammer():
        try:
            while not stop.is_set():
                a(x)
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        records = []
        for _ in range(3):
            b.release_graphs()
            before = ops.launch_counts()[0]
            graphed = b(x)
            records.append(b.graphs()[0]["launches"])
            assert ops.launch_counts()[0] > before
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert records == [(1, 0, 0)] * 3
    b.capture = False
    np.testing.assert_array_equal(graphed, b(x))


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_stream_commit_fault_resumes_bit_for_bit(cuda, tmp_path, pipeline):
    """A StreamScorer over a captured Xception engine (96x96, B1 in every
    dispatch: its 30 sepconvs and, at this size, the 4 entry ones too):
    an injected ``stream.commit`` fault kills the first run between an
    output artifact and its commit; the resumed run's output equals an
    uninterrupted run's and the engine's batch output, bit for bit, and
    the engine captured once for all three runs."""
    from sparkdl_tpu_torch import faults, streaming
    from sparkdl_tpu_torch.models import get_model_spec
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image as ni

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    module = get_model_spec("Xception").build().eval()
    eng = InferenceEngine(ni.zoo_model_fn("Xception", True), module,
                          device="cuda", device_batch_size=B)
    rng = np.random.default_rng(5)
    chunks = [rng.integers(0, 256, (B, 96, 96, 3), dtype=np.uint8)
              for _ in range(6)]
    oracle = np.concatenate(list(eng.map_batches(chunks, pipeline=False)))

    def run(base, plan=None):
        sc = streaming.StreamScorer(
            eng, streaming.MemorySource(chunks, finished=True),
            journal_path=str(base / "j.jsonl"), out_dir=str(base / "out"),
            pipeline=pipeline, cache=False)
        try:
            if plan is None:
                return sc.run()
            with faults.active(faults.FaultPlan.parse(plan)):
                with pytest.raises(faults.InjectedFatalError):
                    sc.run()
        finally:
            sc.close()

    run(tmp_path / "whole")
    whole = streaming.assemble_outputs(str(tmp_path / "whole" / "j.jsonl"),
                                       str(tmp_path / "whole" / "out"))
    run(tmp_path / "cut", "stream.commit:error:exc=fatal,at=3")
    summary = run(tmp_path / "cut")
    cut = streaming.assemble_outputs(str(tmp_path / "cut" / "j.jsonl"),
                                     str(tmp_path / "cut" / "out"))
    assert summary["resume_offset"] == 2 and summary["redeliveries"] >= 1
    assert summary["committed_total"] == len(chunks)
    np.testing.assert_array_equal(cut, whole)
    np.testing.assert_array_equal(cut, oracle)
    (graph,) = eng.graphs()
    assert graph["launches"] == (XC96_B1_LAUNCHES, 0, 0)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("sparkdl-pipeline")]


# -- the captured training step ------------------------------------------------


def _fit_data(n=20):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(n, 3, 12, 12)).astype(np.float32)
    y = (np.arange(n) % 4).astype(np.int64)
    return x, y


def _conv_fit(optimizer, eager=False, spe=1, stats=False, monkeypatch=None,
              epochs=4, mesh=None):
    """Fit a small conv net (BatchNorm statistics trained when ``stats``)
    on the card, 3 steps an epoch (4 epochs: 11 replays, enough to pay
    for a capture); ``eager`` forces the module's eager step through its
    own ``step_mode`` (a patch of this test, no knob of the fit); ``mesh``
    fits on that mesh's data groups, each with its own copy of the net
    (the groups of a step with statistics run at once, in threads)."""
    import copy

    from sparkdl_tpu_torch.graph.function import apply_with
    from sparkdl_tpu_torch.models.layers import (current_data_group,
                                                 flax_batch_norm_train)
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.utils.metrics import Metrics

    torch.manual_seed(0)
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8),
                        nn.ReLU(), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                        nn.Linear(8, 4)).cuda()
    params = {k: v.detach() for k, v in net.named_parameters()}
    bn_stats = {k: v.detach() for k, v in net.named_buffers()
                if k.endswith(("running_mean", "running_var"))}

    def predict(p, x):
        return apply_with(lambda m, t: m(t), net.eval(), p, x)

    nets = [net, copy.deepcopy(net)]

    def train_fn(v, x):
        def fwd(m, t):
            h = m[0](t)
            h = flax_batch_norm_train(m[1], h)
            return m[5](m[4](m[3](m[2](h))))

        group = current_data_group()
        pred = apply_with(fwd, nets[group[0] if group else 0],
                          {**v["params"], **v["batch_stats"]}, x)
        return pred, v["batch_stats"]

    if eager:
        monkeypatch.setattr(train, "step_mode",
                            lambda *a, **k: ("eager", "reference"))
    x, y = _fit_data()
    m = Metrics()
    # cuDNN's default wgrad algorithms are not deterministic (eager
    # against eager differs): hold the step's math fixed
    torch.backends.cudnn.deterministic = True
    try:
        out = train.fit_data_parallel(
            predict, params, x, y, optimizer=NamedOptimizer(optimizer),
            loss=train.softmax_cross_entropy, batch_size=8, epochs=epochs,
            steps_per_execution=spe, metrics=m, device="cuda", mesh=mesh,
            train_fn=train_fn if stats else None,
            stats=bn_stats if stats else None)
    finally:
        torch.backends.cudnn.deterministic = False
    if eager:
        monkeypatch.undo()
    return out, m


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("opt", ["sgd", "adam", "lamb"])
def test_captured_fit_equals_the_eager_fit(cuda, opt, monkeypatch):
    """One warm-up step, then one captured graph replayed a step: the
    loss series and the fitted tensors of the eager fit."""
    (fit_c, loss_c), mc = _conv_fit(opt)
    (fit_e, loss_e), me = _conv_fit(opt, eager=True, monkeypatch=monkeypatch)
    assert mc.counters["train.step_mode.captured"] == 1
    assert me.counters["train.step_mode.eager"] == 1
    assert mc.counters["train.captures"] == 1
    assert mc.gauges["train.graph_pool_bytes"] > 0
    assert _rel(loss_c, loss_e) <= 1e-6
    for k in fit_e:
        assert _rel(fit_c[k], fit_e[k]) <= 2e-4, k


def test_k_step_groups_capture_one_graph_per_length(cuda):
    """``steps_per_execution=3`` over three steps an epoch: the warm-up
    step, a tail group of 2, then groups of 3; one graph per length, the
    loss series of one-step groups and one fetch a group (17 epochs: 50
    replayed steps pay for the 5 captured)."""
    (fit1, loss1), m1 = _conv_fit("adam", epochs=17)
    (fit3, loss3), m3 = _conv_fit("adam", spe=3, epochs=17)
    assert m3.counters["train.step_mode.captured"] == 1
    assert m3.counters["train.captures"] == 2
    assert m3.counters["train.loss_fetches"] == 18  # warm-up, 2, 3 x 16
    assert m1.counters["train.loss_fetches"] == 51
    assert _rel(loss3, loss1) <= 1e-6
    for k in fit1:
        assert _rel(fit3[k], fit1[k]) <= 2e-4, k


def test_captured_batch_stats_fit_equals_eager(cuda, monkeypatch):
    """``train_fn`` + ``stats``: the statistics are written in place in
    the graph; captured and eager agree."""
    (fit_c, loss_c), mc = _conv_fit("sgd", stats=True)
    (fit_e, loss_e), _ = _conv_fit("sgd", eager=True, stats=True,
                                   monkeypatch=monkeypatch)
    assert mc.counters["train.step_mode.captured"] == 1
    assert _rel(loss_c, loss_e) <= 1e-6
    for part in ("params", "batch_stats"):
        for k in fit_e[part]:
            assert _rel(fit_c[part][k], fit_e[part][k]) <= 2e-4, k


def test_dp2_slot_fit_equals_the_one_device_fit(cuda):
    """Two slots of the card: each global batch of 8 is split into two data
    groups of 4, run one after the other inside the captured step; the
    losses and fitted tensors are the one-device fit's (the gradients summed
    in another order).  With BatchNorm statistics over the groups (their
    sums meet between the groups' threads) the fit runs eagerly, chosen up
    front, and agrees too."""
    from sparkdl_tpu_torch.parallel.mesh import get_mesh

    two = get_mesh(devices=["cuda:0"] * 2)
    (fit2, loss2), m2 = _conv_fit("sgd", mesh=two)
    (fit1, loss1), m1 = _conv_fit("sgd")
    assert m2.counters["train.step_mode.captured"] == 1
    assert m2.gauges["train.data_groups"] == 2
    assert m1.gauges["train.data_groups"] == 1
    assert _rel(loss2, loss1) <= 1e-6
    for k in fit1:
        assert _rel(fit2[k], fit1[k]) <= 2e-4, k
    (fs2, ls2), ms2 = _conv_fit("sgd", mesh=two, stats=True)
    (fs1, ls1), _ = _conv_fit("sgd", stats=True)
    assert ms2.counters["train.step_mode.eager"] == 1
    assert _rel(ls2, ls1) <= 1e-6
    for part in ("params", "batch_stats"):
        for k in fs1[part]:
            assert _rel(fs2[part][k], fs1[part][k]) <= 2e-4, k


def test_fit_releases_its_graph_pool(cuda):
    """A fit's graphs and pool go when it returns: three fits in a row
    leave the card's reserved memory where one left it."""
    torch.cuda.synchronize()
    _conv_fit("adam")
    torch.cuda.empty_cache()
    after_one = torch.cuda.memory_reserved()
    for _ in range(3):
        _, m = _conv_fit("adam")
        assert m.gauges["train.graph_pool_bytes"] > 0
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= after_one + (2 << 20)


def test_short_fit_runs_eagerly_on_the_card(cuda):
    """Two epochs of 3 steps replay one captured step 5 times, too few to
    pay for the capture: the fit's steps stay eager and it says so."""
    (_, losses), m = _conv_fit("sgd", epochs=2)
    assert m.counters["train.step_mode.eager"] == 1
    assert "train.captures" not in m.counters and len(losses) == 2


def test_anomaly_mode_fit_runs_eagerly_and_localises_a_nan(cuda):
    """``utils.debug.enable_checks()`` turns on anomaly mode, whose checks
    sync with the host: a fit long enough to be captured runs eagerly
    and reports it, and a NaN planted in the backward raises on the card
    as on the CPU, naming the op."""
    from sparkdl_tpu_torch.param.converters import NamedOptimizer
    from sparkdl_tpu_torch.parallel import train
    from sparkdl_tpu_torch.utils import debug

    x, y = _fit_data()

    def planted(p, xb):  # d/dz sqrt(z) at z = 0, times 0: a NaN
        return xb.flatten(1)[:, :4] @ p["w"] + torch.sqrt(p["z"]) * 0.0

    debug.enable_checks()
    try:
        (_, losses), m = _conv_fit("sgd")
        assert m.counters["train.step_mode.eager"] == 1
        assert "train.captures" not in m.counters
        assert np.isfinite(losses).all()
        for device in ("cpu", "cuda"):
            with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
                train.fit_data_parallel(
                    planted, {"w": np.full((4, 4), 0.1, np.float32),
                              "z": np.zeros(4, np.float32)}, x, y,
                    optimizer=NamedOptimizer("sgd"),
                    loss=train.softmax_cross_entropy, batch_size=8,
                    epochs=4, device=device)
    finally:
        debug.disable_checks()
