"""The port stands alone: no module of ``sparkdl_tpu_torch``, not
``chip_smoke.py`` and none of the port's tools imports JAX, flax, optax,
the JAX package or ``google`` (protobuf: the port reads TensorFlow's
messages with its own wire-format reader); no module of the package and not ``chip_smoke.py``
imports Keras or TensorFlow (the card has neither; the two tools that
write the committed Keras tables run Keras here, inside a function), and
h5py is imported only inside the file readers; and an entry point with no
CUDA device and no CPU asked for raises instead of carrying on quietly on
the CPU."""

import ast
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparkdl_tpu", "google")


def _port_files():
    files = sorted((ROOT / "sparkdl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "tests" / "test_torch_cuda.py")
    files.append(ROOT / "tests" / "_torch_dist_worker.py")
    files += [ROOT / "tools" / name for name in (
        "port_profile.py", "sepconv_compare.py", "mbconv_compare.py",
        "sepconv_tiled_compare.py", "gen_wgmma.py", "pipeline_probe.py",
        "gen_keras_layers.py", "gen_keras_configs.py",
        "graph_count_probe.py", "keras_stage_probe.py", "gen_tf_graphs.py",
        "tfgraph_fold_probe.py", "crc32c_timing.py",
        "obs_overhead_probe.py", "port_stream_journal.py",
        "train_pool_probe.py", "cv_probe.py")]
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _module_level_imports(path):
    """Imports that run when the module is imported (not inside a
    function or class body)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
        else:
            stack.extend(ast.iter_child_nodes(node))


# The engine's core (captured forward, pipelined runner, failure domain)
# and the modules it leans on, and the modules of configs 3 and 4 (the
# Keras converter, the tensor and image-file stages, the UDF registry,
# persistence): the walk below must reach each of them.
ENGINE_CORE = ("parallel/engine.py", "parallel/pipeline.py",
               "utils/metrics.py", "utils/retry.py", "faults/__init__.py",
               "faults/errors.py", "faults/sites.py", "faults/spec.py",
               "faults/plan.py")
KERAS_SLICE = ("graph/__init__.py", "graph/utils.py", "graph/function.py",
               "graph/keras_convert.py", "transformers/tensor.py",
               "transformers/image_file.py", "udf/__init__.py",
               "udf/registry.py", "persistence.py", "image/io.py",
               "models/keras_import.py")


# The modules of config 5 (fine-tuning and tuning) and the engine caches'
# bound.
TUNING_SLICE = ("utils/cache.py", "param/converters.py", "checkpoint.py",
                "parallel/train.py", "estimators/image_file_estimator.py",
                "estimators/tuning.py", "models/efficientnet.py",
                "estimators/__init__.py", "parallel/__init__.py",
                "utils/__init__.py", "ops/__init__.py", "image/__init__.py")


# The TensorFlow graph import (TFInputGraph) and the native decode core.
TF_SLICE = ("graph/proto.py", "graph/bundle.py", "graph/tf_import.py",
            "graph/input.py", "native/__init__.py")


# Online serving and what it leans on.
SERVING_SLICE = ("serving/__init__.py", "serving/errors.py",
                 "serving/batcher.py", "serving/cache.py",
                 "serving/server.py", "serving/adapters.py",
                 "utils/digest.py", "utils/health.py", "obs/__init__.py",
                 "obs/export.py")


# The head fan-out: kernel H1's wrapper and the fleet's swap report.
HEADFANOUT_SLICE = ("ops/head.py", "serving/fleet/__init__.py",
                    "serving/fleet/rollout.py")


# The fleet: admission, the registry, rollouts and the front door.
FLEET_SLICE = ("serving/fleet/admission.py", "serving/fleet/registry.py",
               "serving/fleet/fleet.py")


# Observability: spans, the flight recorder, exemplars, SLOs, the cost
# ledger, and the crash-safe JSONL and trace-aware logging they ride.
OBS_SLICE = ("obs/trace.py", "obs/flight.py", "obs/exemplar.py",
             "obs/slo.py", "obs/cost.py", "utils/jsonl.py",
             "utils/logging.py")


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 15 and all(f.exists() for f in files)
    assert (ROOT / "sparkdl_tpu_torch" / "native" / "sparkdl_native.cpp"
            ).exists()
    for rel in (ENGINE_CORE + KERAS_SLICE + TUNING_SLICE + TF_SLICE
                + SERVING_SLICE + HEADFANOUT_SLICE + FLEET_SLICE
                + OBS_SLICE):
        assert ROOT / "sparkdl_tpu_torch" / rel in files, rel
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f) if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_no_keras_and_h5py_only_in_readers():
    files = [f for f in _port_files() if f.parent.name != "tools"]
    assert ROOT / "chip_smoke.py" in files
    keras = [(str(f.relative_to(ROOT)), mod) for f in files
             for mod in _imports(f)
             if mod.split(".")[0] in ("keras", "tensorflow", "tf_keras")]
    assert keras == []
    eager_h5py = [str(f.relative_to(ROOT)) for f in files
                  if "h5py" in set(_module_level_imports(f))]
    assert eager_h5py == []
    readers = [str(f.relative_to(ROOT)) for f in files
               if "h5py" in set(_imports(f))]
    assert readers == ["sparkdl_tpu_torch/models/keras_import.py"]


def test_entry_point_without_cuda_raises(monkeypatch):
    import torch

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.image.schema import imageArrayToStruct, structsToArrow
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine
    from sparkdl_tpu_torch.transformers import named_image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sparkdl_tpu_torch.set_default_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparkdl_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(lambda m, x: m(x), torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(lambda m, x: m(x), torch.nn.Linear(2, 2),
                        device="cuda")
    # the user-facing stage: the engine is built for the first decoded
    # chunk, and that is where the device is resolved
    monkeypatch.setattr(named_image, "_MODEL_CACHE",
                        {("Xception", ""): torch.nn.Identity()})
    img = np.zeros((299, 299, 3), np.uint8)
    df = DataFrame(structsToArrow([imageArrayToStruct(img)]))
    stage = named_image.DeepImageFeaturizer(
        inputCol="image", outputCol="f", modelName="Xception", batchSize=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage.transform(df)
    # a TFTransformer over a TFInputGraph (a TF-written SavedModel)
    from sparkdl_tpu_torch import TFInputGraph
    from sparkdl_tpu_torch.transformers import TFTransformer

    sm = (ROOT / "sparkdl_tpu_torch" / "graph" / "data" / "tf_fixtures"
          / "mlp" / "saved_model")
    tig = TFInputGraph.fromSavedModelWithSignature(str(sm), "serve",
                                                   "serving_default")
    tft = TFTransformer(modelFunction=tig.model_function(),
                        inputMapping={"x": "features"},
                        outputMapping={"scores": "y"})
    rows = DataFrame({"x": [[1.0, 2.0, 3.0, 4.0]]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tft.transform(rows)
    with sparkdl_tpu_torch.default_device("cpu"):
        assert tft.transform(rows).column_to_numpy("y").shape == (1, 3)
    # asking for the CPU is what lets it run there
    assert sparkdl_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with sparkdl_tpu_torch.default_device("cpu"):
        assert sparkdl_tpu_torch.resolve_device() == torch.device("cpu")


def test_tensor_stages_and_udf_without_cuda_raise(monkeypatch):
    """The stages and the UDF of configs 3 and 4 build their engine at the
    first batch, and a ModelFunction called directly resolves its device
    at the call: on the card unless the CPU was asked for."""
    import torch

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.schema import imageArrayToStruct, structsToArrow
    from sparkdl_tpu_torch.transformers import (ImageFileTransformer,
                                                ModelTransformer)
    from sparkdl_tpu_torch.udf import UDFRegistry, register_image_udf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sparkdl_tpu_torch.set_default_device(None)
    mf = ModelFunction.from_module(torch.nn.Flatten())
    rows = DataFrame({"x": [[1.0, 2.0]]})
    stage = ModelTransformer(inputCol="x", outputCol="y", modelFunction=mf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage.transform(rows)
    files = ImageFileTransformer(
        inputCol="x", outputCol="y", modelFunction=mf,
        imageLoader=lambda uri: np.zeros((2, 2, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        files.transform(rows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf(np.ones((1, 2), np.float32))
    udf = register_image_udf("flat", mf, registry=UDFRegistry())
    col = structsToArrow([imageArrayToStruct(
        np.zeros((4, 4, 3), np.uint8))]).column("image")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        udf(col)
    with sparkdl_tpu_torch.default_device("cpu"):
        assert stage.transform(rows).column_to_numpy("y").shape == (1, 2)
        assert len(udf(col)[0]) == 48
        assert mf(np.ones((1, 2), np.float32)).device == torch.device("cpu")


def test_server_without_cuda_raises(monkeypatch):
    """``Server`` resolves its device at construction: without a card it
    raises unless the CPU was asked for, and never serves from the CPU
    quietly; the device it resolved is the one its engines run on."""
    import torch

    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.serving import Server, from_transformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.transformers import ModelTransformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sparkdl_tpu_torch.set_default_device(None)

    def fn(m, x):
        return x * 2

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(fn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(fn, device="cuda")
    stage = ModelTransformer(inputCol="x", outputCol="y",
                             modelFunction=ModelFunction.from_callable(
                                 lambda x: x * 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_transformer(stage)
    with Server(fn, device="cpu", cache=False) as srv:
        assert srv.device == torch.device("cpu")
        np.testing.assert_array_equal(srv.predict(np.ones(2, np.float32)),
                                      [2.0, 2.0])
    with sparkdl_tpu_torch.default_device("cpu"):
        srv = Server(fn, cache=False)
    # the device is the one resolved at construction, whatever the
    # thread-local default of a later caller or of the dispatch threads
    with srv:
        assert srv.device == torch.device("cpu")
        assert srv.predict(np.ones(2, np.float32)).tolist() == [2.0, 2.0]
        assert srv._engines[srv.bucket_sizes[0]].device.type == "cpu"


# Names a subpackage of the JAX package exports that the port's does not,
# each with the reason: modules not ported yet (ROADMAP.md queue A), and
# the TPU layout helpers of the Pallas kernels.
NOT_EXPORTED = {
    "parallel": {},
    "utils": {},
    "obs": {},
    "ops": {"fused_sepconv_flat": "the TPU's padded-flat row layout",
            "pad_to_flat": "the TPU's padded-flat row layout",
            "unflatten": "the TPU's padded-flat row layout"},
    "image": {},
    "estimators": {},
    "graph": {},
    "serving": {},
    "serving.fleet": {},
    "udf": {},
}


@pytest.mark.parametrize("sub", sorted(NOT_EXPORTED))
def test_subpackage_exports_match_jax(sub):
    """Each subpackage exports what the JAX package's exports, less the
    names listed above; every exported name resolves."""
    import importlib

    jax_mod = importlib.import_module(f"sparkdl_tpu.{sub}")
    port_mod = importlib.import_module(f"sparkdl_tpu_torch.{sub}")
    missing = set(jax_mod.__all__) - set(port_mod.__all__)
    assert missing == set(NOT_EXPORTED[sub])
    assert all(hasattr(port_mod, n) for n in port_mod.__all__)


def test_top_level_exports_tfinputgraph():
    """The top-level lazy map exports ``TFInputGraph`` and ``ModelInput``
    as the JAX package's does."""
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.graph.input import TFInputGraph

    for name in ("TFInputGraph", "ModelInput"):
        assert name in sparkdl_tpu.__all__ and name in sparkdl_tpu_torch.__all__
        assert getattr(sparkdl_tpu_torch, name) is TFInputGraph
