"""The port stands alone: no module of ``sparkdl_tpu_torch``, not
``chip_smoke.py`` and none of the port's tools imports JAX, flax, optax or
the JAX package, and an entry point with no CUDA device and no CPU asked
for raises instead of carrying on quietly on the CPU."""

import ast
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparkdl_tpu")


def _port_files():
    files = sorted((ROOT / "sparkdl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "tests" / "test_torch_cuda.py")
    files += [ROOT / "tools" / name for name in (
        "port_profile.py", "sepconv_compare.py", "mbconv_compare.py",
        "sepconv_tiled_compare.py", "gen_wgmma.py", "pipeline_probe.py",
        "gen_keras_layers.py")]
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


# The engine's core (captured forward, pipelined runner, failure domain)
# and the modules it leans on: the walk below must reach each of them.
ENGINE_CORE = ("parallel/engine.py", "parallel/pipeline.py",
               "utils/metrics.py", "utils/retry.py", "faults/__init__.py",
               "faults/errors.py", "faults/sites.py", "faults/spec.py",
               "faults/plan.py")


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 15 and all(f.exists() for f in files)
    for rel in ENGINE_CORE:
        assert ROOT / "sparkdl_tpu_torch" / rel in files, rel
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f) if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


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
    # asking for the CPU is what lets it run there
    assert sparkdl_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with sparkdl_tpu_torch.default_device("cpu"):
        assert sparkdl_tpu_torch.resolve_device() == torch.device("cpu")
