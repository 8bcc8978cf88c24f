"""The wheel ships the PyTorch port (``sparkdl_tpu_torch``) whole.

The port reads files that are not Python at run time: the CUDA kernels'
sources (nvcc builds them at first use on the machine with the card,
``ops/build.py``), the native host-IO core's source (g++ builds it,
``native/__init__.py``), the zoo's Keras layer names
(``models/keras_import.py``) and the graphs TFInputGraph and the Keras
converter read (``graph/``).  ``tests/test_wheel.py`` proves the JAX
package's; these tests build the real wheel, check that it carries every
one of the port's, install it into a clean target and import the port
from there.
"""

import os
import subprocess
import sys
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sparkdl_tpu_torch")
KERNEL_SOURCES = ["common.cuh", "head_fanout.cu", "mbconv.cu", "sepconv.cu",
                  "sepconv_tiled.cu", "wgmma.cuh"]


@pytest.fixture(scope="module")
def wheel_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_wheel")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", REPO, "--no-deps",
         "--no-build-isolation", "-w", str(d)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    wheels = [f for f in os.listdir(d) if f.endswith(".whl")]
    assert len(wheels) == 1, wheels
    return str(d / wheels[0])


def _graph_data():
    """The port's graph data files in the checkout, as wheel paths."""
    root = os.path.join(PORT, "graph", "data")
    return sorted(
        os.path.relpath(os.path.join(d, f), REPO).replace(os.sep, "/")
        for d, _, files in os.walk(root) for f in files)


def test_wheel_ships_the_ports_data_and_sources(wheel_path):
    """The six kernel sources, the native core, the zoo's Keras layers,
    the 24 graph files (every one in the checkout), and ``torch`` as the
    port's optional extra."""
    z = zipfile.ZipFile(wheel_path)
    names = set(z.namelist())
    for f in KERNEL_SOURCES:
        assert f"sparkdl_tpu_torch/ops/csrc/{f}" in names, f
    assert sorted(os.listdir(os.path.join(PORT, "ops", "csrc"))) == \
        KERNEL_SOURCES
    assert "sparkdl_tpu_torch/native/sparkdl_native.cpp" in names
    assert "sparkdl_tpu_torch/models/data/keras_layers.json" in names
    graph = _graph_data()
    assert len(graph) == 24
    assert sorted(n for n in names
                  if n.startswith("sparkdl_tpu_torch/graph/data/")) == graph
    meta = next(n for n in names if n.endswith(".dist-info/METADATA"))
    lines = z.read(meta).decode().splitlines()
    assert "Provides-Extra: torch" in lines
    assert 'Requires-Dist: torch; extra == "torch"' in lines


def test_wheel_installs_and_imports_the_port(wheel_path, tmp_path):
    """Installed into a clean ``--target`` (the checkout not on the path),
    the port imports from there and finds its files where it reads
    them."""
    target = tmp_path / "site"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--target", str(target), wheel_path],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    smoke = r"""
import os, sys
import sparkdl_tpu_torch
root = os.path.dirname(os.path.abspath(sparkdl_tpu_torch.__file__))
assert root.startswith(sys.argv[1]), (root, sys.argv[1])
from sparkdl_tpu_torch.ops import build  # noqa: F401
for f in ("sepconv.cu", "sepconv_tiled.cu", "mbconv.cu", "head_fanout.cu"):
    assert os.path.isfile(os.path.join(root, "ops", "csrc", f)), f
assert os.path.isfile(os.path.join(root, "native", "sparkdl_native.cpp"))
assert os.path.isfile(os.path.join(root, "models", "data",
                                   "keras_layers.json"))
assert os.path.isfile(os.path.join(root, "graph", "data",
                                   "keras_inception_v3.json"))
from sparkdl_tpu_torch.parallel import distributed, mesh, train  # noqa
assert "jax" not in sys.modules and "sparkdl_tpu" not in sys.modules
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(target)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-c", smoke, str(target)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
