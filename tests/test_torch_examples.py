"""The port's examples (``examples/port_*.py``) as executable documents,
on the CPU.

Each example runs in a subprocess with ``--device cpu`` from a scratch
working directory and prints its JAX twin's marker line.  The
distributed fit's ``w`` (two ranks over gloo) is held to the JAX
package's ``fit_data_parallel`` on one device, in this process, at the
JAX example's tolerance (``rtol=5e-3, atol=1e-3``: the same schedule, a
different reduction order).  The flowers recipe on a synthetic
``<root>/<class>/*.jpg`` tree (MobileNetV2 at 224x224, four JPEGs a
class) gives the JAX example's split, classes and counts; the ``slow``
case also runs JAX's ``flowers_top1.main`` on the same tree and the same
weights (JAX's init, converted for the port) and holds the two top-1s
within one test image: the features differ at bf16 rounding, which can
move a decision near a class boundary.  Neither package's ``load_model``
is reached there (both are given the weights), so nothing downloads.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (the conftest keeps it on the CPU)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
BASES = [(220, 40, 40), (40, 200, 40), (40, 40, 220), (220, 220, 40),
         (200, 40, 200)]
PER_CLASS = 4


def _run(script, cwd, *args):
    """The example in a subprocess with ``--device cpu``, on two CPU
    threads (the suite's other workers share the machine); returns its
    stdout (it must exit 0)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("SPARKDL_WEIGHTS_DIR", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), *args,
         "--device", "cpu"], env=env, cwd=str(cwd), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("script,marker", [
    ("port_migrate_from_sparkdl.py", '{"migration_smoke": "ok"}'),
    ("port_serving_quickstart.py", '"serving_quickstart": "ok"')])
def test_example_runs_and_prints_its_marker(script, marker, tmp_path):
    out = _run(script, tmp_path)
    assert marker in out.strip().splitlines()[-1]


def test_distributed_fit_matches_the_jax_oracle(tmp_path):
    """Two ranks over gloo, 16 rows each: the example's own checks pass
    (its marker), and its ``w`` is JAX's one-device fit of the 32 rows."""
    import optax

    from sparkdl_tpu.parallel import get_mesh
    from sparkdl_tpu.parallel.train import fit_data_parallel

    line = json.loads(_run("port_distributed_fit.py",
                           tmp_path).strip().splitlines()[-1])
    assert line["distributed_fit"] == "ok"
    assert line["processes"] == line["world_size"] == 2
    assert line["backend"] == "gloo" and line["device"] == "cpu"
    assert line["final_loss"] < 1e-3

    sys.path.insert(0, EXAMPLES)
    try:
        from port_distributed_fit import data
    finally:
        sys.path.remove(EXAMPLES)
    x, y = data()

    def predict(p, xb):
        import jax.numpy as jnp

        return jnp.asarray(xb) @ p["w"]

    fitted, _ = fit_data_parallel(
        predict, {"w": np.zeros((4, 1), np.float32)}, x, y,
        optimizer=optax.sgd(0.05), loss="mse", batch_size=8, epochs=10,
        seed=3, shuffle=False, mesh=get_mesh(num_devices=1))
    np.testing.assert_allclose(np.ravel(line["w"]),
                               np.ravel(np.asarray(fitted["w"])),
                               rtol=5e-3, atol=1e-3)


@pytest.fixture
def tree(tmp_path):
    """Five tinted classes of PER_CLASS JPEGs (sides 60-90)."""
    from PIL import Image

    rng = np.random.default_rng(5)
    root = tmp_path / "tree"
    for k, base in enumerate(BASES):
        cdir = root / f"class_{k}"
        cdir.mkdir(parents=True)
        for i in range(PER_CLASS):
            h, w = (int(v) for v in rng.integers(60, 90, 2))
            img = np.clip(np.asarray(base, np.float32)
                          + rng.normal(0, 50, (h, w, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                cdir / f"img_{i}.jpg", quality=90)
    return str(root)


def _split(root, ratio=0.8):
    """The JAX example's classes and train / test counts of ``root``."""
    sys.path.insert(0, EXAMPLES)
    try:
        from flowers_top1 import gather_files
    finally:
        sys.path.remove(EXAMPLES)
    files, _, classes = gather_files(root, None)
    cut = int(len(files) * ratio)
    return classes, cut, len(files) - cut


def test_flowers_top1_runs_with_the_jax_split(tree, tmp_path):
    """The recipe end to end on the CPU: the JAX example's classes, split
    and counts, a top-1 in [0, 1], the engine's dispatches at batch 8."""
    res = json.loads(_run("port_flowers_top1.py", tmp_path, tree,
                          "--model", "MobileNetV2", "--batch-size", "8",
                          "--seed", "3").strip().splitlines()[-1])
    classes, n_train, n_test = _split(tree)
    assert res["classes"] == len(classes) == len(BASES)
    assert (res["n_train"], res["n_test"]) == (n_train, n_test)
    assert res["model"] == "MobileNetV2" and res["device"] == "cpu"
    assert 0.0 <= res["top1"] <= 1.0
    assert res["dispatches"] == -(-len(BASES) * PER_CLASS // 8)
    assert res["graph_captures"] == 0
    assert res["weights_source"].startswith("seeded init")


@pytest.mark.slow
def test_flowers_top1_matches_jax_main(tree, monkeypatch, capsys):
    """JAX's ``flowers_top1.main`` and the port's on the same tree, seed
    and weights (JAX's MobileNetV2 init; the port's the same tensors):
    the same classes, split and counts, top-1 within one test image.  The
    JAX side (its init and its CPU compile, ~20 s) is why this case is
    ``slow``; the case above runs the port's recipe in tier 1."""
    import sparkdl_tpu.models as jmodels
    import sparkdl_tpu_torch
    import sparkdl_tpu_torch.models as pmodels
    from sparkdl_tpu_torch.models.convert import state_dict_from_jax

    spec = jmodels.get_model_spec("MobileNetV2")
    variables = spec.init_variables()

    def jax_load(name, *a, **k):
        assert name == "MobileNetV2"
        return spec.build(), variables

    def port_load(name, *a, **k):
        module = pmodels.get_model_spec(name).build()
        module.load_state_dict(state_dict_from_jax(name, variables))
        return module.eval()

    monkeypatch.setattr(jmodels, "load_model", jax_load)
    monkeypatch.setattr(pmodels, "load_model", port_load)
    monkeypatch.delenv("SPARKDL_WEIGHTS_DIR", raising=False)
    monkeypatch.syspath_prepend(EXAMPLES)
    import flowers_top1
    import port_flowers_top1

    argv = [tree, "--model", "MobileNetV2", "--batch-size", "8", "--seed",
            "3"]
    flowers_top1.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with sparkdl_tpu_torch.default_device("cpu"):
        got = port_flowers_top1.main(argv + ["--device", "cpu"])
    for key in ("n_train", "n_test", "classes", "model"):
        assert got[key] == want[key], key
    assert abs(got["top1"] - want["top1"]) * got["n_test"] <= 1 + 1e-9
