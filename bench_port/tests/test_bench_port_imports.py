"""No module of the benchmark brings in JAX or the JAX package, and the
plain references bring in nothing of the program.  Each check runs in a
fresh interpreter and compares whole top-level module names
(``sparkdl_tpu_torch`` begins with ``sparkdl_tpu``)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "sparkdl_tpu"]


def modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def bench_modules():
    mods = []
    for p in sorted((ROOT / "bench_port").rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if ("tests" in rel.parts or "." in rel.name
                or any(part.startswith(".") for part in rel.parts)):
            continue  # tests, metric files, and unpacked trees or caches
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_every_benchmark_module_imports_without_jax():
    mods = bench_modules()
    assert "bench_port.lib.harness" in mods and "bench_port.run" in mods
    metric_files = sorted((ROOT / "bench_port/metrics").glob("*.py"))
    code = "\n".join(f"import {m}" for m in mods) + (
        "\nfrom bench_port.lib.harness import load_module\n" + "\n".join(
            f"load_module({str(p)!r}, 'm{i}')"
            for i, p in enumerate(metric_files)))
    loaded = modules_after(code)
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_references_import_nothing_of_the_program():
    loaded = modules_after("import bench_port.reference.xception\n"
                           "import bench_port.reference.inceptionv3\n"
                           "import bench_port.lib.weights")
    assert "sparkdl_tpu_torch" not in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_programs_entry_points_import_without_jax():
    loaded = modules_after(
        "import sparkdl_tpu_torch.transformers.named_image\n"
        "import sparkdl_tpu_torch.serving\n"
        "import sparkdl_tpu_torch.frame")
    assert "sparkdl_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)
