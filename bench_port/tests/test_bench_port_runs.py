"""Whole runs on the CPU at a test's size: the harness's look for a card
skipped, everything else as on the card.  A sound run is correct; the
same run with the timed path broken underneath is not, for each fault a
scoring cell can have, and nor is the control put in the program's
place.  A cell added as new files and entries only is
found by name and runs."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bench_port.lib import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 99
SMALL = {
    "inceptionv3-featurize-b64": {"rows": 6, "nulls": 1, "batch_size": 4,
                                  "warmup_calls": 1, "trace_seconds": 0.5},
    "xception-predict-b64": {"rows": 6, "nulls": 1, "batch_size": 4,
                             "warmup_calls": 1, "trace_seconds": 0.5},
}


@pytest.fixture(autouse=True)
def own_environment():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def cpu_run(cell, trace=False):
    line, err = harness.execute(ROOT, cell, SEED, 0.8, trace,
                                time.monotonic(), device="cpu",
                                overrides=dict(SMALL[cell]))
    return line, err


def alter_one_answer(rows):
    rows[0] = rows[0] * 1.1
    return rows


def leave_half_out(rows):
    rows[len(rows) // 2:] = 0
    return rows


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    line, err = cpu_run(cell)
    assert line["correct"] is True
    assert list(line)[-1] == "check"
    assert err[-len(line["check"]):] == [
        f"check {k}: {c['value']} limit {c['limit']}"
        for k, c in line["check"].items()]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", [alter_one_answer, leave_half_out])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    trim = InferenceEngine._trim

    def broken(self, out, n):
        host = trim(self, out, n)
        return fault(np.array(host))

    monkeypatch.setattr(InferenceEngine, "_trim", broken)
    line, _ = cpu_run(cell)
    assert line["correct"] is False
    assert line["check"]["worst_rel_gap"]["value"] > \
        line["check"]["worst_rel_gap"]["limit"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_runs_report_the_cells_metrics(cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    def listed(metrics, source):
        return {m["name"] for m in metrics if m["source"] == source
                and cell in m.get("workloads", [cell])}

    line, err = cpu_run(cell)
    # off the card a metric taken from the device's trace has no device
    # to read; the run still profiles its window for it
    assert set(line["metrics"]) == listed(bench["end_to_end"], "host_clock")
    device_timed = bool(listed(bench["end_to_end"], "device_trace"))
    assert any(e.startswith("card busy") for e in err) == device_timed
    line, _ = cpu_run(cell, trace=True)
    assert line["correct"] is True
    assert set(line["metrics"]) >= listed(bench["per_layer"], "host_clock")
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """The reference in float8, answering every input of the frame, is
    judged by the run's own check and comes out not correct."""
    from bench_port.tools.control import control_verdict

    run = harness.prepare(ROOT, cell, SEED, 0.0, False, time.monotonic(),
                          device="cpu", overrides=dict(SMALL[cell]))
    checks, compared, correct = control_verdict(run)
    assert compared == SMALL[cell]["rows"]
    assert correct is False
    gap = checks["worst_rel_gap"]
    assert gap["value"] > gap["limit"]


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    new file and a new entry, run through an unchanged harness."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tmp_path / "sparkdl_tpu_torch").symlink_to(ROOT / "sparkdl_tpu_torch")
    b = tmp_path / "bench_port"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((b / "configs/xception-bf16.json").read_text())
    cfg["env"] = {}  # the dummy states float32 compute
    (b / "configs/dummy-xception-f32.json").write_text(json.dumps(cfg))
    (b / "traffic/dataframe-6-b4.json").write_text(json.dumps(
        {"driver": "dataframe_transform", "rows": 6, "nulls": 2,
         "batch_size": 4, "warmup_calls": 1, "trace_seconds": 0.5}))
    (b / "workloads/dummy-predict-b4.json").write_text(json.dumps(
        {"transformer": "DeepImagePredictor", "output": "probabilities",
         "limits": {"worst_rel_gap": 1e-4}}))
    (b / "metrics/dummy_rows.batch.py").write_text(
        "def read(w):\n    return float(w.images)\n")
    bench["configs"].append(
        {"name": "dummy-xception-f32", "source": "https://example.org",
         "file": "bench_port/configs/dummy-xception-f32.json",
         "reduced": [], "why": "a test's cell"})
    bench["workloads"].append(
        {"name": "dummy-predict-b4", "config": "dummy-xception-f32",
         "traffic": "dataframe-6-b4", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("dummy-predict-b4")
    bench["per_layer"].append(
        {"name": "dummy_rows.batch", "unit": "images", "better": "higher",
         "source": "host_clock", "layer": "stage", "moves": "images_per_s",
         "workloads": ["dummy-predict-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from pathlib import Path\n"
        "from bench_port.lib import harness\n"
        "assert harness.BENCH_DIR == Path(sys.path[0]) / 'bench_port'\n"
        "for trace in (False, True):\n"
        f"    line, _ = harness.execute(Path({str(tmp_path)!r}), "
        "'dummy-predict-b4', 5, 0.5, trace, time.monotonic(), "
        "device='cpu')\n"
        "    print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(x) for x in out.stdout.strip().splitlines()
                     [-2:]]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}
    assert traced["metrics"]["dummy_rows.batch"]["value"] > 0
    # f32 compute: the program's plain route agrees to rounding
    assert plain["check"]["worst_rel_gap"]["value"] < 1e-4


def test_without_the_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "xception-predict-b64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("name", ["jax", "flax", "sparkdl_tpu"])
def test_a_run_that_loaded_jax_gives_no_result(name, monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(RuntimeError, match=name):
        cpu_run("xception-predict-b64")
