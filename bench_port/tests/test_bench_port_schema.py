"""BENCHMARK.json against the benchmark's contract, and every piece a cell
names found by name under bench_port/."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "bench_port/run.py"]
    assert len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert c["file"].startswith("bench_port/")
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len({w["name"] for w in bench["workloads"]}) == len(
        bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(bench["workloads"])


def test_every_cell_reports_what_the_contract_asks(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for cell in cells:
        own = [m for m in bench["end_to_end"] if reports(m, cell)]
        assert any(m["name"] == "setup_s" for m in own)
        assert any(m["name"] != "setup_s" for m in own)
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_every_piece_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "traffic" / f"{mix['driver']}.py").is_file()
        assert cell["output"] in ("features", "probabilities")
        assert cell["limits"]["worst_rel_gap"] > 0
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "reference" / f"{cfg['arch']}.py").is_file()
        assert cfg["reduced"] == c["reduced"]
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in bench["per_layer"]:
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
