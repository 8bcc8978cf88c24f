"""The port's graftlint (``sparkdl_tpu_torch.analysis``) held against the
JAX package's on the CPU.

Every lint fixture of the JAX package's own tests (the Python snippets in
``tests/test_analysis.py`` and ``tests/test_flight.py``'s SDL008 cases) goes
through both packages' ``lint_source`` with the same fault-site and
flight-event registries: the ``(code, line)`` lists must be equal for every
rule but SDL007, which the port retargets from ``jax.jit`` donation to
CUDA-graph memory pools (its own cases below).  Then the port's registries
are its own files, the port's tree lints clean, and the CLI keeps JAX's
exit codes and JSON.  Stdlib-fast: no model, no torch work.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from sparkdl_tpu.analysis import lint_source as jax_lint_source
from sparkdl_tpu_torch.analysis import (RULE_HELP, lint_paths, lint_source,
                                        load_event_registry,
                                        load_site_registry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITES = {"engine.dispatch", "io.decode"}
EVENTS = {"breaker.open", "serving.shed"}


def _jax_fixtures():
    """Every string literal of the JAX lint tests that parses as a module
    of more than one line, and the SDL008 one-liners, deduplicated in
    file order."""
    out = []
    for name in ("test_analysis.py", "test_flight.py"):
        with open(os.path.join(REPO, "tests", name), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value.endswith("\n")):
                continue
            if "\n" not in node.value.rstrip("\n") and \
                    "emit" not in node.value:
                continue
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            if node.value not in out:
                out.append(node.value)
    return out


FIXTURES = _jax_fixtures()


def _pairs(findings, skip=("SDL007",)):
    return [(f.code, f.line) for f in findings if f.code not in skip]


def test_fixture_harvest_covers_every_shared_rule():
    assert len(FIXTURES) > 40
    fired = {f.code for src in FIXTURES
             for f in jax_lint_source(src, sites=SITES, events=EVENTS)}
    assert {"SDL000", "SDL001", "SDL002", "SDL003", "SDL004", "SDL005",
            "SDL006", "SDL007", "SDL008"} <= fired


@pytest.mark.parametrize("idx", range(len(FIXTURES)))
def test_jax_fixture_same_findings(idx):
    src = FIXTURES[idx]
    for sites, events in ((SITES, EVENTS), (None, None)):
        want = _pairs(jax_lint_source(src, sites=sites, events=events))
        got = _pairs(lint_source(src, sites=sites, events=events))
        assert got == want, src


# -- SDL007, retargeted: every capture site decides its memory pool ---------

@pytest.mark.parametrize("src,want", [
    ("import torch\n"
     "def f(g):\n"
     "    with torch.cuda.graph(g):\n"
     "        pass\n", ["SDL007"]),
    ("import torch as t\n"
     "def f(g, s):\n"
     "    with t.cuda.graph(g, stream=s):\n"
     "        pass\n", ["SDL007"]),
    ("from torch import cuda\n"
     "def f(g):\n"
     "    with cuda.graph(g):\n"
     "        pass\n", ["SDL007"]),
    ("from torch.cuda import graph as capture\n"
     "def f(g):\n"
     "    with capture(g):\n"
     "        pass\n", ["SDL007"]),
    ("import torch\n"
     "def f(g):\n"
     "    g.capture_begin()\n", ["SDL007"]),
    ("import torch\n"
     "def f(g, pool):\n"
     "    with torch.cuda.graph(g, pool=pool):\n"
     "        pass\n", []),
    ("import torch\n"
     "def f(g):\n"
     "    with torch.cuda.graph(g, pool=None):\n"
     "        pass\n", []),
    ("import torch\n"
     "def f(g, h):\n"
     "    g.capture_begin(pool=h)\n", []),
    ("import jax\n"
     "def f(fn):\n"
     "    return jax.jit(fn)\n", []),
    ("import numpy\n"
     "def f(g):\n"
     "    numpy.cuda.graph(g)\n", []),
])
def test_sdl007_capture_sites(src, want):
    assert [f.code for f in lint_source(src, sites=SITES,
                                        events=EVENTS)] == want


def test_sdl007_pragma_needs_reason():
    base = ("import torch\n"
            "def f(g):\n"
            "    # graftlint: allow=SDL007{}\n"
            "    with torch.cuda.graph(g):\n"
            "        pass\n")
    assert lint_source(base.format(" reason=a timing graph, freed at once"),
                       sites=SITES) == []
    # a reason-less pragma is itself a finding AND suppresses nothing
    assert [f.code for f in lint_source(base.format(""), sites=SITES)] == [
        "SDL000", "SDL007"]


def test_rule_table_is_jax_but_sdl007():
    from sparkdl_tpu.analysis import RULE_HELP as JAX_HELP

    assert set(RULE_HELP) == set(JAX_HELP)
    for code in RULE_HELP:
        assert (RULE_HELP[code] == JAX_HELP[code]) == (code != "SDL007")
    assert "pool" in RULE_HELP["SDL007"]


# -- the port's registries and tree -----------------------------------------

def test_registries_are_the_ports_own():
    from sparkdl_tpu_torch.faults import SITE_HELP
    from sparkdl_tpu_torch.obs.flight import EVENT_HELP

    port = [os.path.join(REPO, "sparkdl_tpu_torch")]
    assert load_site_registry(port) == set(SITE_HELP)
    assert load_event_registry(port) == set(EVENT_HELP)


def test_port_tree_lints_clean():
    targets = [os.path.join(REPO, t) for t in (
        "sparkdl_tpu_torch", "chip_smoke.py", "tools/port_graftlint.py",
        "tools/port_graftcheck.py")]
    findings = lint_paths(targets)
    assert findings == [], "\n".join(f.render() for f in findings)


CLI = os.path.join(REPO, "tools", "port_graftlint.py")


def _cli(*args):
    return subprocess.run([sys.executable, CLI, *args], capture_output=True,
                          text=True, timeout=120)


def test_cli_exit_codes_and_json(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n"
                   "def f(g):\n"
                   "    with torch.cuda.graph(g):\n"
                   "        pass\n")
    r = _cli("--json", str(bad))
    assert r.returncode == 1, r.stderr
    doc = json.loads(r.stdout)
    assert doc["files"] == 1 and doc["rules"] == len(RULE_HELP)
    [finding] = doc["findings"]
    assert (finding["rule"], finding["path"], finding["line"]) == (
        "SDL007", str(bad), 3)
    r = _cli(str(bad))
    assert r.returncode == 1 and "SDL007" in r.stdout
    bad.write_text("X = 1\n")
    r = _cli(str(bad))
    assert r.returncode == 0 and "clean" in r.stdout
    assert json.loads(_cli("--json", str(bad)).stdout)["findings"] == []
    r = _cli("--list-rules")
    assert r.returncode == 0
    assert all(code in r.stdout for code in RULE_HELP)
    assert _cli(str(tmp_path / "missing.py")).returncode == 2
    empty = tmp_path / "empty_registry.py"
    empty.write_text("X = 1\n")
    assert _cli("--sites-file", str(empty), str(bad)).returncode == 2
    events = os.path.join(REPO, "sparkdl_tpu_torch", "obs", "flight.py")
    bad.write_text('flight_emit("breaker.opne")\n')
    r = _cli(str(bad), "--events-file", events)
    assert r.returncode == 1 and "SDL008" in r.stdout
