"""The port's persistent compile cache (``sparkdl_tpu_torch/parallel/
compile_cache.py``) on the CPU, with no nvcc and no card.

Held to the JAX package's ``parallel/compile_cache.py`` where the two are
comparable: ``dir_from_env`` answers every string of the
``SPARKDL_COMPILE_CACHE`` grammar alike (each package with its own default
directory), the engine's ``compile_policy()`` string equals the JAX
engine's for the same mesh and rules, and ``state()`` carries JAX's keys
(the toolchain fields in place of ``jax_version`` and ``backend``).

Then the restart proof over the kernel libraries ``ops/build.py`` makes:
a fake ``nvcc`` first on the children's ``PATH`` (carrying its release
string, which the cache reads without running it, as in the real nvcc
binary) writes its ``-o`` target and logs every run.  Child A builds the four libraries
through ``ops/build.build`` (misses 4), child B (the restart) runs no nvcc
(misses 0, hits 4, ``reused``), a tampered ``kernels`` record purges and
is classified ``kernel:<name>``.  Further: a corrupt or foreign manifest
gives ``manifest``, another toolchain ``toolchain``, a new policy
``GC005``, ``note_policy`` widens the stored set without a purge, the gate
is off by default (no directory made, builds in ``build/``), an injected
``compile.cache`` fault disables the cache with a warning, and
``compile.persist`` / ``compile.invalidate`` reach the flight recorder.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.parallel import compile_cache as jcc
from sparkdl_tpu_torch import faults as pfaults
from sparkdl_tpu_torch.obs import flight as pflight
from sparkdl_tpu_torch.obs.flight import FlightRecorder
from sparkdl_tpu_torch.ops import build
from sparkdl_tpu_torch.ops.sepconv import KERNELS
from sparkdl_tpu_torch.parallel import compile_cache as pcc

REPO = Path(__file__).resolve().parents[1]
NVCC_VERSION = "12.8.93"
TOOLCHAIN_KEYS = ("torch_version", "cuda_version", "nvcc", "capability")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Each test resolves the cache anew; no fault plan or recorder leaks
    out of it."""
    monkeypatch.delenv("SPARKDL_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(pflight, "_recorder", pflight._recorder)
    pcc._reset_for_tests()
    pfaults.clear()
    yield
    pfaults.clear()
    pcc._reset_for_tests()


# -- the grammar and the policy string against JAX ----------------------------

GRAMMAR = ["", "0", "false", "off", "no", "OFF", " No ", "1", "true", "on",
           "yes", "TRUE", " yes ", "/somewhere/else", "~/cc", "relative/dir"]


@pytest.mark.parametrize("raw", GRAMMAR)
def test_dir_from_env_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", raw)
    want = jcc.dir_from_env()
    got = pcc.dir_from_env()
    if want == jcc.DEFAULT_DIR:
        assert got == pcc.DEFAULT_DIR
    else:
        assert got == want


def test_default_dir_is_the_ports_own():
    assert pcc.DEFAULT_DIR != jcc.DEFAULT_DIR
    assert pcc.DEFAULT_DIR.endswith(
        os.path.join(".cache", "sparkdl_tpu_torch", "compile"))
    assert pcc.MANIFEST_NAME == jcc.MANIFEST_NAME
    assert pcc.MANIFEST_SCHEMA == jcc.MANIFEST_SCHEMA


class _Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(w))


def _jfn(v, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ v["w"])


@pytest.mark.parametrize("policy", ["none", "default_rules", "named_axis"])
def test_compile_policy_equals_jax(policy):
    """For one mesh (1, 1) and the same rules or shardings, the engine's
    policy string is the JAX engine's."""
    from jax.sharding import PartitionSpec

    from sparkdl_tpu.parallel import engine as jengine
    from sparkdl_tpu.parallel import mesh as jmesh
    from sparkdl_tpu_torch.parallel import mesh as pmesh
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    w = np.random.default_rng(3).normal(size=(8, 8)).astype(np.float32)
    jkw, pkw = {}, {}
    if policy == "default_rules":
        jkw["partition_rules"] = jmesh.default_partition_rules
        pkw["partition_rules"] = pmesh.default_partition_rules
    elif policy == "named_axis":
        jkw["param_shardings"] = {"w": PartitionSpec(None, jmesh.MODEL_AXIS)}
        pkw["param_shardings"] = {"w": pmesh.P(None, pmesh.MODEL_AXIS)}
    jeng = jengine.InferenceEngine(_jfn, {"w": w}, device_batch_size=8,
                                   mesh=jmesh.get_mesh(num_devices=1), **jkw)
    with sparkdl_tpu_torch.default_device("cpu"):
        peng = InferenceEngine(lambda m, x: torch.tanh(x @ m.w), _Dense(w),
                               device_batch_size=8, **pkw)
    assert peng.compile_policy() == jeng.compile_policy()
    if policy == "named_axis":
        assert "params=replicated" not in peng.compile_policy()


def test_state_carries_jax_keys(tmp_path):
    """``state()`` holds every key of JAX's but ``jax_version`` and
    ``backend``, whose place the toolchain fields take; given one program
    lockfile, both manifests record its programs and their count alike
    (the port's default is its own ``PROGRAMS_TORCH.lock.json``)."""
    from sparkdl_tpu_torch.analysis.program.lockfile import (
        DEFAULT_LOCKFILE, read_lockfile)

    lock = str(tmp_path / "lock.json")
    Path(lock).write_text(Path(DEFAULT_LOCKFILE).read_text())
    try:
        jst = jcc.configure(str(tmp_path / "jax"), lockfile_path=lock)
    finally:
        jcc._reset_for_tests()
    pst = pcc.configure(str(tmp_path / "port"), lockfile_path=lock)
    assert set(jst) - {"jax_version", "backend"} <= set(pst)
    assert set(TOOLCHAIN_KEYS) <= set(pst)
    assert pst["kernels"] == pcc.kernel_hashes()
    assert set(pst["kernels"]) == set(KERNELS)
    programs = read_lockfile(lock)["programs"]
    assert pst["lockfile_programs"] == jst["lockfile_programs"] \
        == len(programs) > 0
    json.dumps(pst)
    doc = json.loads((tmp_path / "port" / pcc.MANIFEST_NAME).read_text())
    jdoc = json.loads((tmp_path / "jax" / jcc.MANIFEST_NAME).read_text())
    assert doc["programs"] == jdoc["programs"] == programs
    assert doc["kernels"] == pst["kernels"]
    assert doc["schema_version"] == pcc.MANIFEST_SCHEMA
    pcc._reset_for_tests()
    assert pcc.configure(str(tmp_path / "port2"))["lockfile_programs"] == \
        len(read_lockfile(DEFAULT_LOCKFILE)["programs"])


@pytest.mark.parametrize("field,code", [
    ("fingerprint", "GC000"), ("flops", "GC004"), ("dtype_counts", "GC002"),
    ("kernels", "GC002"), ("in_avals", "GC003")])
def test_program_drift_purges_with_jax_gc_code(tmp_path, field, code):
    """A lockfile whose record moved between the populating process and
    the restart purges the cache, classified by the GC rule whose field
    moved, as JAX's cache classifies the same two lockfiles (a field JAX's
    records lack, ``kernels``, only the port's)."""
    from sparkdl_tpu_torch.analysis.program.lockfile import DEFAULT_LOCKFILE

    doc = json.loads(Path(DEFAULT_LOCKFILE).read_text())
    name = "zoo/Xception/featurize/bfloat16/b8"
    lock = tmp_path / "lock.json"
    lock.write_text(json.dumps(doc))
    moved = json.loads(json.dumps(doc))
    rec = moved["programs"][name]
    rec[field] = {"fingerprint": "0" * 64, "flops": rec["flops"] * 2,
                  "dtype_counts": {"conv_f32": 1},
                  "kernels": dict(rec["kernels"], B1=0),
                  "in_avals": dict(rec["in_avals"], key="x")}[field]
    got = {}
    for pkg, tag in ((pcc, "port"), (jcc, "jax")):
        if pkg is jcc and field == "kernels":
            continue
        cache = str(tmp_path / tag)
        try:
            pkg.configure(cache, lockfile_path=str(lock))
            Path(cache, "entry.bin").write_bytes(b"x")
            pkg._reset_for_tests()
            lock2 = tmp_path / f"moved_{tag}.json"
            lock2.write_text(json.dumps(moved))
            st = pkg.configure(cache, lockfile_path=str(lock2))
        finally:
            pkg._reset_for_tests()
        assert st["invalidated"] is True and st["purged_entries"] >= 1
        got[tag] = st["drift_rules"]
    assert got["port"] == [code]
    if "jax" in got:
        assert got["jax"] == got["port"]


def test_kernel_hashes_are_the_library_names():
    """A manifest record is the hash ``ops/build.py`` names the library
    by (sources, headers, flags), computed without nvcc."""
    hashes = pcc.kernel_hashes()
    for kernel, (name, sources, _, _) in KERNELS.items():
        path = build.library_path(name, sources)
        assert path.name == f"lib{name}_{hashes[kernel]}.so"


# -- the restart proof through ops/build.build --------------------------------

_FAKE_NVCC = """#!{python}
import os, sys
with open(os.environ["FAKE_NVCC_LOG"], "a") as fh:
    fh.write(" ".join(sys.argv[1:]) + "\\n")
if "--version" in sys.argv:
    print("Cuda compilation tools, release 12.8, V{ver}")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as fh:
    fh.write(b"not a real library: " + " ".join(sys.argv[1:]).encode())
print("ptxas info    : Used 32 registers, 0 bytes spill stores")
"""

_CHILD = """
import json, os, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from sparkdl_tpu_torch.ops import build
from sparkdl_tpu_torch.ops.sepconv import KERNELS
from sparkdl_tpu_torch.parallel import compile_cache
build.BUILD_DIR = Path(os.environ["TEST_BUILD_DIR"])
paths = {{k: str(build.build(name, srcs))
         for k, (name, srcs, _, _) in sorted(KERNELS.items())}}
print(json.dumps({{"state": compile_cache.state(),
                  "stats": compile_cache.stats(), "paths": paths}}))
"""


@pytest.fixture
def toolkit(tmp_path):
    """A fake CUDA toolkit: ``bin/nvcc``."""
    root = tmp_path / "cuda"
    (root / "bin").mkdir(parents=True)
    nvcc = root / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable,
                                      ver=NVCC_VERSION))
    nvcc.chmod(0o755)
    return root


def _child(tmp_path, toolkit, cache_dir, **env_extra):
    """One process building the four libraries; returns its report and
    the nvcc runs it made."""
    log = tmp_path / "nvcc.log"
    before = log.read_text().splitlines() if log.exists() else []
    env = dict(os.environ)
    for key in ("SPARKDL_COMPILE_CACHE", "SPARKDL_FAULTS"):
        env.pop(key, None)
    env.update(PATH=f"{toolkit / 'bin'}{os.pathsep}{env.get('PATH', '')}",
               FAKE_NVCC_LOG=str(log), HOME=str(tmp_path / "home"),
               TEST_BUILD_DIR=str(tmp_path / "build"),
               CUDA_VISIBLE_DEVICES="-1")
    if cache_dir is not None:
        env["SPARKDL_COMPILE_CACHE"] = str(cache_dir)
    env.update(env_extra)
    r = subprocess.run([sys.executable, "-c", _CHILD.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    after = log.read_text().splitlines() if log.exists() else []
    return json.loads(r.stdout.strip().splitlines()[-1]), after[len(before):]


def test_restart_builds_nothing_and_a_tampered_record_purges(tmp_path,
                                                             toolkit):
    cache = tmp_path / "cc"
    a, runs_a = _child(tmp_path, toolkit, cache)
    assert a["state"]["dir"] == str(cache)
    assert a["state"]["reused"] is False
    assert a["state"]["invalidated"] is False
    assert a["stats"] == {"hits": 0, "misses": 4}
    assert len(runs_a) == 4 and all(" -o " in r for r in runs_a)
    assert a["state"]["nvcc"] == f"release 12.8, V{NVCC_VERSION}"
    assert a["state"]["capability"] is None
    for path in a["paths"].values():
        assert Path(path).parent == cache and Path(path).exists()
        assert Path(path).with_suffix(".log").exists()

    b, runs_b = _child(tmp_path, toolkit, cache)
    assert b["state"]["reused"] is True
    assert b["state"]["invalidated"] is False
    assert b["stats"] == {"hits": 4, "misses": 0}
    assert runs_b == []                      # no nvcc ran at all
    assert b["paths"] == a["paths"]

    manifest = cache / pcc.MANIFEST_NAME
    doc = json.loads(manifest.read_text())
    doc["kernels"]["mbconv"] = "0" * 16
    manifest.write_text(json.dumps(doc))
    c, runs_c = _child(tmp_path, toolkit, cache)
    assert c["state"]["invalidated"] is True
    assert c["state"]["drift_rules"] == ["kernel:mbconv"]
    assert c["state"]["purged_entries"] == 8    # four .so and four .log
    assert c["stats"] == {"hits": 0, "misses": 4}
    assert len(runs_c) == 4
    assert c["paths"] == a["paths"]


def test_another_toolchain_purges(tmp_path, toolkit):
    cache = tmp_path / "cc"
    _child(tmp_path, toolkit, cache)
    doc = json.loads((cache / pcc.MANIFEST_NAME).read_text())
    doc["nvcc"] = "release 12.4, V12.4.131"
    (cache / pcc.MANIFEST_NAME).write_text(json.dumps(doc))
    c, runs = _child(tmp_path, toolkit, cache)
    assert c["state"]["drift_rules"] == ["toolchain"]
    assert c["state"]["purged_entries"] == 8
    assert c["stats"] == {"hits": 0, "misses": 4} and len(runs) == 4


def test_gate_off_by_default_builds_in_build_dir(tmp_path, toolkit):
    """No ``SPARKDL_COMPILE_CACHE``: nothing resolved, no directory made,
    every library in ``build/`` (the child's ``BUILD_DIR``) as before, and
    nothing counted."""
    out, runs = _child(tmp_path, toolkit, None)
    assert out["state"] is None
    assert out["stats"] == {"hits": 0, "misses": 0}
    assert len(runs) == 4
    for kernel, path in out["paths"].items():
        name, sources, _, _ = KERNELS[kernel]
        assert Path(path) == (tmp_path / "build"
                              / f"lib{name}_{build.library_hash(name, sources)}.so")
    assert not (tmp_path / "home" / ".cache").exists()
    # in this process too: the gate off resolves to the checkout's build/
    assert pcc.ensure_from_env() is None and not pcc.enabled()
    assert build._directory() == (build.BUILD_DIR, False)
    assert build.BUILD_DIR == REPO / "build" / "sparkdl_tpu_torch"


def test_injected_fault_disables_the_cache_with_a_warning(tmp_path,
                                                         monkeypatch):
    warned = []
    monkeypatch.setattr(pcc.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", str(tmp_path / "cc"))
    with pfaults.active(pfaults.FaultPlan.parse(
            "seed=9;compile.cache:error:times=1")):
        assert build._directory() == (build.BUILD_DIR, False)
    assert pcc.state() is None and not pcc.enabled()
    assert len(warned) == 1 and "disabled" in warned[0]
    assert not (tmp_path / "cc").exists()
    # the same directory configures once the fault is gone
    assert pcc.configure(str(tmp_path / "cc")) is not None
    assert build._directory() == (tmp_path / "cc", True)


def test_unwritable_directory_disables_the_cache(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the directory should be")
    assert pcc.configure(str(blocker / "cc")) is None
    assert build._directory() == (build.BUILD_DIR, False)


@pytest.mark.parametrize("content", ["{not json", "[]", '{"schema_version": 1}',
                                     "jax"])
def test_corrupt_or_foreign_manifest_purges(tmp_path, content):
    cache = tmp_path / "cc"
    cache.mkdir()
    (cache / "libsparkdl_sepconv_0123456789abcdef.so").write_bytes(b"x")
    if content == "jax":
        # the JAX package's manifest is foreign to the port
        try:
            jcc.configure(str(cache))
        finally:
            jcc._reset_for_tests()
    else:
        (cache / pcc.MANIFEST_NAME).write_text(content)
    st = pcc.configure(str(cache))
    assert st["invalidated"] is True and st["reused"] is False
    assert st["drift_rules"] == ["manifest"]
    assert st["purged_entries"] == 1
    assert sorted(os.listdir(cache)) == [pcc.MANIFEST_NAME]
    # the rewritten manifest is the port's: the next resolution reuses
    pcc._reset_for_tests()
    assert pcc.configure(str(cache))["reused"] is True


def test_new_policy_purges_as_gc005_and_none_is_a_wildcard(tmp_path):
    cache = str(tmp_path / "cc")
    a, b = "mesh=1x1|params=replicated", "mesh=1x1|params=0abc"
    assert pcc.configure(cache, policy=a)["sharding_policies"] == [a]
    Path(cache, "libx_0.so").write_bytes(b"x")
    pcc._reset_for_tests()
    st = pcc.configure(cache)               # no policy: never invalidates
    assert st["reused"] is True and st["sharding_policies"] == [a]
    pcc._reset_for_tests()
    st = pcc.configure(cache, policy=b)
    assert st["invalidated"] is True and st["drift_rules"] == ["GC005"]
    assert st["purged_entries"] == 1 and st["sharding_policies"] == [b]


def test_note_policy_widens_the_set_without_a_purge(tmp_path, monkeypatch):
    cache = tmp_path / "cc"
    a, b = "mesh=1x1|params=replicated", "mesh=1x1|params=0abc"
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", str(cache))
    assert pcc.ensure_from_env(policy=a)["sharding_policies"] == [a]
    (cache / "libx_0.so").write_bytes(b"x")
    both = sorted([a, b])
    assert pcc.ensure_from_env(policy=b)["sharding_policies"] == both
    doc = json.loads((cache / pcc.MANIFEST_NAME).read_text())
    assert doc["sharding_policies"] == both
    assert (cache / "libx_0.so").exists()
    # a restart whose first engine holds the second policy reuses
    pcc._reset_for_tests()
    st = pcc.ensure_from_env(policy=b)
    assert st["reused"] is True and (cache / "libx_0.so").exists()


def test_engine_resolves_the_cache_with_its_policy(tmp_path, monkeypatch):
    from sparkdl_tpu_torch.parallel.engine import InferenceEngine

    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", str(tmp_path / "cc"))
    with sparkdl_tpu_torch.default_device("cpu"):
        eng = InferenceEngine(lambda m, x: m(x), torch.nn.Linear(2, 2))
    st = pcc.state()
    assert st["dir"] == str(tmp_path / "cc")
    assert st["sharding_policies"] == [eng.compile_policy()]


def test_flight_events_persist_and_invalidate(tmp_path, monkeypatch):
    rec = FlightRecorder(out_dir=str(tmp_path))
    monkeypatch.setattr(pflight, "_recorder", rec)
    cache = tmp_path / "cc"
    pcc.configure(str(cache))
    (cache / "liby_0.so").write_bytes(b"y")
    doc = json.loads((cache / pcc.MANIFEST_NAME).read_text())
    doc["kernels"]["sepconv"] = "f" * 16
    (cache / pcc.MANIFEST_NAME).write_text(json.dumps(doc))
    pcc._reset_for_tests()
    pcc.configure(str(cache))
    events = [(e["event"], e.get("attrs", e)) for e in rec.snapshot()
              if e["event"].startswith("compile.")]
    names = [n for n, _ in events]
    assert names == ["compile.persist", "compile.invalidate",
                     "compile.persist"]
    inval = events[1][1]
    assert inval["drift_rules"] == str(["kernel:sepconv"])  # as recorded
    assert inval["purged_entries"] == 1 and inval["dir"] == str(cache)
    assert events[0][1]["reused"] is False and events[2][1]["reused"] is False

