"""The port's kernel build (sparkdl_tpu_torch/ops/build.py) on the CPU: no
nvcc here, so these tests pin the library naming and the parallel loader
with the compiler and ``ctypes`` replaced."""

import importlib.util
import threading
from pathlib import Path

import pytest

from sparkdl_tpu_torch.ops import build, sepconv


def test_library_name_hashes_sources_and_shared_headers(tmp_path,
                                                        monkeypatch):
    """An edit to a kernel source or to a shared ``.cuh`` header gives the
    library a new name (so it rebuilds); another kernel's source does
    not."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "common.cuh").write_text("// helpers v1\n")
    first = build.library_path("liba", ["a.cu"])
    assert first.name.startswith("libliba_") and first.suffix == ".so"
    assert build.library_path("liba", ["a.cu"]) == first
    (tmp_path / "b.cu").write_text("// b, edited\n")
    assert build.library_path("liba", ["a.cu"]) == first
    (tmp_path / "common.cuh").write_text("// helpers v2\n")
    second = build.library_path("liba", ["a.cu"])
    assert second != first
    (tmp_path / "a.cu").write_text("// a, edited\n")
    assert build.library_path("liba", ["a.cu"]) not in (first, second)


def test_every_kernel_source_exists():
    for name, sources, _, _ in sepconv.KERNELS.values():
        assert build.library_path(name, sources).name.startswith(f"lib{name}_")


def test_load_all_builds_in_parallel_and_raises_a_failure(monkeypatch):
    """``load_all`` starts one build per library at once (each waits here
    until all have started) and raises a failed build's error."""
    names = ["k1", "k2", "k3"]
    started = threading.Barrier(len(names), timeout=10)

    def fake_build(name, sources):
        started.wait()
        if name == "k2":
            raise RuntimeError("nvcc failed building k2")
        return f"/nowhere/{name}.so"

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="k2"):
        build.load_all({n: (f"{n}.cu",) for n in names})
    started.reset()
    monkeypatch.setattr(build, "_loaded", {})
    ok = {n: (f"{n}.cu",) for n in ("k1", "k3", "k4")}
    assert build.load_all(ok) == {n: f"/nowhere/{n}.so" for n in ok}


def test_wgmma_header_is_the_generators_output():
    """``csrc/wgmma.cuh`` is written by ``tools/gen_wgmma.py``: the file in
    the tree is what the script writes now, one product per N width."""
    path = Path(__file__).resolve().parents[1] / "tools" / "gen_wgmma.py"
    spec = importlib.util.spec_from_file_location("gen_wgmma", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    text = gen.HEAD + "".join(gen.specialization(n) for n in gen.WIDTHS) \
        + gen.TAIL
    assert (build.CSRC / "wgmma.cuh").read_text() == text
    for n in gen.WIDTHS:
        assert f"m64n{n}k16.f32.bf16.bf16" in text
