"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each library is a plain C interface compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ``build/sparkdl_tpu_torch/``
at the root of the checkout, under a name keyed on a hash of its sources,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads at once.  :func:`load_all` starts one
nvcc per library at once.  A failed build raises; nothing falls back to a
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparkdl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of sparkdl_tpu_torch "
                       "are built from source on the machine with the card")


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where ``name`` built from ``sources`` (file names under ``csrc/``)
    lives: the name carries a hash of the sources, the headers and the
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for src in [*sources, *headers]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` into the library for ``name`` unless it exists;
    nvcc's output (ptxas register and shared-memory report included) is
    kept beside it as ``.log``.  Raises ``RuntimeError`` on failure."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_log(name: str, sources: Sequence[str]) -> str:
    """nvcc's output from the build of ``name`` ("" if it was built by
    another process that kept no log)."""
    log = library_path(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load ``name`` once per process; libraries of
    other names build beside it."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _loaded[name] = lib
        return lib


def load_all(libraries: Mapping[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """Build and load every ``name -> sources`` library, one nvcc each, all
    started together; raises the first failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        futures = {name: pool.submit(load, name, srcs)
                   for name, srcs in libraries.items()}
        return {name: fut.result() for name, fut in futures.items()}
