"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each library is a plain C interface compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ``build/sparkdl_tpu_torch/``
at the root of the checkout, under a name keyed on a hash of its sources,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads at once.  Under the
``SPARKDL_COMPILE_CACHE`` gate the libraries build into, and load from, the
persistent compile cache's directory instead
(:mod:`sparkdl_tpu_torch.parallel.compile_cache`: a manifest keyed on the
toolchain and every library's hash, purged on drift, with hit and miss
counts); the cache is resolved before the first directory is chosen.
:func:`load_all` starts one nvcc per library at once.  A failed build
raises; nothing falls back to a plain version.
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
from typing import Dict, Mapping, Optional, Sequence, Tuple

from sparkdl_tpu_torch.analysis.lockcheck import named_lock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparkdl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = named_lock("ops.build")
_name_locks: Dict[str, Any] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> Optional[str]:
    """The nvcc that builds the libraries (the first on ``PATH``, else
    the CUDA toolkit's default), or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.isfile(default) else None


def _nvcc() -> str:
    found = nvcc_path()
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "sparkdl_tpu_torch are built from source on the "
                           "machine with the card")
    return found


def library_hash(name: str, sources: Sequence[str]) -> str:
    """The hash ``name``'s library is named by: its sources (file names
    under ``csrc/``), the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for src in [*sources, *headers]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _directory() -> Tuple[Path, bool]:
    """Where libraries build and load: the persistent compile cache's
    directory when it is enabled (resolved here on first use), else
    ``BUILD_DIR``; and whether that is the cache."""
    from sparkdl_tpu_torch.parallel import compile_cache

    st = compile_cache.ensure_from_env()
    if st is None:
        return BUILD_DIR, False
    return Path(st["dir"]), True


def library_path(name: str, sources: Sequence[str],
                 directory: Optional[Path] = None) -> Path:
    """Where ``name`` built from ``sources`` lives: in ``directory``
    (default: the compile cache's when it is enabled, else ``BUILD_DIR``),
    named by :func:`library_hash`."""
    if directory is None:
        directory = _directory()[0]
    return Path(directory) / f"lib{name}_{library_hash(name, sources)}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` into the library for ``name`` unless it exists;
    nvcc's output (ptxas register and shared-memory report included) is
    kept beside it as ``.log``.  Raises ``RuntimeError`` on failure.  In
    the compile cache a library found is one hit, an nvcc run one miss."""
    from sparkdl_tpu_torch.parallel import compile_cache

    directory, cached = _directory()
    out = library_path(name, sources, directory)
    if out.exists():
        if cached:
            compile_cache.record_hit()
        return out
    directory.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if cached:
        compile_cache.record_miss()
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
        lock = _name_locks.setdefault(name, named_lock("ops.build.library"))
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
