"""Native host-IO core: build and ctypes binding (port of
``sparkdl_tpu/native``).

``sparkdl_native.cpp`` (threaded fused JPEG/PNG decode and bilinear resize,
libjpeg's DCT prescale) is compiled at first use with the system toolchain,
``g++ -O3 -shared -fPIC -pthread -std=c++17 ... -ljpeg -lpng``, into
``build/sparkdl_tpu_torch/`` at the root of the checkout under a name keyed
on a hash of the source and the flags (as ``ops/build.py`` keys the CUDA
libraries), and bound with ctypes; its calls release the GIL.  This is host
code: where g++, ``jpeglib.h`` or ``png.h`` is missing, or
``SPARKDL_TPU_DISABLE_NATIVE`` is set, the callers in ``image/io.py`` take
the PIL route, as the JAX package's do.  :func:`status` says which route
runs and why.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SRC = Path(__file__).resolve().parent / "sparkdl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparkdl_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")
DISABLE_ENV = "SPARKDL_TPU_DISABLE_NATIVE"

_lock = threading.Lock()
_lib = None
_load_attempted = False
_why_not: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsparkdl_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> Optional[str]:
    """Compile the core into ``path``; the reason it failed, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), *LIBS, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ did not run ({e})"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        err = proc.stderr.strip().splitlines()
        return "g++ failed: " + (err[0] if err else f"rc {proc.returncode}")
    os.replace(tmp, path)   # concurrent builders each land a whole file
    return None


def _load():
    global _lib, _load_attempted, _why_not
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get(DISABLE_ENV):
            _why_not = f"disabled by {DISABLE_ENV}"
            logger.info("native IO %s", _why_not)
            return None
        path = library_path()
        if not path.exists():
            _why_not = _build(path)
            if _why_not is not None:
                logger.warning("native build failed; using PIL path: %s",
                               _why_not)
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _why_not = f"load failed ({e})"
            logger.warning("native library %s; using PIL path", _why_not)
            return None
        lib.sdl_decode_resize_batch.restype = ctypes.c_int
        lib.sdl_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.sdl_resize_batch.restype = None
        lib.sdl_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        logger.info("native IO core loaded (%s)", path)
        return _lib


@contextlib.contextmanager
def unloaded():
    """The core forgotten for the duration: the next call loads (or builds)
    it anew under the environment and the module's settings of that
    moment.  The core as it was comes back on exit."""
    global _lib, _load_attempted, _why_not
    with _lock:
        saved = _lib, _load_attempted, _why_not
        _lib, _load_attempted, _why_not = None, False, None
    try:
        yield
    finally:
        with _lock:
            _lib, _load_attempted, _why_not = saved


@contextlib.contextmanager
def disabled():
    """The PIL route for the duration, as ``SPARKDL_TPU_DISABLE_NATIVE``
    gives it; the variable and the core come back on exit."""
    before = os.environ.get(DISABLE_ENV)
    os.environ[DISABLE_ENV] = "1"
    try:
        with unloaded():
            yield
    finally:
        if before is None:
            os.environ.pop(DISABLE_ENV, None)
        else:
            os.environ[DISABLE_ENV] = before


def native_available() -> bool:
    return _load() is not None


def status() -> Tuple[bool, str]:
    """``(built, why not)``: whether the core is in use, else the reason
    (the build's first error line, a load error, or the disabling
    variable)."""
    ok = native_available()
    return ok, "" if ok else (_why_not or "unknown")


def _default_threads() -> int:
    return min(16, os.cpu_count() or 4)


def decode_resize_batch(blobs: Sequence[bytes], height: int, width: int,
                        num_threads: Optional[int] = None
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Fused decode (JPEG/PNG) + resize of encoded images into a [N,h,w,3]
    uint8 RGB batch and a boolean ok-mask; None when the core is
    unavailable (the caller takes the PIL route)."""
    lib = _load()
    if lib is None:
        return None
    n = len(blobs)
    out = np.zeros((n, height, width, 3), dtype=np.uint8)
    status_ = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return out, status_.astype(bool)
    buffers = [bytes(b) for b in blobs]     # alive for the call
    ptrs = (ctypes.c_char_p * n)(*buffers)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in buffers])
    lib.sdl_decode_resize_batch(
        ptrs, sizes, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status_.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads or _default_threads())
    return out, status_.astype(bool)


def resize_batch_rgb(images: Sequence[np.ndarray], height: int, width: int,
                     num_threads: Optional[int] = None
                     ) -> Optional[np.ndarray]:
    """Resize [h,w,3] uint8 RGB arrays into one [N,h,w,3] batch; None when
    the core is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(images)
    out = np.zeros((n, height, width, 3), dtype=np.uint8)
    if n == 0:
        return out
    contiguous = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    for im in contiguous:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"resize_batch_rgb needs [h,w,3] uint8 arrays, "
                             f"got {im.shape}")
    ptrs = (ctypes.c_char_p * n)(
        *[im.ctypes.data_as(ctypes.c_char_p) for im in contiguous])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in contiguous])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in contiguous])
    lib.sdl_resize_batch(
        ptrs, hs, ws, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads or _default_threads())
    return out
