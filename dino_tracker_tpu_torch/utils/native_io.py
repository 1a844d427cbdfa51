"""ctypes binding of the native frame loader (``native/video_io.cpp``), built
at first use with g++ into ``<repo>/build/native/``. Returns None where the
toolchain or its libraries (libjpeg, libpng) are missing, and the caller
then decodes with Pillow, as the JAX package's loader does."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "video_io.cpp")
_LIB = os.path.join(_REPO, "build", "native", "libvideo_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    """Compile the loader (the JAX package's flags); the library appears
    atomically, so concurrent processes see the old one or the new one."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-pthread",
           _SRC, "-o", tmp, "-ljpeg", "-lpng"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning("native video_io build failed: %s", getattr(e, "stderr", e))
        return False
    os.replace(tmp, _LIB)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SRC):
            _build_failed = True
            return None
        stale = (not os.path.exists(_LIB)
                 or os.path.getmtime(_SRC) > os.path.getmtime(_LIB))
        if stale and not _build():
            _build_failed = True
            return None
        lib = ctypes.CDLL(_LIB)
        lib.decode_resize_batch.restype = ctypes.c_int
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _lib = lib
        return _lib


def decode_resize_batch(paths, out_h: int, out_w: int,
                        n_threads: int = 0) -> Optional[np.ndarray]:
    """Decode and Lanczos-resize frames across threads -> T×3×H×W float32 in
    [0, 1]; None if the native path is unavailable or a frame fails."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, 3, out_h, out_w), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.decode_resize_batch(
        arr, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        logger.warning("native decode failed on frame %d (%s)", rc - 1,
                       paths[rc - 1])
        return None
    return out
