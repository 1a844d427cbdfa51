"""The chaining look-behind's occupancy update (port of
``dino_tracker_tpu/utils/native_traj.py``): a ctypes binding of the native
``native/trajectory_ops.cpp`` (a repo file), built at first use with g++ into
``<repo>/build/native/``, with its NumPy path beside it.

``occupancy_update`` marks, for every finite trajectory position at frames
[start, T), the cell (round-half-to-even y, x), clipped to the frame, as
occupied. The native library does it in one multithreaded pass; where the
toolchain is missing the NumPy path does the same."""

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
_SRC = os.path.join(_REPO, "native", "trajectory_ops.cpp")
_LIB = os.path.join(_REPO, "build", "native", "libtrajectory_ops.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    """Compile the library (the JAX package's flags); it appears atomically,
    so concurrent processes see the old one or the new one."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning("native trajectory_ops build failed: %s",
                       getattr(e, "stderr", e))
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
        lib.occupancy_update.restype = None
        lib.occupancy_update.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        _lib = lib
        return _lib


def occupancy_update_numpy(trajs_tk2: np.ndarray, occupied_thw: np.ndarray,
                           start: int):
    """The NumPy path of ``occupancy_update``."""
    t, h, w = occupied_thw.shape
    valid = ~np.isnan(trajs_tk2).any(axis=-1)  # t×K
    coords = np.round(np.nan_to_num(trajs_tk2)).astype(np.int64)
    xi = np.clip(coords[..., 0], 0, w - 1)
    yi = np.clip(coords[..., 1], 0, h - 1)
    for f in range(start, t):
        sel = valid[f]
        occupied_thw[f, yi[f, sel], xi[f, sel]] = True


def occupancy_update(trajs_tk2: np.ndarray, occupied_thw: np.ndarray, start: int,
                     n_threads: int = 0):
    """Mark occupied[f, round(y), round(x)] for every finite position of the
    T×K×2 trajectories at frames [start, T), in place. ``occupied`` is a
    C-contiguous T×H×W bool array."""
    if (occupied_thw.dtype != np.bool_ or not occupied_thw.flags.c_contiguous
            or occupied_thw.ndim != 3):
        raise ValueError("occupied must be a C-contiguous T×H×W bool array")
    if (trajs_tk2.ndim != 3 or trajs_tk2.shape[0] != occupied_thw.shape[0]
            or trajs_tk2.shape[2] != 2):
        raise ValueError(f"trajectories must be T×K×2 with T = "
                         f"{occupied_thw.shape[0]}, got {trajs_tk2.shape}")
    if not 0 <= start <= occupied_thw.shape[0]:
        raise ValueError(f"start {start} outside [0, {occupied_thw.shape[0]}]")
    lib = get_lib()
    if lib is None:
        occupancy_update_numpy(trajs_tk2, occupied_thw, start)
        return
    t, k, _ = trajs_tk2.shape
    h, w = occupied_thw.shape[1:]
    trajs = np.ascontiguousarray(trajs_tk2, np.float32)
    lib.occupancy_update(trajs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         t, k, start, h, w,
                         occupied_thw.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                         n_threads)
