"""Build the port's CUDA sources into shared libraries at first use.

Each library is one ``nvcc`` call over ``dino_tracker_tpu_torch/csrc/<name>.cu``
with a plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper (``sm_90a``), written into ``<repo>/build/kernels/`` (git-ignored) and
loaded with ``ctypes``. ptxas reports each kernel's registers, shared memory
and spills (``-Xptxas -v``) into ``lib<name>.ptxas.txt`` beside the library
(``ptxas_report``). A library older than its source is rebuilt. Each
source has its own lock, so the libraries can build in parallel. ``load``
builds, loads and binds one library once a process from its ops module's
signature table. Nothing here runs at import time: the CPU tests import
every module of the port on machines with no ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks = collections.defaultdict(threading.RLock)  # one per library name
_loaded = {}  # library name -> its bound library


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise FileNotFoundError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source on the machine with the GPU")
    return nvcc


def build(name: str) -> tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns (library path, seconds spent compiling; 0.0 when it was current).
    """
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _locks[name]:
        if (os.path.exists(lib) and os.path.exists(_ptxas_path(name))
                and os.path.getmtime(lib) >= os.path.getmtime(src)):
            return lib, 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        with open(_ptxas_path(name), "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
        return lib, time.perf_counter() - t0


def load(name: str, signatures: dict) -> tuple[ctypes.CDLL, float]:
    """``csrc/<name>.cu``'s library, built if stale, loaded and bound to
    ``signatures`` ({entry: (restype, argtypes)}) at its first call in the
    process; returns it with the seconds spent compiling (0.0 when it was
    already built or loaded)."""
    with _locks[name]:
        if name in _loaded:
            return _loaded[name], 0.0
        path, seconds = build(name)
        _loaded[name] = bind(ctypes.CDLL(path), signatures)
        return _loaded[name], seconds


def bind(lib, signatures: dict):
    """Set each entry's ``restype`` and ``argtypes`` from ``signatures``."""
    for entry, (restype, argtypes) in signatures.items():
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptxas_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt")


def ptxas_report(name: str) -> list[tuple[str, str]]:
    """``parse_ptxas`` of ``csrc/<name>.cu``'s last build log."""
    with open(_ptxas_path(name)) as f:
        return parse_ptxas(f.read())


def parse_ptxas(log: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, ... bytes smem, ...; ... spill stores, ...")
    for each entry function in an ``nvcc -Xptxas -v`` log."""
    rows, kernel, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            rows.append((kernel, f"{line.split('Used', 1)[1].strip()}; {spills}"))
            kernel, spills = None, ""
    return rows
