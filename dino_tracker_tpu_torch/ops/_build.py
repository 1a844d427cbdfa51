"""Build the port's CUDA sources into shared libraries at first use.

Each library is one ``nvcc`` call over ``dino_tracker_tpu_torch/csrc/<name>.cu``
with a plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper (``sm_90a``), written into ``<repo>/build/kernels/`` (git-ignored) and
loaded with ``ctypes``. A library older than its source is rebuilt. Each
source has its own lock, so the libraries can build in parallel. Nothing
here runs at import time: the CPU tests import every module of the port on
machines with no ``nvcc``.
"""

from __future__ import annotations

import collections
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_locks = collections.defaultdict(threading.Lock)  # one per library name


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
        if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
            return lib, 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
        return lib, time.perf_counter() - t0
