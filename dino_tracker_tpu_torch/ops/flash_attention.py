"""Flash attention forward (K2): the ctypes wrapper of ``csrc/flash_attention.cu``.

The kernel replaces the TPU kernel
``dino_tracker_tpu/ops/flash_attention.py:27 _flash_fwd_kernel``: non-causal
softmax(QKᵀ·scale)·V with an online softmax, forward only, for the ViT
feature extractor. The ``.cu`` file's note says what bounds it on the card
and what its design does about that. ``ops/attention.py`` holds the plain
PyTorch version and the device dispatch.

The library is built with nvcc at first use (``ops/_build.py``), never at
import. ``flash_attention_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (64,)  # the head dims the kernel takes (every DINOv2 preset: 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def load_library() -> tuple[ctypes.CDLL, float]:
    """Build (at first use) and bind the kernel library; returns it with the
    seconds spent compiling (0.0 when it was already built or loaded)."""
    global _lib
    if _lib is not None:
        return _lib, 0.0
    from . import _build
    path, seconds = _build.build("flash_attention")
    lib = ctypes.CDLL(path)
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return lib, seconds


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, {name} "
                             f"is on {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda needs contiguous tensors, "
                             f"{name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda needs 16-byte aligned "
                             f"tensors, {name} is not")
    if not (q.shape == k.shape == v.shape) or q.dim() < 2:
        raise ValueError(f"q, k, v must share one [..., S, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.device != k.device or q.device != v.device:
        raise TypeError("q, k, v must share one dtype and one device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dim {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    bh = q.numel() // (q.shape[-2] * q.shape[-1]) if q.numel() else 0
    if not 1 <= bh <= 65535 or q.shape[-2] < 1:
        raise ValueError(f"flash_attention_cuda takes 1..65535 batch·heads and "
                         f"S >= 1, got shape {tuple(q.shape)}")
    return bh


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: float) -> torch.Tensor:
    """Launch K2 on contiguous CUDA tensors [..., S, d] (every leading axis is
    a batch axis, d = 64), bf16 or f32. Any S: keys and rows past S are
    handled by bounds inside the kernel."""
    bh = _check(q, k, v)
    lib, _ = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), bh, q.shape[-2], q.shape[-1],
                                  float(sm_scale), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0  # kernel launches since the last reset
