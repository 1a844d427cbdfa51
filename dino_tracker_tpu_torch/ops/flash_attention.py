"""Flash attention forward (K2): the ctypes wrapper of ``csrc/flash_attention.cu``.

The kernel replaces the TPU kernel
``dino_tracker_tpu/ops/flash_attention.py:27 _flash_fwd_kernel``: non-causal
softmax(QKᵀ·scale)·V with an online softmax, forward only, for the ViT
feature extractor. The ``.cu`` file's note says what bounds it on the card
and what its design does about that. ``ops/attention.py`` holds the plain
PyTorch version and the device dispatch.

bf16 q, k, v are read through TMA tensor maps built from each tensor's own
strides, so the permuted views of the ViT's qkv projection reach the kernel
as they are; ``tma_layout`` holds that arithmetic (and refuses a layout the
maps cannot express: the wrapper never copies). The bf16 output is a
[B, S, H, 64] buffer returned as its [B, H, S, 64] view. f32 inputs take the
kernel's SIMT path over contiguous tensors.

The library is built with nvcc at first use (``ops/_build.py``), never at
import.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, _guard

HEAD_DIMS = (64,)  # the head dims the kernel takes (every DINOv2 preset: 64)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_STRIDE_BYTES = 1 << 40  # a tensor map's stride limit
LIBRARY = "flash_attention"  # csrc/flash_attention.cu
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# bf16: q, k, v, out, B, H, S, d, the inputs' 9 and the output's 3 byte
# strides, scale, stream; f32: q, k, v, out, B·H, S, d, scale, stream
SIGNATURES = {
    "flash_attention_fwd_bf16": (ctypes.c_int, (_P,) * 4 + (_I64,) * 4 + (
        ctypes.POINTER(_I64), ctypes.POINTER(_I64), ctypes.c_float, _P)),
    "flash_attention_fwd_f32": (ctypes.c_int, (_P,) * 4 + (_I64,) * 3 + (ctypes.c_float, _P))}


def load_library():
    return _build.load(LIBRARY, SIGNATURES)


class TmaLayout(NamedTuple):
    """One operand's 4-D tensor map: ``dims`` (d, H, S, B) innermost first,
    ``byte_strides`` of the H, S and B axes, and the base ``address``."""
    dims: tuple[int, int, int, int]
    byte_strides: tuple[int, int, int]
    address: int


def tma_layout(shape, strides, itemsize: int, address: int) -> TmaLayout:
    """The tensor-map arguments of a [B, H, S, d] view with element
    ``strides`` at byte ``address``. The d axis must be contiguous, every
    other stride a positive multiple of 16 bytes below 2^40 and the address
    16-byte aligned; anything else raises ValueError. An axis of size 1 is
    never stepped, so its stride is replaced by d·itemsize."""
    b, h, s, d = shape
    if strides[3] != 1:
        raise ValueError(f"flash_attention_cuda: the head dim must be contiguous "
                         f"(stride 1), got strides {tuple(strides)}")
    if address % 16:
        raise ValueError(f"flash_attention_cuda: a TMA tensor map needs a "
                         f"16-byte aligned base, got address {address:#x}")
    byte_strides = []
    for size, stride in ((h, strides[1]), (s, strides[2]), (b, strides[0])):
        nbytes = stride * itemsize if size > 1 else d * itemsize
        if nbytes <= 0 or nbytes % 16 or nbytes >= _MAX_STRIDE_BYTES:
            raise ValueError(
                f"flash_attention_cuda: a TMA tensor map cannot express the "
                f"strides {tuple(strides)} of shape {tuple(shape)} (each must be "
                f"a positive multiple of 16 bytes below 2^40)")
        byte_strides.append(nbytes)
    return TmaLayout((d, h, s, b), tuple(byte_strides), address)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, {name} "
                             f"is on {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                            f"{name} is {t.dtype}")
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors, d = 64. bf16: [B, H, S, 64] views with any
    strides ``tma_layout`` takes; returns the [B, H, S, 64] view of a
    [B, S, H, 64] buffer. f32: contiguous [..., S, 64]; returns a contiguous
    tensor. Any S: keys and rows past S are masked inside the kernel."""
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        return _launch_bf16(q, k, v, sm_scale)
    return _launch_f32(q, k, v, sm_scale)


def _launch_bf16(q, k, v, sm_scale):
    if q.dim() != 4:
        raise ValueError(f"flash_attention_cuda takes bf16 [B, H, S, d], got "
                         f"shape {tuple(q.shape)}")
    maps = [tma_layout(t.shape, t.stride(), t.element_size(), t.data_ptr())
            for t in (q, k, v)]
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    in_strides = (ctypes.c_int64 * 9)(*(x for m in maps for x in m.byte_strides))
    o_strides = (ctypes.c_int64 * 3)(out.stride(0), out.stride(1), out.stride(2))
    lib, _ = load_library()
    _guard.launch(lib, "flash_attention_fwd_bf16", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, h, s, d, in_strides, o_strides,
                  float(sm_scale), kernel="flash_attention")
    return out.permute(0, 2, 1, 3)


def _launch_f32(q, k, v, sm_scale):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda needs contiguous f32 tensors, "
                             f"{name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda needs 16-byte aligned "
                             f"tensors, {name} is not")
    lib, _ = load_library()
    out = torch.empty_like(q)
    bh = q.numel() // (q.shape[-2] * q.shape[-1])
    _guard.launch(lib, "flash_attention_fwd_f32", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), bh, q.shape[-2], q.shape[-1],
                  float(sm_scale), kernel="flash_attention")
    return out
