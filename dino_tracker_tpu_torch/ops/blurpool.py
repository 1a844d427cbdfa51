"""Blurpool (K1): binomial [1,3,3,1]/8 filter, stride 2, reflect pad, over
NHWC tensors, forward (K1-fwd) and backward (K1-bwd).

``blurpool_cuda`` launches the hand-written Hopper kernels in
``csrc/blurpool.cu``. K1-fwd replaces the TPU kernel
``dino_tracker_tpu/ops/blurpool.py:59 _down_kernel``, which ran the stencil as
two 1-D passes with a transpose between them. K1-bwd, launched by the
autograd backward, replaces ``_up_kernel`` (``ops/blurpool.py:67``), the
transpose stencil. Both are bound by device-memory bytes (16 FMAs per
output, ~1.25 bytes moved per byte of the larger tensor), so the CUDA forms
are one fused 2-D pass each with C-minor coalesced accesses and no
transposes; K1-bwd runs a thread per 2×2 output quad. See the source notes
in the ``.cu`` file.

``blurpool_reference`` is the plain PyTorch version: reflect pad (1, 2) and a
depthwise conv with the outer-product filter, computed in f32 and cast to the
input dtype (antialiased_cnns.BlurPool semantics); its autograd is the plain
backward. ``blurpool`` dispatches on the tensor's device: CPU tensors take
the plain version, CUDA tensors the kernels, with no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _guard

# binomial [1,3,3,1]/8 per axis — exact binary floats
TAPS = (1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = "blurpool"  # csrc/blurpool.cu
# x, y, N, H, W, C, dtype code, stream
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)
SIGNATURES = {"blurpool_down_nhwc": (ctypes.c_int, _ARGS),
              "blurpool_up_nhwc": (ctypes.c_int, _ARGS)}


def blurpool_reference(x_nhwc: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 reflect-pad + depthwise conv, cast to x's dtype."""
    c = x_nhwc.shape[-1]
    a = torch.tensor(TAPS, dtype=torch.float32, device=x_nhwc.device)
    filt = (a[:, None] * a[None, :]).expand(c, 1, 4, 4).contiguous()
    x = F.pad(x_nhwc.permute(0, 3, 1, 2).float(), (1, 2, 1, 2), mode="reflect")
    y = F.conv2d(x, filt, stride=2, groups=c)
    return y.permute(0, 2, 3, 1).contiguous().to(x_nhwc.dtype)


def load_library():
    return _build.load(LIBRARY, SIGNATURES)


def _check(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{what} takes N×H×W×C, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} needs a contiguous NHWC tensor")


def _check_hw(h: int, w: int):
    if h < 3 or w < 3:
        raise ValueError(f"reflect pad 2 needs H, W >= 3, got H={h}, W={w}")


def _launch(x: torch.Tensor) -> torch.Tensor:
    _check(x, "blurpool_cuda")
    _check_hw(x.shape[1], x.shape[2])
    lib, _ = load_library()
    n, h, w, c = x.shape
    y = torch.empty((n, (h + 1) // 2, (w + 1) // 2, c), dtype=x.dtype,
                    device=x.device)
    _guard.launch(lib, "blurpool_down_nhwc", x.device, x.data_ptr(), y.data_ptr(), n, h, w,
                  c, _DTYPE_CODE[x.dtype], kernel="blurpool_down_nhwc")
    return y


def blurpool_cuda_bwd(g_nhwc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Launch K1-bwd: the cotangent of the forward's N×H×W×C input from the
    contiguous CUDA cotangent ``g`` (N×ceil(H/2)×ceil(W/2)×C) of its output."""
    _check(g_nhwc, "blurpool_cuda_bwd")
    _check_hw(h, w)
    n, ho, wo, c = g_nhwc.shape
    if (ho, wo) != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"cotangent {tuple(g_nhwc.shape)} is not the output "
                         f"shape of an {h}×{w} input")
    if n > 65535 or ho > 65535:  # the grid's z and y limits
        raise ValueError(f"blurpool_cuda_bwd takes at most 65535 frames and "
                         f"output rows, got N={n}, ceil(H/2)={ho}")
    if h * w * c >= 2 ** 31:  # the kernel's int32 offsets within a frame
        raise ValueError(f"blurpool_cuda_bwd: a frame of 2^31 values or more "
                         f"({h}×{w}×{c})")
    lib, _ = load_library()
    gx = torch.empty((n, h, w, c), dtype=g_nhwc.dtype, device=g_nhwc.device)
    _guard.launch(lib, "blurpool_up_nhwc", g_nhwc.device, g_nhwc.data_ptr(), gx.data_ptr(),
                  n, h, w, c, _DTYPE_CODE[g_nhwc.dtype], kernel="blurpool_up_nhwc")
    return gx


class _BlurPoolDown(torch.autograd.Function):
    """K1-fwd with K1-bwd as its VJP. The op is linear, so the backward
    needs no residuals, only the input's H and W."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = (x.shape[1], x.shape[2])
        return _launch(x)

    @staticmethod
    def backward(ctx, g):
        return blurpool_cuda_bwd(g.contiguous(), *ctx.hw)


def blurpool_cuda(x_nhwc: torch.Tensor) -> torch.Tensor:
    """Launch K1-fwd on a contiguous CUDA NHWC tensor (f32 or bf16); its
    autograd backward launches K1-bwd."""
    return _BlurPoolDown.apply(x_nhwc)


def blurpool(x_nhwc: torch.Tensor) -> torch.Tensor:
    """Device dispatch: the plain version for CPU tensors, K1 for CUDA ones."""
    if x_nhwc.device.type == "cpu":
        return blurpool_reference(x_nhwc)
    return blurpool_cuda(x_nhwc)
