"""Tracker head convs (K4): conv1 (1→16, 3×3) + bias + ReLU + conv2 (16→1,
3×3) + bias, zero padded, over B×H'×W' f32 correlation maps, forward (K4-fwd)
and backward (K4-bwd).

``head_conv_cuda`` launches the hand-written Hopper kernels in
``csrc/tracker_head.cu``; its autograd backward launches K4-bwd, which
recomputes the hidden map from the input map and returns the input gradient
and the gradients of both normalised weights and both biases. They replace
no TPU kernel (the JAX package leaves the head's convs to XLA): cuDNN runs
these 1-channel shapes far from their bound and keeps the 16-channel f32
hidden map in device memory, which the kernels never write. The ``.cu``
file's note says what bounds them and what their design does about that.

``head_conv_reference`` is the plain PyTorch version (two ``F.conv2d``
calls and the ReLU between them). ``TrackerHead`` keeps
its own plain chain for CPU tensors and calls ``head_conv_cuda`` for CUDA
ones. The weights given are the normalised ones: the normalisation stays in
PyTorch under autograd.

K4-bwd's parameter gradients are sums over every pixel of every map: each
block of a fixed number of persistent blocks writes its partial sums to a
scratch buffer and a second kernel adds them in block order, so the same
inputs give the same bits, eager or replayed from a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _guard

HIDDEN, TAPS = 16, 9
N_PARAMS = 2 * HIDDEN * TAPS + HIDDEN + 1  # g_w1, g_b1, g_w2, g_b2, as the kernel writes them
W1_SHAPE, B1_SHAPE = (HIDDEN, 1, 3, 3), (HIDDEN,)
W2_SHAPE, B2_SHAPE = (1, HIDDEN, 3, 3), (1,)
LIBRARY = "tracker_head"  # csrc/tracker_head.cu
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# fwd: x, w1, b1, w2, b2, y, blocks, B, H', W', stream; bwd: x, gy, w1, b1,
# w2, gx, partials, params, blocks, B, H', W', stream
SIGNATURES = {"head_conv_fwd": (ctypes.c_int, (_P,) * 6 + (_I64,) * 4 + (_P,)),
              "head_conv_bwd": (ctypes.c_int, (_P,) * 8 + (_I64,) * 4 + (_P,)),
              "head_conv_max_blocks": (ctypes.c_int, (ctypes.POINTER(ctypes.c_int),) * 2)}
_max_blocks = {}  # device index -> (K4-fwd's, K4-bwd's) resident blocks


def head_conv_reference(x_bhw: torch.Tensor, w1n: torch.Tensor, b1: torch.Tensor,
                        w2n: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: conv1 + bias, ReLU, conv2 + bias; B×H'×W' logits. On
    CUDA the caller holds ``torch.backends.cudnn.allow_tf32`` off, forward
    and backward, for f32 by f32."""
    h = torch.relu(F.conv2d(x_bhw[:, None], w1n, b1, padding=1))
    return F.conv2d(h, w2n, b2, padding=1)[:, 0]


def load_library():
    return _build.load(LIBRARY, SIGNATURES)


def _check_inputs(what: str, x: torch.Tensor, w1n, b1, w2n, b2=None, gy=None):
    """Raise on anything the kernels do not take: f32 only, the head's
    shapes (maps B×H'×W' with H', W' >= 1, 1→16→1 3×3 weights), contiguous,
    all on one CUDA device."""
    named = [(x, "maps", None), (gy, "cotangent", tuple(x.shape)),
             (w1n, "conv1 weight", W1_SHAPE), (b1, "conv1 bias", B1_SHAPE),
             (w2n, "conv2 weight", W2_SHAPE), (b2, "conv2 bias", B2_SHAPE)]
    named = [(t, f"{what} {name}", shape) for t, name, shape in named if t is not None]
    for t, name, shape in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 only, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous tensor")
    if x.dim() != 3:
        raise ValueError(f"{what} takes B×H'×W' maps, got shape {tuple(x.shape)}")
    if x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"{what} needs H', W' >= 1, got {tuple(x.shape)}")
    for t, name, _ in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the maps on {x.device}")


def _launch(x, w1n, b1, w2n, b2) -> torch.Tensor:
    _check_inputs("head_conv_cuda", x, w1n, b1, w2n, b2)
    y = torch.empty_like(x)
    if x.shape[0] == 0:  # a mesh rank's share can be empty
        return y
    lib, _ = load_library()
    _guard.launch(lib, "head_conv_fwd", x.device, x.data_ptr(), w1n.data_ptr(), b1.data_ptr(),
                  w2n.data_ptr(), b2.data_ptr(), y.data_ptr(), _blocks(lib, x.device)[0],
                  *x.shape, kernel="head_conv_fwd")
    return y


def _blocks(lib, device: torch.device) -> tuple[int, int]:
    """K4-fwd's and K4-bwd's persistent blocks on ``device`` (resident blocks
    an SM × SMs), asked once a device, with K4-bwd's shared memory allowed."""
    index = device.index  # a CUDA tensor's device always has one
    if index not in _max_blocks:
        fwd, bwd = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.head_conv_max_blocks(ctypes.byref(fwd), ctypes.byref(bwd))
        if err != 0:
            raise RuntimeError(f"head_conv_max_blocks failed: CUDA error {err}")
        _max_blocks[index] = (fwd.value, bwd.value)
    return _max_blocks[index]


def head_conv_cuda_bwd(x: torch.Tensor, gy: torch.Tensor, w1n: torch.Tensor,
                       b1: torch.Tensor, w2n: torch.Tensor):
    """Launch K4-bwd: from the forward's maps ``x`` and the logits' cotangent
    ``gy`` (both contiguous B×H'×W' f32), the cotangents of the maps, the
    normalised conv1 weight, its bias, the normalised conv2 weight and its
    bias. The conv2 bias's gradient is the sum of ``gy``."""
    _check_inputs("head_conv_cuda_bwd", x, w1n, b1, w2n, gy=gy)
    gx = torch.empty_like(x)
    empty = x.shape[0] == 0  # a mesh rank's share: zero gradients, no launch
    params = (torch.zeros if empty else torch.empty)(N_PARAMS, dtype=torch.float32,
                                                      device=x.device)
    if not empty:
        lib, _ = load_library()
        blocks = _blocks(lib, x.device)[1]
        partials = torch.empty(blocks * N_PARAMS, dtype=torch.float32, device=x.device)
        _guard.launch(lib, "head_conv_bwd", x.device, x.data_ptr(), gy.data_ptr(),
                      w1n.data_ptr(), b1.data_ptr(), w2n.data_ptr(), gx.data_ptr(),
                      partials.data_ptr(), params.data_ptr(), blocks, *x.shape,
                      kernel="head_conv_bwd")
    w1_end, b1_end = HIDDEN * TAPS, HIDDEN * (TAPS + 1)
    return (gx, params[:w1_end].view(W1_SHAPE), params[w1_end:b1_end],
            params[b1_end:-1].view(W2_SHAPE), params[-1:])


class _HeadConv(torch.autograd.Function):
    """K4-fwd with K4-bwd as its VJP; saves only the maps and the weights."""

    @staticmethod
    def forward(ctx, x, w1n, b1, w2n, b2):
        ctx.save_for_backward(x, w1n, b1, w2n)
        return _launch(x, w1n, b1, w2n, b2)

    @staticmethod
    def backward(ctx, gy):
        x, w1n, b1, w2n = ctx.saved_tensors
        grads = head_conv_cuda_bwd(x, gy.contiguous(), w1n, b1, w2n)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def head_conv_cuda(x_bhw: torch.Tensor, w1n: torch.Tensor, b1: torch.Tensor,
                   w2n: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch K4-fwd on contiguous f32 CUDA maps (B×H'×W') with the normalised
    weights (16×1×3×3, 1×16×3×3) and biases (16, 1); returns B×H'×W' logits.
    Its autograd backward launches K4-bwd."""
    return _HeadConv.apply(x_bhw, w1n, b1, w2n, b2)
