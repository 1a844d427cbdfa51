"""NN primitives of the port (conv / batchnorm / blurpool) over NHWC tensors.

Port of dino_tracker_tpu/models/nn.py. Activations are NHWC (N×H×W×C,
contiguous) like the JAX package's compute layout, because the blurpool
kernel reads C-minor rows. A conv views its input as NCHW with channels-last
strides, which cuDNN runs without a layout change, and hands back NHWC.

Parameters live in two small modules, ``Conv`` (OIHW weight, bias) and
``BatchNorm`` (affine weight/bias, running mean/var buffers), so a state_dict
reads like torch's own Conv2d/BatchNorm2d. They are created as an identity
(zero conv, unit-variance BN); ``init_conv_`` draws torch's default conv
init from a generator for training, and trained weights come from a
checkpoint.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import batchnorm as batchnorm_ops
from ..ops import blurpool as blurpool_ops
from ..parallel import mesh as mesh_lib


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))


@torch.no_grad()
def init_conv_(conv: Conv, generator: torch.Generator):
    """torch nn.Conv2d's default init, as the JAX ``kaiming_uniform_conv``
    (``dino_tracker_tpu/models/nn.py:96``): kaiming-uniform(a=√5) weight and
    a uniform bias, both bounded by 1/√fan_in. Drawn on the generator's
    device, weight first."""
    fan_in = conv.weight[0].numel()
    bound = math.sqrt(2.0 / (1.0 + 5.0)) * math.sqrt(3.0 / fan_in)
    bbound = 1.0 / math.sqrt(fan_in)
    for p, b in ((conv.weight, bound), (conv.bias, bbound)):
        u = torch.rand(p.shape, generator=generator, device=generator.device)
        p.copy_(u * (2 * b) - b)


class BatchNorm(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))


@contextlib.contextmanager
def exact_f32(x: torch.Tensor):
    """The port's precision rule: f32 means f32. For an f32 CUDA ``x`` the
    enclosed convs and GEMMs run with TF32 off: cuDNN runs f32 convs in TF32
    by default (``torch.backends.cudnn.allow_tf32``), and cuBLAS f32 GEMMs
    where ``torch.backends.cuda.matmul.allow_tf32`` is set (off by default);
    TF32 keeps ~3 decimal digits, and the JAX reference means f32 by f32.
    The flags are process-wide: not thread-safe."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class _Conv2d(torch.autograd.Function):
    """Stride-1 conv whose backward holds the same TF32 rule as its forward.

    Trap (TF32 in backward convs): a context manager around ``F.conv2d``
    covers the forward only; autograd runs the conv's dgrad and wgrad later,
    after the flag is restored, so an f32 training step on CUDA ran its
    backward convs in TF32. Here the backward calls the convolution backward
    itself, under ``exact_f32``."""

    @staticmethod
    def forward(ctx, x, weight, bias, dilation, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (dilation, padding, bias.shape)
        with exact_f32(x):
            return F.conv2d(x, weight, bias, dilation=dilation, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dilation, padding, bias_shape = ctx.conf
        mask = list(ctx.needs_input_grad[:3])
        with exact_f32(x):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, list(bias_shape), [1, 1], [padding] * 2,
                [dilation] * 2, False, [0, 0], 1, mask)
        return gx, gw, gb, None, None


def conv2d(x_nhwc: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dilation: int = 1, padding: int = 0,
           padding_mode: str = "zeros") -> torch.Tensor:
    """Stride-1 2-D conv, NHWC x OIHW -> NHWC, in x's dtype (bf16 operands
    accumulate in f32 inside cuDNN). ``padding_mode="reflect"`` is torch's
    ReflectionPad2d (edge not repeated), as jnp.pad(mode="reflect")."""
    x = x_nhwc.permute(0, 3, 1, 2)  # logical NCHW, channels-last strides
    if padding and padding_mode == "reflect":
        x = F.pad(x, (padding,) * 4, mode="reflect")
        padding = 0
    elif padding_mode not in ("zeros", "reflect"):
        raise ValueError(f"padding_mode {padding_mode!r}")
    x = x.contiguous(memory_format=torch.channels_last)
    y = _Conv2d.apply(x, weight.to(x.dtype), bias.to(x.dtype), dilation,
                      padding)
    return y.permute(0, 2, 3, 1).contiguous()


def batch_moments(x_nhwc: torch.Tensor, mesh=None):
    """The batch's f32 mean, biased variance (E[x²] − mean², clamped at 0,
    the JAX package's formula) and unbiased variance over the N, H, W axes;
    with a ``mesh`` of more than one rank, each holding its share of the
    batch, of the whole batch: the per-channel sum, sum of squares and
    element count go through one differentiable all-reduce. The plain chain
    and K5 both take their statistics from here, so K5 normalises with the
    chain's bits."""
    xf = x_nhwc.float()
    if mesh_lib.is_parallel(mesh):
        c = xf.shape[-1]
        local = torch.cat([xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2)),
                           xf.new_full((1,), xf.numel() // c)])
        total = mesh_lib.all_reduce_sum(local, mesh)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        return mean, var, var * (n / torch.clamp(n - 1, min=1))
    mean = xf.mean(dim=(0, 1, 2))
    var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
    n = x_nhwc.shape[0] * x_nhwc.shape[1] * x_nhwc.shape[2]
    return mean, var, var * (n / max(n - 1, 1))


def batchnorm(x_nhwc: torch.Tensor, bn: BatchNorm, train: bool,
              momentum: float = 0.1, eps: float = 1e-5, mesh=None, relu: bool = False):
    """torch BatchNorm2d semantics over the N, H, W axes, then a ReLU where
    ``relu``.

    Statistics and the affine transform compute in f32; the output is cast
    back to x's dtype. In train mode the batch's biased variance normalizes
    and the unbiased one enters the running update. With a ``mesh`` of more
    than one rank, each holding its share of the batch, train mode takes the
    statistics of the whole batch (``batch_moments``), so every rank
    normalizes alike and stores the same running statistics (eval mode is
    per sample and needs none). CPU tensors take the plain chain
    (``batchnorm_plain``); CUDA tensors the same statistics and then kernel
    K5 (``ops/batchnorm.py``), which normalises, applies the ReLU and
    differentiates both. Returns (out, (new_mean, new_var)); the caller
    decides whether to store them.
    """
    if x_nhwc.device.type != "cuda":
        return batchnorm_plain(x_nhwc, bn, train, momentum, eps, mesh, relu)
    if train:
        with torch.no_grad():  # K5's backward differentiates through them
            mean, var, unbiased = batch_moments(x_nhwc, mesh)
        new_stats = ((1 - momentum) * bn.running_mean + momentum * mean,
                     (1 - momentum) * bn.running_var + momentum * unbiased)
    else:
        mean, var = bn.running_mean, bn.running_var
        new_stats = (mean, var)
    group = mesh.group if train and mesh_lib.is_parallel(mesh) else None
    out = batchnorm_ops.batchnorm_cuda(x_nhwc, bn.weight, bn.bias, mean, var, train, relu, eps,
                                       group)
    return out, new_stats


def batchnorm_plain(x_nhwc: torch.Tensor, bn: BatchNorm, train: bool,
                    momentum: float = 0.1, eps: float = 1e-5, mesh=None,
                    relu: bool = False):
    """``batchnorm`` as a chain of PyTorch ops on any device, differentiated
    by autograd: the CPU's path and K5's plain version."""
    if train:
        mean, var, unbiased = batch_moments(x_nhwc, mesh)
        new_stats = ((1 - momentum) * bn.running_mean + momentum * mean.detach(),
                     (1 - momentum) * bn.running_var + momentum * unbiased.detach())
    else:
        mean, var = bn.running_mean, bn.running_var
        new_stats = (mean, var)
    inv = torch.rsqrt(var + eps)
    out = ((x_nhwc.float() - mean) * inv * bn.weight + bn.bias).to(x_nhwc.dtype)
    return (torch.relu(out) if relu else out), new_stats


def blurpool(x_nhwc: torch.Tensor, stride: int = 2,
             filt_size: int = 4) -> torch.Tensor:
    """Anti-aliased 2x downsample (antialiased_cnns.BlurPool, filt 4).

    Only the configuration DeltaDINO uses exists; anything else raises (the
    JAX dispatcher, nn.py:274, silently fell through to another form when
    filt != 4 or stride != 2). CPU tensors take the plain version, CUDA
    tensors kernel K1 (ops/blurpool.py)."""
    if filt_size != 4 or stride != 2:
        raise ValueError(f"blurpool supports filt_size=4, stride=2 only, got "
                         f"filt_size={filt_size}, stride={stride}")
    return blurpool_ops.blurpool(x_nhwc)
