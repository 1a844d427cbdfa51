"""DeltaDINO: the per-video CNN feature refiner (port of
dino_tracker_tpu/models/delta_dino.py).

A 4-layer CNN (3→64→128→256→C, k=5, reflect pad, dilations 1,1,1,2,
blurpool after layers 0-2, total stride 8) whose output is resampled onto the
ViT feature grid and added as a residual to the raw DINO features.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from . import nn as pnn

CHANNELS = (3, 64, 128, 256, 1024)
DILATIONS = (1, 1, 1, 2)
DOWNSAMPLE = (True, True, True, False)
KERNEL_SIZE = 5
DOWN_STRIDE = 2


def total_stride() -> int:
    return DOWN_STRIDE ** sum(DOWNSAMPLE)


class Layer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = pnn.Conv(in_ch, out_ch, KERNEL_SIZE)
        self.bn = pnn.BatchNorm(out_ch)


class DeltaDINO(nn.Module):
    """frames N×3×H×W in [0,1] -> residual N×C×vh×vw (or N×vh×vw×C).

    ``compute_dtype`` is the conv operand dtype; BN statistics and the
    residual stay f32. In train mode BN uses batch statistics and updates
    its running buffers in place (torch's own BatchNorm2d convention), so a
    training step runs the forward once."""

    def __init__(self, channels: Tuple[int, ...] = CHANNELS):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(channels[i], channels[i + 1])
            for i in range(len(channels) - 1))
        # the resample matrices of each (grid sizes, device), uploaded once:
        # an upload in every forward synchronised the host with the card and
        # could not be captured into a CUDA graph
        self._align = {}

    def align_matrices(self, vit_hw, cnn_hw, vit_patch_size: int,
                       vit_stride: int, device: torch.device):
        """``_align_matrices`` for this model, made once per arguments."""
        key = (tuple(vit_hw), tuple(cnn_hw), vit_patch_size, vit_stride, device)
        if key not in self._align:
            self._align[key] = _align_matrices(vit_hw, cnn_hw, vit_patch_size,
                                               vit_stride, total_stride(), device)
        return self._align[key]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Training init (JAX ``init_delta_dino``, delta_dino.py:37-53):
        torch-default convs drawn from ``generator``, the last conv zeroed
        and the last BN's γ=0.05, so training starts from the identity
        refiner; BN running statistics 0 / 1."""
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            pnn.init_conv_(layer.conv, generator)
            if i == last:
                layer.conv.weight.zero_()
                layer.conv.bias.zero_()
            layer.bn.weight.fill_(0.05 if i == last else 1.0)
            layer.bn.bias.zero_()
            layer.bn.running_mean.zero_()
            layer.bn.running_var.fill_(1.0)

    def forward(self, frames_nchw: torch.Tensor, vit_hw: Tuple[int, int],
                vit_stride: int = 7, vit_patch_size: int = 14,
                compute_dtype: torch.dtype = torch.float32,
                channels_last: bool = False, mesh=None) -> torch.Tensor:
        """``mesh``: in train mode, each rank holds its share of the frames
        and BN takes the statistics of all of them (``nn.batchnorm``)."""
        x = frames_nchw.permute(0, 2, 3, 1)
        n_layers = len(self.layers)
        for i, layer in enumerate(self.layers):
            dilation = DILATIONS[i]
            padding = (KERNEL_SIZE + (KERNEL_SIZE - 1) * (dilation - 1)) // 2
            # Every conv feeds a train-mode BN, whose batch-mean subtraction
            # cancels the conv bias exactly: its gradient is zero in exact
            # math, and left attached, Adam would turn the float noise on it
            # into steps of about lr. So the bias is detached in training, as
            # the JAX package's bias_stopgrad (delta_dino.py:147-161).
            bias = layer.conv.bias.detach() if self.training else layer.conv.bias
            x = pnn.conv2d(x.to(compute_dtype), layer.conv.weight, bias,
                           dilation=dilation, padding=padding,
                           padding_mode="reflect")
            x, (mean, var) = pnn.batchnorm(x, layer.bn, train=self.training,
                                           mesh=mesh, relu=i < n_layers - 1)
            if self.training:
                with torch.no_grad():
                    layer.bn.running_mean.copy_(mean)
                    layer.bn.running_var.copy_(var)
            if DOWNSAMPLE[i]:
                x = pnn.blurpool(x, stride=DOWN_STRIDE)
        mats = self.align_matrices(vit_hw, x.shape[1:3], vit_patch_size,
                                   vit_stride, x.device)
        if channels_last:
            return align_cnn_vit_features_nhwc(x, mats)
        return align_cnn_vit_features(x.permute(0, 3, 1, 2), mats)


def _bilinear_axis_matrix(coords_norm, in_size: int) -> np.ndarray:
    """Dense [out, in] linear-interp matrix for normalized coords in [-1,1]
    with grid_sample align_corners=True + border-clip semantics."""
    src = (np.asarray(coords_norm, np.float64) + 1.0) * 0.5 * (in_size - 1)
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = src - lo
    mat = np.zeros((len(src), in_size), np.float32)
    np.add.at(mat, (np.arange(len(src)), lo), 1.0 - w)
    np.add.at(mat, (np.arange(len(src)), hi), w)
    return mat


def _align_matrices(vit_hw, cnn_hw, vit_patch_size, vit_stride, cnn_stride,
                    device):
    """(wy vh×ch, wx vw×cw): the separable resample of CNN features at pixel
    (i, j)·cnn_stride onto ViT patch centers k·vit_stride + patch/2, with the
    reference's extra -1/c_br half-texel shift (models/utils.py:7-45)."""
    vh, vw = vit_hw
    ch, cw = cnn_hw
    c_br = [(ch - 1) * cnn_stride, (cw - 1) * cnn_stride]
    vit_x = np.arange(vw, dtype=np.float64) * vit_stride + vit_patch_size / 2.0
    vit_y = np.arange(vh, dtype=np.float64) * vit_stride + vit_patch_size / 2.0
    gx = -1.0 - (1.0 / c_br[1]) + (2.0 * vit_x / c_br[1])
    gy = -1.0 - (1.0 / c_br[0]) + (2.0 * vit_y / c_br[0])
    wy = torch.from_numpy(_bilinear_axis_matrix(gy, ch)).to(device)
    wx = torch.from_numpy(_bilinear_axis_matrix(gx, cw)).to(device)
    return wy, wx


def align_cnn_vit_features(cnn_features_nchw, matrices):
    """Bilinear-resample N×C×ch×cw CNN features onto the ViT grid (f32) with
    ``matrices``, ``_align_matrices``'s (wy, wx) for their sizes."""
    wy, wx = matrices
    out = torch.einsum("oh,nchw->ncow", wy, cnn_features_nchw.float())
    return torch.einsum("pw,ncow->ncop", wx, out)


def align_cnn_vit_features_nhwc(cnn_features_nhwc, matrices):
    """Channels-last twin: N×ch×cw×C -> N×vh×vw×C (f32)."""
    wy, wx = matrices
    out = torch.einsum("oh,nhwc->nowc", wy, cnn_features_nhwc.float())
    return torch.einsum("pw,nowc->nopc", wx, out)
