"""TrackerHead: correlation-heatmap refinement + masked soft-argmax (port of
dino_tracker_tpu/models/tracker_head.py).

Two spatially-sum-normalized 3×3 convs refine the B×1×H'×W' correlation map;
the softmax heatmap is soft-argmaxed inside a radius-35 px circle centered on
the raw map's hard argmax, on the patch-center pixel grid, and the point is
normalized to (-1, 1). Runs in f32. The convs, their biases and the ReLU
between them dispatch on the device: CPU maps take the plain chain of
``normalized_conv2d`` calls, CUDA maps kernel K4 (``ops/head_conv.py``) with
the normalised weights.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from . import nn as pnn
from ..ops import head_conv
from ..utils import coords as coord_utils

EPS = 1e-8


def normalized_weight(conv: pnn.Conv) -> torch.Tensor:
    """The conv's weights divided by their per-(out, in) spatial sum,
    sign-guarded to ±1e-8 where |sum| < 1e-8 (reference conv_norm.py:34-46)."""
    w = conv.weight  # OIHW
    w_sum = w.sum(dim=(2, 3), keepdim=True)
    w_sum = torch.where(w_sum.abs() < EPS,
                        torch.where(w_sum >= 0, EPS, -EPS), w_sum)
    return w / w_sum


def normalized_conv2d(x_nhwc: torch.Tensor, conv: pnn.Conv) -> torch.Tensor:
    """Conv with ``normalized_weight``."""
    return pnn.conv2d(x_nhwc, normalized_weight(conv), conv.bias,
                      padding=conv.weight.shape[-1] // 2)


def hard_argmax(cost_volume_b1hw: torch.Tensor) -> torch.Tensor:
    """The flat index of each map's first maximum (as ``jnp.argmax``): the
    centre of the soft-argmax window. A module-level function, so a check
    can record or replace the head's choice."""
    return torch.argmax(cost_volume_b1hw.flatten(1), dim=1)


class TrackerHead(nn.Module):
    def __init__(self, in_channels: int = 1, hidden_channels: int = 16,
                 out_channels: int = 1, kernel_size: int = 3):
        super().__init__()
        self.conv1 = pnn.Conv(in_channels, hidden_channels, kernel_size)
        self.conv2 = pnn.Conv(hidden_channels, out_channels, kernel_size)

    def reset_parameters(self, generator: torch.Generator):
        """Training init (JAX ``init_tracker_head``, tracker_head.py:27-36):
        torch-default convs drawn from ``generator``."""
        pnn.init_conv_(self.conv1, generator)
        pnn.init_conv_(self.conv2, generator)

    def forward(self, cost_volume_b1hw: torch.Tensor, video_hw: Tuple[int, int],
                patch_size: int = 14, stride: int = 7,
                argmax_radius: float = 35.0) -> torch.Tensor:
        """cost volume B×1×H'×W' (post-ReLU cosine corr) -> B×2 in (-1, 1)."""
        video_h, video_w = video_hw
        b, _, hp, wp = cost_volume_b1hw.shape
        dev = cost_volume_b1hw.device

        # hard argmax on the RAW map (first maximum, as jnp.argmax)
        argmax_flat = hard_argmax(cost_volume_b1hw)
        row = argmax_flat // wp
        col = argmax_flat % wp

        if dev.type == "cpu":
            x = cost_volume_b1hw.permute(0, 2, 3, 1)
            x = torch.relu(normalized_conv2d(x, self.conv1))
            x = normalized_conv2d(x, self.conv2)
        else:
            x = head_conv.head_conv_cuda(
                cost_volume_b1hw.reshape(b, hp, wp).contiguous(),
                normalized_weight(self.conv1), self.conv1.bias,
                normalized_weight(self.conv2), self.conv2.bias)
        heatmap = torch.softmax(x.reshape(b, hp * wp), dim=-1).reshape(b, hp, wp)

        grid = coord_utils.soft_argmax_pixel_grid(video_h, video_w, patch_size,
                                                  stride, device=dev)
        start = patch_size // 2
        argmax_coord = torch.stack([col * stride + start, row * stride + start],
                                   dim=-1).float()  # B×2
        # squared distances are exact integers on this grid, so comparing
        # them with radius² decides the boundary (e.g. a (3,4)·7 offset at
        # radius 35) exactly as the JAX norm does
        d2 = ((grid[None] - argmax_coord[:, None, None]) ** 2).sum(-1)
        mask = (d2 <= argmax_radius ** 2).to(heatmap.dtype)  # B×H'×W'

        hm = heatmap * mask
        hm_sum = hm.sum(dim=(1, 2))
        # branchless zero-sum fallback: uniform weight inside the mask
        mask_count = mask.sum(dim=(1, 2))
        uniform = mask / torch.clamp(mask_count, min=1.0)[:, None, None]
        zero = hm_sum < 1e-8
        hm = torch.where(zero[:, None, None], uniform, hm)
        hm_sum = torch.where(zero, uniform.sum(dim=(1, 2)), hm_sum)

        point = (grid[None] * hm[..., None]).sum(dim=(1, 2)) / hm_sum[:, None]
        normalizer = coord_utils.make_range_normalizer((video_w, video_h),
                                                       device=dev)
        return coord_utils.normalize_range(point, normalizer, dst=(-1.0, 1.0),
                                           dims=(0, 1))
