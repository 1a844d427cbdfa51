"""Coordinate systems and normalizers (port of dino_tracker_tpu/utils/coords.py).

Pixel coords (x, y) in the model-resolution video; normalized coords, affine
per axis over [0, size-1]; and the ViT feature grid, whose patch centers sit
at ``patch/2 + k*stride`` pixels. The arithmetic follows the JAX functions
operation for operation, so f32 results agree bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def make_range_normalizer(shapes: Sequence[float], device=None) -> torch.Tensor:
    """shapes = (W, H[, T]); returns the per-dim scale ``size - 1`` (f32)."""
    return torch.tensor(shapes, dtype=torch.float32, device=device) - 1.0


def normalize_range(x: torch.Tensor, normalizer: torch.Tensor, dst=(0.0, 1.0),
                    dims=(0, 1, 2)) -> torch.Tensor:
    """Affine-map the ``dims`` entries of x's last axis from [0, size-1] to
    ``dst``; other entries pass through."""
    d = x.shape[-1]
    sel = torch.zeros(d, dtype=torch.bool, device=x.device)
    sel[list(dims)] = True
    norm = torch.where(sel, normalizer[:d], 1.0)
    scale = torch.where(sel, (dst[1] - dst[0]) / norm, 1.0).to(x.dtype)
    off = torch.where(sel, dst[0], 0.0).to(x.dtype)
    return x * scale + off


def vit_grid_affine(h: int, w: int, patch_size: int = 14, stride: int = 7):
    """(a, b) per axis such that ``a*px + b`` maps pixel coords onto the
    feature grid's [-1, 1] range (first patch center -> -1, last -> 1)."""
    half = patch_size / 2.0
    last_h = ((h - patch_size) // stride) * stride + half
    last_w = ((w - patch_size) // stride) * stride + half
    ah = 2.0 / (last_h - half)
    aw = 2.0 / (last_w - half)
    bh = 1.0 - last_h * 2.0 / (last_h - half)
    bw = 1.0 - last_w * 2.0 / (last_w - half)
    return (aw, ah), (bw, bh)


def normalize_points_for_sampling(points: torch.Tensor, h: int, w: int,
                                  patch_size: int = 14,
                                  stride: int = 7) -> torch.Tensor:
    """[..., 3] (x, y, t) pixel points -> feature-grid [-1, 1] x/y; t passes."""
    (aw, ah), (bw, bh) = vit_grid_affine(h, w, patch_size, stride)
    a = torch.tensor([aw, ah, 1.0], dtype=points.dtype, device=points.device)
    b = torch.tensor([bw, bh, 0.0], dtype=points.dtype, device=points.device)
    return points * a + b


def vit_feature_coords(h: int, w: int, stride: int = 7, patch_size: int = 14,
                       device=None) -> torch.Tensor:
    """Patch-center pixel coords of the feature grid, flattened row-major to
    N×2 (x, y) (JAX utils/coords.py:88-97; arange end ``size - half + 1``)."""
    half = patch_size // 2
    x = torch.arange(half, w - half + 1, stride, dtype=torch.float32,
                     device=device)
    y = torch.arange(half, h - half + 1, stride, dtype=torch.float32,
                     device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def soft_argmax_pixel_grid(video_h: int, video_w: int, patch_size: int = 14,
                           step: int = 7, device=None) -> torch.Tensor:
    """H'×W'×2 (x, y) patch-center pixel grid of the head's soft-argmax
    (reference tracker_head.py:68-77 bounds)."""
    h_start = w_start = patch_size // 2
    h_end = ((video_h - 2 * h_start) // step) * step + h_start + math.ceil(step / 2)
    w_end = ((video_w - 2 * w_start) // step) * step + w_start + math.ceil(step / 2)
    ys = torch.arange(h_start, h_end, step, dtype=torch.float32, device=device)
    xs = torch.arange(w_start, w_end, step, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def bb_meshgrid(h: int, w: int, stride: int = 7, patch_size: int = 14,
                device=None) -> torch.Tensor:
    """Best-buddy patch-center grid, N×2 (x, y) row-major (JAX
    utils/coords.py:99-106): ``vit_feature_coords`` with the arange end at
    ``size`` (reference preprocessing_dino_bb/dino_bb_utils.py:5-15), so at
    sizes whose sides minus the patch are not multiples of the stride it has
    more points than the feature grid."""
    half = patch_size // 2
    x = torch.arange(half, w, stride, dtype=torch.float32, device=device)
    y = torch.arange(half, h, stride, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
