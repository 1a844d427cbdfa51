"""Feature, mask and flow sampling (port of dino_tracker_tpu/utils/sampling.py
``sample_feature_video_thwc``, ``bilinear_sampler_pixel`` and the 2-D lookup
the losses use).

Trilinear sampling: torch ``grid_sample`` semantics (align_corners=True,
border clamp) written as row gathers on the (T·H·W)×C view of a channels-last
stack: each point reads eight C-wide rows. With gradients, the backward of
each row gather is a row scatter-add (``index_add``), which on CUDA
accumulates with atomics: sums land in run-dependent order, so two GPU runs
differ from each other and from the CPU in the last bits. Plain tensor
indexing; in the JAX package this was XLA, not a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .constants import device_constant


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    return (coord + 1.0) * 0.5 * (size - 1)  # align_corners=True


def sample_feature_video_thwc(features_thwc: torch.Tensor,
                              points_s3: torch.Tensor,
                              normalize_t: bool = True) -> torch.Tensor:
    """Sample a T×H×W×C stack at S (x, y, t) points -> S×C.

    x/y arrive normalized to [-1, 1]; t is a raw frame index, normalized here
    when ``normalize_t``."""
    t, h, w, c = features_thwc.shape
    x, y, z = points_s3[..., 0], points_s3[..., 1], points_s3[..., 2]
    if normalize_t:
        if t > 1:
            z = z / (t - 1)
        z = z * 2.0 - 1.0
    x = torch.clamp(_unnormalize(x, w), 0.0, w - 1)
    y = torch.clamp(_unnormalize(y, h), 0.0, h - 1)
    z = torch.clamp(_unnormalize(z, t), 0.0, t - 1)

    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = (x - x0)[:, None], (y - y0)[:, None], (z - z0)[:, None]
    flat = features_thwc.reshape(t * h * w, c)

    def corner(zc, yc, xc):
        it = torch.clamp(zc, 0, t - 1).long()
        iy = torch.clamp(yc, 0, h - 1).long()
        ix = torch.clamp(xc, 0, w - 1).long()
        return flat.index_select(0, (it * h + iy) * w + ix)  # S×C row gather

    c00 = corner(z0, y0, x0) * (1 - wx) + corner(z0, y0, x0 + 1) * wx
    c01 = corner(z0, y0 + 1, x0) * (1 - wx) + corner(z0, y0 + 1, x0 + 1) * wx
    c10 = corner(z0 + 1, y0, x0) * (1 - wx) + corner(z0 + 1, y0, x0 + 1) * wx
    c11 = (corner(z0 + 1, y0 + 1, x0) * (1 - wx)
           + corner(z0 + 1, y0 + 1, x0 + 1) * wx)
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def bilinear_sampler_pixel(img_nchw: torch.Tensor,
                           coords_nhw2: torch.Tensor) -> torch.Tensor:
    """The flow-warp sampler (JAX ``utils/sampling.py:226-238``): sample
    N×C×H×W at N×Ho×Wo pixel (x, y) coords -> N×C×Ho×Wo, bilinear, zero
    padding, align_corners=True, after normalising x by W-1 and y by H-1."""
    _, _, h, w = img_nchw.shape
    x = 2 * coords_nhw2[..., 0] / (w - 1) - 1
    y = 2 * coords_nhw2[..., 1] / (h - 1) - 1
    return F.grid_sample(img_nchw, torch.stack([x, y], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def sample_masks_at_points(masks_phw: torch.Tensor, coords_pk2: torch.Tensor,
                           resw: int, resh: int) -> torch.Tensor:
    """Bilinear lookup of P masks (P×H×W) at P×K pixel (x, y) coords -> P×K
    f32, as the reference's ``filter_bb_foreground_pairs`` samples its fg
    mask: ``grid_sample`` with align_corners=False, zero padding, and a /size
    (not /size-1) normalisation (JAX training/losses.py:59-67)."""
    scale = device_constant((resw, resh), coords_pk2.dtype, coords_pk2.device)
    grid = 2.0 * (coords_pk2 / scale) - 1.0
    out = F.grid_sample(masks_phw[:, None].float(), grid[:, None].float(),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[:, 0, 0]
