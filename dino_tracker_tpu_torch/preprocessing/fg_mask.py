"""Foreground masks from DINO-feature PCA, on the features' device (port of
``dino_tracker_tpu/preprocessing/fg_mask.py``).

L2-normalize every frame's patch features, project them onto the top-3
principal directions of the exact covariance (``eigh``), min-max-normalize,
orient the first component so the image border (≈ background) carries the
high values, threshold it (< ``fg_mask_threshold`` ⇒ foreground) and
upsample nearest by floor index to the video resolution. The reference's
``torch.pca_lowrank`` is randomized and its sign depends on its RNG; the
exact eigendecomposition plus the border rule removes that, as the JAX
package does. The covariance GEMM is f32 with TF32 held off on CUDA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.nn import exact_f32_matmuls


def pca_project(features_nc: torch.Tensor, q: int = 3):
    """(n×q projections of the uncentered features onto the top-q principal
    directions of the centered ones, V c×q), as ``torch.pca_lowrank`` +
    ``features @ V`` (reference create_fg_mask.py:29-31)."""
    centered = features_nc - features_nc.mean(dim=0, keepdim=True)
    with exact_f32_matmuls(features_nc):
        cov = centered.T @ centered
        _, evecs = torch.linalg.eigh(cov)  # ascending eigenvalues
        v = evecs.flip(-1)[:, :q]
        return features_nc @ v, v


def first_component(features_tchw: torch.Tensor, q: int = 3) -> torch.Tensor:
    """The min-max-normalized, border-oriented first PCA component, T×h'×w'
    f32 on the features' device."""
    t, c, hp, wp = features_tchw.shape
    feats = features_tchw.float().permute(0, 2, 3, 1).reshape(-1, c)
    feats = feats / feats.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    colors, _ = pca_project(feats, q)
    cmin, cmax = colors.min(dim=0).values, colors.max(dim=0).values
    comp0 = ((colors - cmin) / (cmax - cmin))[:, 0].reshape(t, hp, wp)
    border = torch.cat([comp0[:, 0, :].reshape(-1), comp0[:, -1, :].reshape(-1),
                        comp0[:, :, 0].reshape(-1), comp0[:, :, -1].reshape(-1)])
    return 1.0 - comp0 if border.mean() < comp0.mean() else comp0


def compute_fg_masks(features_tchw: torch.Tensor, out_hw: Tuple[int, int],
                     fg_mask_threshold: float = 0.6, q: int = 3) -> torch.Tensor:
    """T×C×h'×w' features -> T×H×W float32 {0, 1} masks on their device."""
    comp0 = first_component(features_tchw, q)
    fg = (comp0 < fg_mask_threshold).float()
    (h, w), (hp, wp) = out_hw, comp0.shape[1:]
    ys = torch.arange(h, device=fg.device) * hp // h  # floor(i·h'/H)
    xs = torch.arange(w, device=fg.device) * wp // w
    return fg[:, ys][:, :, xs]
