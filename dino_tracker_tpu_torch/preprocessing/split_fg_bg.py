"""Split trajectories into foreground and background by the mask value at
each trajectory's first valid frame: a numpy copy of
``dino_tracker_tpu/preprocessing/split_fg_bg.py`` (reference
preprocessing/split_trajectories_to_fg_bg.py:55-78)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def trajectory_start_indices(trajectories_nt2: np.ndarray) -> np.ndarray:
    """First valid (non-NaN) timestep of each trajectory."""
    valid = ~np.isnan(trajectories_nt2).any(axis=-1)  # N×T
    return np.argmax(valid, axis=1)


def split_fg_bg(trajectories_nt2: np.ndarray, masks_thw: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """N×T×2 (x, y) trajectories and T×H×W masks -> (fg, bg) trajectories:
    fg where the mask is > 0 at the rounded, clipped start point."""
    starts = trajectory_start_indices(trajectories_nt2)
    n = trajectories_nt2.shape[0]
    pts = trajectories_nt2[np.arange(n), starts]  # N×2
    pts = np.round(np.nan_to_num(pts)).astype(np.int64)
    h, w = masks_thw.shape[1:]
    xi = np.clip(pts[:, 0], 0, w - 1)
    yi = np.clip(pts[:, 1], 0, h - 1)
    is_fg = masks_thw[starts, yi, xi] > 0
    return trajectories_nt2[is_fg], trajectories_nt2[~is_fg]
