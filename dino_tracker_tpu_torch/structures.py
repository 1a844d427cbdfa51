"""Best-buddy correspondences as dense padded tensors (port of
dino_tracker_tpu/structures.py ``BBData`` and ``load_bb_data``).

The reference's ragged per-frame-pair dict becomes arrays that lead with
[T, T, Nmax] plus a validity mask, read from the same ``.npz`` artifact the
JAX preprocessing writes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BBData(NamedTuple):
    """Entry (s, t, k) is the k-th buddy of ordered pair source frame s →
    target frame t."""
    source_coords: torch.Tensor  # T×T×Nmax×2 pixel (x, y)
    target_coords: torch.Tensor  # T×T×Nmax×2
    cos_sims: torch.Tensor       # T×T×Nmax
    r: torch.Tensor              # T×T×Nmax ambiguity ratio (2nd/1st NMS peak)
    valid: torch.Tensor          # T×T×Nmax bool


def load_bb_data(path: str, device=None) -> BBData:
    with np.load(path) as f:
        return BBData(*(torch.as_tensor(np.asarray(f[k]), device=device)
                        for k in BBData._fields))
