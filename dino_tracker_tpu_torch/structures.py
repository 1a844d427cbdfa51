"""Best-buddy correspondences as dense padded tensors (port of
dino_tracker_tpu/structures.py).

The reference's ragged per-frame-pair dict becomes arrays that lead with
[T, T, Nmax] plus a validity mask, in the same ``.npz`` artifact (five keys)
the JAX preprocessing writes, so each package reads the other's file.
Fields may be tensors (on any device) or numpy arrays.
"""

from __future__ import annotations

import os
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

    @property
    def num_frames(self) -> int:
        return self.source_coords.shape[0]

    @property
    def capacity(self) -> int:
        return self.source_coords.shape[2]


def empty_bb_data(t: int, capacity: int, device=None) -> BBData:
    return BBData(
        source_coords=torch.zeros((t, t, capacity, 2), device=device),
        target_coords=torch.zeros((t, t, capacity, 2), device=device),
        cos_sims=torch.zeros((t, t, capacity), device=device),
        r=torch.ones((t, t, capacity), device=device),
        valid=torch.zeros((t, t, capacity), dtype=torch.bool, device=device))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_bb_data(path: str, bb: BBData):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: _host(v) for k, v in zip(BBData._fields, bb)})


def load_bb_data(path: str, device=None) -> BBData:
    with np.load(path) as f:
        return BBData(*(torch.as_tensor(np.asarray(f[k]), device=device)
                        for k in BBData._fields))
