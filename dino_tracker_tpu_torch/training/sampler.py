"""Trajectory point-pair sampler (port of dino_tracker_tpu/training/sampler.py;
reference DinoTrackerSampler, data/dataset.py:56-258).

Trajectories live on the device as N×T×2 coords plus an N×T validity mask
(NaNs decomposed once at load). Each step draws ``num_frames`` random
frames, keeps trajectories visible in at least 2 of them (bounded rejection:
32 tries, then a fallback), picks ``batch`` trajectories uniformly without
replacement (Gumbel top-k) and 2 visible frames of each (Gumbel top-2 over
the visibility mask == multinomial without replacement). Randomness comes
from the ``torch.Generator`` passed in; the streams differ from JAX's, so
tests hold the sampler to invariants.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import device_constant
from .losses import gumbel

MAX_FRAME_TRIES = 32


class TrajectoryBank(NamedTuple):
    """Device-resident trajectories: coords (NaNs replaced by 0) + validity."""
    coords: torch.Tensor  # N×T×2 float32
    valid: torch.Tensor   # N×T bool, True where the trajectory exists
    count: int            # number of real rows (the rest is padding)


def build_bank(trajectories_nt2: np.ndarray, pad_to: int = None,
               device=None) -> TrajectoryBank:
    """Drop trajectories with < 2 valid frames (reference
    data/dataset.py:100-106), replace NaNs, optionally pad rows to a fixed
    size, and move the bank to ``device``."""
    valid = ~np.isnan(trajectories_nt2).any(axis=-1)
    keep = valid.sum(axis=1) > 1
    traj = np.nan_to_num(trajectories_nt2[keep], nan=0.0).astype(np.float32)
    valid = valid[keep]
    n = traj.shape[0]
    if pad_to is not None and pad_to > n:
        t = traj.shape[1]
        traj = np.concatenate([traj, np.zeros((pad_to - n, t, 2), np.float32)])
        valid = np.concatenate([valid, np.zeros((pad_to - n, t), bool)])
    return TrajectoryBank(torch.as_tensor(traj, device=device),
                          torch.as_tensor(valid, device=device), n)


class SampledPoints(NamedTuple):
    t1_points: torch.Tensor  # B×3 (x, y, t) pixel coords + absolute frame
    t2_points: torch.Tensor  # B×3


def _eligible(bank: TrajectoryBank, frame_idx):
    """Rows visible in >= 2 of the frames (frame_idx [..., F]) -> N×[...]."""
    row_valid = torch.arange(bank.valid.shape[0],
                             device=bank.valid.device) < bank.count
    vis = bank.valid[:, frame_idx].sum(-1) >= 2
    return vis & row_valid.reshape(-1, *([1] * (vis.dim() - 1)))


def _sample_bank(generator, bank: TrajectoryBank, num_frames: int,
                 batch: int) -> SampledPoints:
    n, t = bank.valid.shape
    dev = bank.valid.device
    if batch == 0:
        z = torch.zeros((0, 3), device=dev)
        return SampledPoints(z, z)
    if n == 0:
        raise ValueError("cannot sample from an empty trajectory bank — "
                         "use resolve_fg_batch to route the quota to the "
                         "non-empty bank")
    # Bounded rejection, as the JAX while_loop: the first of 32 frame draws
    # with >= 2 eligible rows, else the last draw. All 32 draws are made at
    # once and chosen on the device, so sampling needs no host sync.
    g = gumbel((MAX_FRAME_TRIES, t), generator, dev)
    tries = torch.topk(g, num_frames, dim=1).indices          # 32×F
    eligible_all = _eligible(bank, tries)                     # N×32
    counts = eligible_all.sum(0)
    ok = counts >= 2
    pick = torch.where(ok.any(), torch.argmax(ok.int()), MAX_FRAME_TRIES - 1)[None]
    # index_select, not tries[pick]: indexing with a 0-dim CUDA tensor reads
    # it back to the host
    frame_idx = tries.index_select(0, pick)[0]
    eligible = eligible_all.index_select(1, pick)[:, 0]
    # Fallback for a draw with no eligible row: frames from row 0's own
    # visibility (build_bank guarantees every real row has >= 2 valid frames),
    # which makes at least row 0 eligible; otherwise the picks below would be
    # padding rows and invisible frames, feeding (0, 0) coords into the loss.
    g0 = gumbel((t,), generator, dev).masked_fill(~bank.valid[0], -torch.inf)
    fb_idx = torch.topk(g0, num_frames).indices
    fb_eligible = _eligible(bank, fb_idx)
    use_fb = counts.index_select(0, pick)[0] == 0
    frame_idx = torch.where(use_fb, fb_idx, frame_idx)
    eligible = torch.where(use_fb, fb_eligible, eligible)
    n_eligible = eligible.sum()

    # uniform without replacement among eligible trajectories; banks smaller
    # than the batch wrap around (sampling with replacement across tiles)
    k = min(batch, n)
    scores = gumbel((n,), generator, dev).masked_fill(~eligible, -torch.inf)
    traj_idx = torch.topk(scores, k).indices
    # if fewer than k are eligible, trailing picks are not: replace by the best
    traj_idx = torch.where(torch.arange(k, device=dev) < n_eligible, traj_idx,
                           traj_idx[0])
    if k < batch:
        traj_idx = traj_idx.repeat(-(-batch // k))[:batch]

    # multinomial(2, replacement=False) over visibility at the chosen frames
    vis = bank.valid[traj_idx][:, frame_idx]  # B×F
    g = gumbel(vis.shape, generator, dev).masked_fill(~vis, -torch.inf)
    top2 = torch.topk(g, 2, dim=1).indices
    t1, t2 = frame_idx[top2[:, 0]], frame_idx[top2[:, 1]]
    t1_points = torch.cat([bank.coords[traj_idx, t1], t1[:, None].float()], 1)
    t2_points = torch.cat([bank.coords[traj_idx, t2], t2[:, None].float()], 1)
    return SampledPoints(t1_points, t2_points)


class TrainSample(NamedTuple):
    frames_set_t: torch.Tensor          # S absolute frame indices (padded set)
    source_frame_indices: torch.Tensor  # B indices into frames_set_t
    target_frame_indices: torch.Tensor  # B
    t1_points: torch.Tensor             # B×3 (x, y pixel, t normalized to (-1, 1))
    t2_points_normalized: torch.Tensor  # B×3 in (-1, 1)
    target_times: torch.Tensor          # B absolute frames


def resolve_fg_batch(fg_bank: TrajectoryBank, bg_bank: TrajectoryBank,
                     batch_size: int, fg_traj_ratio: float) -> int:
    """Split of the point budget between banks: an empty bank routes its
    quota to the other side (the reference assumes both are non-empty)."""
    if fg_bank.count == 0 and bg_bank.count == 0:
        raise ValueError("both trajectory banks are empty — no flow "
                         "supervision available for this video")
    if fg_bank.count == 0:
        return 0
    if bg_bank.count == 0:
        return batch_size
    return int(batch_size * fg_traj_ratio)


def unique_padded(values: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.unique(values, size=size, fill_value=fill)``: the sorted distinct
    values, padded with ``fill`` to ``size`` entries (values beyond ``size``
    distinct ones are dropped). Fixed shape, no host sync."""
    s = torch.sort(values).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1
    out = torch.full((size + 1,), fill, dtype=values.dtype, device=values.device)
    # repeats and overflow all land in the spare last slot
    out.scatter_(0, torch.where(first & (pos < size), pos, size), s)
    return out[:size]


def sample_batch(generator, fg_bank: TrajectoryBank, bg_bank: TrajectoryBank,
                 batch_size: int, num_frames: int, fg_traj_ratio: float,
                 video_len: int, video_w: int, video_h: int,
                 fg_batch: int = None) -> TrainSample:
    """One training batch (reference DinoTrackerSampler.forward,
    data/dataset.py:233-258). ``frames_set_t`` is padded to 2·num_frames
    entries; fill slots repeat the first frame (harmless extra conv rows)."""
    if fg_batch is None:
        fg_batch = int(batch_size * fg_traj_ratio)
    fg = _sample_bank(generator, fg_bank, num_frames, fg_batch)
    bg = _sample_bank(generator, bg_bank, num_frames, batch_size - fg_batch)
    t1_points = torch.cat([fg.t1_points, bg.t1_points])
    t2_points = torch.cat([fg.t2_points, bg.t2_points])

    t1_abs, t2_abs = t1_points[:, 2].long(), t2_points[:, 2].long()
    frames_sorted = unique_padded(torch.cat([t1_abs, t2_abs]), 2 * num_frames,
                                  video_len)
    # fill slots (value video_len) sit at the end and match no real frame
    source_frame_indices = torch.searchsorted(frames_sorted, t1_abs)
    target_frame_indices = torch.searchsorted(frames_sorted, t2_abs)
    frames_set_t = torch.where(frames_sorted >= video_len, frames_sorted[0],
                               frames_sorted)

    normalizer = device_constant((video_w - 1, video_h - 1, video_len - 1),
                                 torch.float32, t1_points.device)
    t1_norm = 2.0 * t1_points / normalizer - 1.0
    t2_norm = 2.0 * t2_points / normalizer - 1.0
    # the reference keeps t1 x/y in pixels but normalizes its t (dataset.py:246)
    t1_out = torch.cat([t1_points[:, :2], t1_norm[:, 2:3]], 1)
    return TrainSample(frames_set_t, source_frame_indices,
                       target_frame_indices, t1_out, t2_norm, t2_points[:, 2])


class BankRotator:
    """Host-RAM trajectory windowing for long videos (reference
    ``keep_traj_in_cpu`` / ``load_next_batch``, data/dataset.py:70-131): the
    full sets stay in host RAM and fixed-size windows, padded to the window
    size, rotate onto the device. ``advance`` writes the next window into the
    tensors of the banks ``current`` handed out, so a train step captured as
    a CUDA graph (``step_graph.py``) reads the new window."""

    def __init__(self, fg_trajectories: np.ndarray, bg_trajectories: np.ndarray,
                 window: int = 200_000, device=None):
        self.window = window
        self.device = device
        self._fg = self._prep(fg_trajectories)
        self._bg = self._prep(bg_trajectories)
        self._fg_idx = 0
        self._bg_idx = 0
        self._banks = None

    @staticmethod
    def _prep(traj):
        valid = ~np.isnan(traj).any(axis=-1)
        return traj[valid.sum(axis=1) > 1]

    def _window(self, traj, start, device):
        n = traj.shape[0]
        if n > self.window:
            traj = traj[(start + np.arange(self.window)) % n]
        return build_bank(traj, pad_to=self.window, device=device)

    def current(self):
        """The (fg, bg) banks of the current window on the device."""
        if self._banks is None:
            self._banks = (self._window(self._fg, self._fg_idx, self.device),
                           self._window(self._bg, self._bg_idx, self.device))
        return self._banks

    def advance(self):
        """Rotate to the next window (reference ``load_next_batch``), copied
        into the current banks' tensors; returns those banks. A window holds
        as many rows as the one before, so the counts stay."""
        self._fg_idx = (self._fg_idx + self.window) % max(self._fg.shape[0], 1)
        self._bg_idx = (self._bg_idx + self.window) % max(self._bg.shape[0], 1)
        if self._banks is None:
            return self.current()
        for bank, traj, start in zip(self._banks, (self._fg, self._bg),
                                     (self._fg_idx, self._bg_idx)):
            new = self._window(traj, start, None)
            bank.coords.copy_(new.coords)
            bank.valid.copy_(new.valid)
        return self._banks
