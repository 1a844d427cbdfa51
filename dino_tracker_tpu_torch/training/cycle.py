"""Cycle-consistency supervision (port of dino_tracker_tpu/training/cycle.py;
reference models/tracker.py:182-301, dino_tracker.py:346-353).

For random frame pairs, fg/bg-balanced pixel points are tracked source →
target → source with the current model under ``no_grad``; points that come
back within ``cyc_thresh`` px are kept, and both directions are re-predicted
with gradients, weighted by γ^dist. Generation is two steps: the random
point draw (``sample_cycle_points``) and the deterministic
``cycle_data_from_points``, so tests can inject the points. An empty batch
gives a zero loss; it is not resampled.

Trap (one DeltaDINO forward per step): BN running statistics update inside
the forward, so cycle data is computed from the step's refined stack (under
``no_grad``), never from a second DeltaDINO forward.

With a ``mesh`` the per-pair point axis P shards over the ranks (JAX
cycle.py:89,169 and tracker.py:274): the filter's predictions are each
rank's share gathered back, so every rank holds the same ``CycleData``; the
loss sums each rank's share over the global count of survivors, so the
ranks' losses add up to the single-device one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TrackerConfig
from ..models import tracker
from ..parallel import mesh as mesh_lib
from ..utils.constants import device_constant
from . import losses


class CycleData(NamedTuple):
    source_points: torch.Tensor   # P×3 pixel (x, y, t_abs)
    target_points: torch.Tensor   # P×3 pixel (predicted x, y, t_abs), constants
    source_frame_indices: torch.Tensor  # P, into frames_set_t
    target_frame_indices: torch.Tensor  # P
    dists: torch.Tensor           # P cycle distances (px)
    valid: torch.Tensor           # P bool


def sample_cycle_points(generator, frames_set_t, fg_masks_thw, n_pairs: int,
                        points_per_pair: int, fg_ratio: float):
    """The random half of the JAX ``generate_cycle_data``: frame pairs drawn
    over the set (they may collide, as in the reference) and up to
    ``points_per_pair`` distinct pixels of each source frame, fg/bg balanced.
    Returns (src_sel P, tgt_sel P, coords P×K×2 pixel (x, y), valid P×K)."""
    set_size = frames_set_t.shape[0]
    dev = frames_set_t.device
    w = fg_masks_thw.shape[-1]
    n_fg = int(points_per_pair * fg_ratio)
    src_sel = torch.randint(0, set_size, (n_pairs,), generator=generator,
                            device=dev)
    tgt_sel = torch.randint(0, set_size, (n_pairs,), generator=generator,
                            device=dev)
    fg = (fg_masks_thw[frames_set_t[src_sel]] > 0).reshape(n_pairs, -1)
    idx_fg, v_fg = losses.masked_gumbel_topk(generator, fg, n_fg)
    idx_bg, v_bg = losses.masked_gumbel_topk(generator, ~fg,
                                             points_per_pair - n_fg)
    idx = torch.cat([idx_fg, idx_bg], 1)
    coords = torch.stack([(idx % w).float(), (idx // w).float()], -1)
    return src_sel, tgt_sel, coords, torch.cat([v_fg, v_bg], 1)


@torch.no_grad()
def cycle_data_from_points(model, frame_embeddings, frames_set_t,
                           cfg: TrackerConfig, src_sel, tgt_sel, coords,
                           valid, thresh: float, view=None,
                           mesh=None) -> CycleData:
    """The deterministic half: predict the points source → target → source
    with the grouped path (one target frame per pair) and keep those that
    return within ``thresh`` px (JAX cycle.py:68-108)."""
    n_pairs, k, _ = coords.shape
    scale = device_constant((cfg.video_w - 1, cfg.video_h - 1), torch.float32,
                            coords.device)

    def with_t(xy, sel):
        t = frames_set_t[sel].float()[:, None, None].expand(n_pairs, k, 1)
        return torch.cat([xy, t], 2)

    def predict(points, s_idx, t_idx):
        out = tracker.get_point_predictions_grouped(
            model, points, s_idx, t_idx, frame_embeddings, cfg, view=view,
            mesh=mesh)
        out = mesh_lib.all_gather_rows(out, mesh, k, dim=1)
        return (out + 1.0) * 0.5 * scale  # (-1, 1) -> pixel

    source_points = with_t(coords, src_sel)
    target_points = with_t(predict(source_points, src_sel, tgt_sel), tgt_sel)
    bwd = predict(target_points, tgt_sel, src_sel)
    dists = torch.linalg.vector_norm(coords - bwd, dim=2).reshape(-1)
    return CycleData(source_points.reshape(-1, 3), target_points.reshape(-1, 3),
                     src_sel.repeat_interleave(k), tgt_sel.repeat_interleave(k),
                     dists, valid.reshape(-1) & (dists <= thresh))


def generate_cycle_data(generator, model, frame_embeddings, frames_set_t,
                        fg_masks_thw, cfg: TrackerConfig, n_pairs: int,
                        points_per_pair: int, fg_ratio: float, thresh: float,
                        view=None, mesh=None) -> CycleData:
    """Random points, then their cycle filter (JAX ``generate_cycle_data``).
    Every rank draws the same points from its copy of the generator."""
    src_sel, tgt_sel, coords, valid = sample_cycle_points(
        generator, frames_set_t, fg_masks_thw, n_pairs, points_per_pair,
        fg_ratio)
    return cycle_data_from_points(model, frame_embeddings, frames_set_t, cfg,
                                  src_sel, tgt_sel, coords, valid, thresh,
                                  view, mesh)


def cycle_loss_from_preds(both_preds, data: CycleData, cfg: TrackerConfig,
                          gamma: float, huber_delta: float = 1.0 / 32.0,
                          count=None):
    """γ^dist-weighted Huber of the merged source→target and target→source
    predictions (2P×2, in (-1, 1)) against the cycle endpoints; zero when no
    point survived the filter. ``count`` is the number of survivors the
    loss is normalised by (default: those of ``data``; a rank holding a
    share of the points passes the global count)."""
    p = data.source_points.shape[0]
    st, ts = both_preds[:p], both_preds[p:]
    scale = device_constant((cfg.video_w - 1, cfg.video_h - 1), torch.float32,
                            both_preds.device)
    tgt_norm = 2.0 * data.target_points[:, :2] / scale - 1.0
    src_norm = 2.0 * data.source_points[:, :2] / scale - 1.0
    weight = (gamma ** data.dists) * data.valid
    if count is None:
        count = data.valid.sum()
    n = torch.clamp(count, min=1)
    loss_st = (weight[:, None] * losses.huber(st, tgt_norm, huber_delta)).sum() / (2 * n)
    loss_ts = (weight[:, None] * losses.huber(ts, src_norm, huber_delta)).sum() / (2 * n)
    return torch.where(count > 0, (loss_st + loss_ts) / 2.0, 0.0)


def cycle_consistency_loss(model, frame_embeddings, data: CycleData,
                           cfg: TrackerConfig, gamma: float, group_size: int,
                           huber_delta: float = 1.0 / 32.0, view=None,
                           mesh=None):
    """Re-predict both directions with gradients (reference
    dino_tracker.py:346-353). The CycleData rows come in contiguous per-pair
    blocks of ``group_size`` (as ``cycle_data_from_points`` emits them), so
    the grouped path correlates each block against its one target frame.
    With a ``mesh`` each rank takes its share of every block and returns its
    part of the loss (normalised by the global survivor count)."""
    p = data.source_points.shape[0]
    g = p // group_size
    count = data.valid.sum()
    src_g = data.source_frame_indices.reshape(g, group_size)[:, 0]
    tgt_g = data.target_frame_indices.reshape(g, group_size)[:, 0]
    data = CycleData(*(mesh_lib.split_rows(x.reshape(g, group_size, *x.shape[1:]),
                                           mesh, dim=1).reshape(-1, *x.shape[1:])
                       for x in data))
    sp = data.source_points.reshape(g, -1, 3)
    tp = data.target_points.reshape(g, -1, 3)
    both = tracker.get_point_predictions_grouped(
        model, torch.cat([sp, tp]), torch.cat([src_g, tgt_g]),
        torch.cat([tgt_g, src_g]), frame_embeddings, cfg,
        view=view).reshape(-1, 2)
    return cycle_loss_from_preds(both, data, cfg, gamma, huber_delta, count)
