"""Tracker core: refined embeddings -> correlation maps -> coordinates
(port of dino_tracker_tpu/models/tracker.py).

Frame embeddings are channels-last (N×h'×w'×C) everywhere here: sampling
gathers C-wide rows and the correlations contract C as the minor axis of both
GEMM operands. The feature artifact and video keep their public layouts,
T×C×h'×w' (f16) and T×3×H×W.

Correlation GEMMs with bf16 operands must return f32 without rounding the
result to bf16 (JAX: ``preferred_element_type=f32``). A bf16 torch.matmul
rounds its output to bf16, so the frame view keeps the bf16-rounded operand
in f32 and the product runs in f32: products of bf16 values are exact in
f32, which matches the JAX numerics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .delta_dino import DeltaDINO
from .tracker_head import TrackerHead
from ..config import TrackerConfig
from ..parallel import mesh as mesh_lib
from ..utils import coords as coord_utils
from ..utils.profiling import step_span
from ..utils.sampling import sample_feature_video_thwc

EPS = 1e-8


class Tracker(nn.Module):
    """The trained per-video model: DeltaDINO refiner + tracker head."""

    def __init__(self, cfg: TrackerConfig):
        super().__init__()
        self.delta_dino = DeltaDINO(cfg.delta_channels)
        self.tracker_head = TrackerHead()

    def reset_parameters(self, generator: torch.Generator):
        """Training init from ``generator`` (JAX ``init_tracker``): DeltaDINO
        first, then the head."""
        self.delta_dino.reset_parameters(generator)
        self.tracker_head.reset_parameters(generator)

    def head(self, corr_maps_b1hw: torch.Tensor, cfg: TrackerConfig):
        with step_span("train/step/head"):  # a part of the train step's terms
            return self.tracker_head(corr_maps_b1hw, (cfg.video_h, cfg.video_w),
                                     cfg.dino_patch_size, cfg.stride,
                                     cfg.argmax_radius)


def _gather_frames(x_tchw: torch.Tensor, frames_set_t: torch.Tensor):
    return x_tchw.index_select(0, frames_set_t)


def get_refined_embeddings(model: Tracker, video_tchw: torch.Tensor,
                           dino_embed_tchw: torch.Tensor,
                           frames_set_t: torch.Tensor, cfg: TrackerConfig,
                           mesh=None):
    """(refined, raw) for the frame set: refined = raw DINO + DeltaDINO
    residual, both channels-last N×h'×w'×C f32. The feature stack enters in
    its artifact layout (T×C×h'×w', f16 or f32); the gathered frames upcast
    here (f16→f32 is exact). In train mode (``model.train()``) BN uses batch
    statistics and updates its running buffers once.

    With a ``mesh`` of W ranks the frame set shards over them, as the JAX
    package's ``constrain_batch`` shards it: each rank runs DeltaDINO on its
    share (BN statistics over all of them) and every rank gets the whole
    residual stack back (``all_gather_rows``, whose backward sums the ranks'
    cotangents), so everything after the refiner sees every frame."""
    raw = _gather_frames(dino_embed_tchw, frames_set_t).float().permute(0, 2, 3, 1)
    local = mesh_lib.split_rows(frames_set_t, mesh)
    if local.shape[0] == 0:
        raise ValueError(f"{frames_set_t.shape[0]} frames cannot give each of "
                         f"{mesh_lib.world_size(mesh)} ranks one")
    residual = model.delta_dino(
        _gather_frames(video_tchw, local), cfg.feat_hw, vit_stride=cfg.stride,
        vit_patch_size=cfg.dino_patch_size,
        compute_dtype=cfg.torch_compute_dtype, channels_last=True, mesh=mesh)
    residual = mesh_lib.all_gather_rows(residual, mesh, frames_set_t.shape[0])
    return raw + residual, raw


@torch.no_grad()
def cache_refined_embeddings(model: Tracker, video_tchw: torch.Tensor,
                             dino_embed_tchw: torch.Tensor, cfg: TrackerConfig,
                             frames_chunk: int = 16, mesh=None) -> torch.Tensor:
    """Inference-time cache: refined features of ALL frames, eval-mode BN,
    channels-last T×h'×w'×C f32. Chunked over frames to bound activation
    memory; the last chunk is simply shorter (BN in eval is per frame). With
    a ``mesh`` each rank refines its share of the frames (uneven as
    ``torch.tensor_split``; a rank may have none) and every rank gets the
    whole stack."""
    if model.training:
        raise ValueError("cache_refined_embeddings needs model.eval()")
    t = video_tchw.shape[0]
    first, stop = mesh_lib.row_range(t, mesh)
    hp, wp = cfg.feat_hw
    out = torch.empty((stop - first, hp, wp, dino_embed_tchw.shape[1]),
                      dtype=torch.float32, device=video_tchw.device)
    for start in range(first, stop, frames_chunk):
        idx = torch.arange(start, min(start + frames_chunk, stop),
                           device=video_tchw.device)
        out[start - first:start - first + len(idx)] = get_refined_embeddings(
            model, video_tchw, dino_embed_tchw, idx, cfg)[0]
    return mesh_lib.all_gather_rows(out, mesh, t)


def sample_embeddings(embeddings_nhwc: torch.Tensor,
                      points_b3: torch.Tensor) -> torch.Tensor:
    """Trilinear-sample N×h×w×C embeddings at B (x_norm, y_norm, frame_idx)
    points -> B×C."""
    return sample_feature_video_thwc(embeddings_nhwc, points_b3,
                                     normalize_t=True)


class FrameView(NamedTuple):
    """Per-stack tensors shared by every correlation: the GEMM operand
    (N×hw×C, values rounded to the compute dtype, stored f32 so products
    come out in f32) and the f32 norms (N×hw)."""
    flat_cd: torch.Tensor
    norms: torch.Tensor


def make_frame_view(frame_embeddings_nhwc: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32) -> FrameView:
    """Trap (bf16 correlation cotangents): in training the gradient reaches
    the stack through the compute-dtype round trip, whose backward rounds
    the slab's cotangent to bf16 as well; JAX rounds the cotangent of its
    bf16-operand einsums at a different point. bf16 gradients therefore
    agree with JAX only to a stated, looser bound (tests)."""
    n, h, w, c = frame_embeddings_nhwc.shape
    flat = frame_embeddings_nhwc.reshape(n, h * w, c)
    return FrameView(flat.to(compute_dtype).float(),
                     torch.linalg.vector_norm(flat, dim=2))


def _correlate_all(src_bc: torch.Tensor, view: FrameView,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """B×C against every frame -> B×N×hw f32 (``bc,nkc->bnk``)."""
    n, k, c = view.flat_cd.shape
    src = src_bc.to(compute_dtype).float()
    return (src @ view.flat_cd.reshape(n * k, c).T).reshape(-1, n, k)


def get_corr_maps(source_embeddings_bc: torch.Tensor,
                  frame_embeddings_nhwc: torch.Tensor,
                  target_frame_indices_b: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32,
                  view: Optional[FrameView] = None) -> torch.Tensor:
    """Cosine correlation of each source embedding against its target frame
    -> B×1×h×w."""
    _, h, w, _ = frame_embeddings_nhwc.shape
    if view is None:
        view = make_frame_view(frame_embeddings_nhwc, compute_dtype)
    b = source_embeddings_bc.shape[0]
    tgt = target_frame_indices_b.long()
    corr_all = _correlate_all(source_embeddings_bc, view, compute_dtype)
    corr = corr_all[torch.arange(b, device=tgt.device), tgt]  # B×hw
    target_norms = view.norms[tgt]
    source_norms = torch.linalg.vector_norm(source_embeddings_bc, dim=1)[:, None]
    corr = corr / torch.clamp(source_norms * target_norms, min=EPS)
    return corr.reshape(b, 1, h, w)


def _source_points(source_points_b3, source_frame_idx_b, cfg: TrackerConfig):
    pts = coord_utils.normalize_points_for_sampling(
        source_points_b3, cfg.video_h, cfg.video_w, cfg.dino_patch_size,
        cfg.stride)
    return torch.cat([pts[:, :2], source_frame_idx_b[:, None].to(pts.dtype)],
                     dim=1)


def get_point_predictions(model: Tracker, source_points_b3: torch.Tensor,
                          source_frame_idx_b: torch.Tensor,
                          target_frame_idx_b: torch.Tensor,
                          frame_embeddings_nhwc: torch.Tensor,
                          cfg: TrackerConfig,
                          view: Optional[FrameView] = None) -> torch.Tensor:
    """Flat path, one (source, target) pair per row: pixel (x, y, ·) source
    points -> B×2 target coords in (-1, 1). The train step's optical-flow
    term (targets vary per point) and the multi-target oracle; ``view`` is
    the step's shared FrameView of ``frame_embeddings_nhwc``."""
    pts = _source_points(source_points_b3, source_frame_idx_b, cfg)
    src = sample_embeddings(frame_embeddings_nhwc, pts)
    maps = get_corr_maps(src, frame_embeddings_nhwc, target_frame_idx_b,
                         cfg.torch_compute_dtype, view)
    return model.head(torch.relu(maps), cfg)


def get_point_predictions_grouped(model: Tracker, points_gp3: torch.Tensor,
                                  source_frame_idx_g: torch.Tensor,
                                  target_frame_idx_g: torch.Tensor,
                                  frame_embeddings_nhwc: torch.Tensor,
                                  cfg: TrackerConfig,
                                  view: Optional[FrameView] = None,
                                  mesh=None) -> torch.Tensor:
    """Blocked prediction (JAX tracker.py:233-302): group g's P pixel points
    all lie on frame ``source_frame_idx_g[g]`` and re-predict onto
    ``target_frame_idx_g[g]``, so each group correlates against that one
    frame only (a batched G×P×C by G×C×hw GEMM). Returns G×P×2 coords in
    (-1, 1). With a ``mesh`` the point axis P shards over the ranks, as the
    JAX package's ``constrain_axis(..., 1)`` (G is a handful of frame pairs,
    P hundreds of points): each rank predicts its share and gets G×P_r×2."""
    points_gp3 = mesh_lib.split_rows(points_gp3, mesh, dim=1)
    g, p, _ = points_gp3.shape
    _, h, w, c = frame_embeddings_nhwc.shape
    cd = cfg.torch_compute_dtype
    if view is None:
        view = make_frame_view(frame_embeddings_nhwc, cd)
    src_frames = source_frame_idx_g.repeat_interleave(p)
    pts = _source_points(points_gp3.reshape(g * p, 3), src_frames, cfg)
    src = sample_embeddings(frame_embeddings_nhwc, pts).reshape(g, p, c)
    tgt = target_frame_idx_g.long()
    corr = src.to(cd).float() @ view.flat_cd[tgt].transpose(1, 2)  # G×P×hw
    src_norms = torch.linalg.vector_norm(src, dim=2)               # G×P
    corr = corr / torch.clamp(src_norms[..., None] * view.norms[tgt][:, None, :],
                              min=EPS)
    maps = torch.relu(corr).reshape(g * p, 1, h, w)
    return model.head(maps, cfg).reshape(g, p, 2)


def get_point_predictions_multi_target(model: Tracker,
                                       source_points_b3: torch.Tensor,
                                       source_frame_idx_b: torch.Tensor,
                                       target_frames_bk: torch.Tensor,
                                       frame_embeddings_nhwc: torch.Tensor,
                                       cfg: TrackerConfig,
                                       view: Optional[FrameView] = None
                                       ) -> torch.Tensor:
    """One source point -> K target frames, sharing one correlation pass.

    Each source embedding contracts against the frame set once (B×N×hw);
    the K target rows are gathered and the head runs on all B·K maps in one
    batch (the JAX package maps the head over K to bound XLA memory; here the
    caller's chunking bounds B·K). Returns B×K×2 coords in (-1, 1)."""
    b, k = target_frames_bk.shape
    _, h, w, _ = frame_embeddings_nhwc.shape
    cd = cfg.torch_compute_dtype
    if view is None:
        view = make_frame_view(frame_embeddings_nhwc, cd)
    pts = _source_points(source_points_b3, source_frame_idx_b, cfg)
    src = sample_embeddings(frame_embeddings_nhwc, pts)  # B×C
    corr_all = _correlate_all(src, view, cd)              # B×N×hw
    src_norms = torch.linalg.vector_norm(src, dim=1)      # B

    tgt = target_frames_bk.long()
    rows = torch.arange(b, device=tgt.device)[:, None]
    corr = corr_all[rows, tgt]                            # B×K×hw
    norms = view.norms[tgt]                               # B×K×hw
    corr = corr / torch.clamp(src_norms[:, None, None] * norms, min=EPS)
    maps = torch.relu(corr).reshape(b * k, 1, h, w)
    return model.head(maps, cfg).reshape(b, k, 2)
