"""Trajectory + occlusion inference (port of
dino_tracker_tpu/inference/infer.py).

Given the trained model and the cached refined feature stack:
  1. track every query point to all T frames;
  2. cosine similarity of the trajectory's features vs the query feature;
  3. anchor re-tracking: every trajectory point re-predicted onto each of
     its query's visible frames (cos >= the anchor threshold);
  4. occlusion: occluded iff the masked median anchor distance exceeds its
     max over visible frames, or cos < the cosine threshold.

Predictions go through the multi-target path (one correlation pass per
source, K targets). The JAX package padded query rows to multiples of 32 and
anchors to the buckets {8, 16, 32, T} only so XLA programs could be reused;
padded rows and anchors were sliced off or masked, so dropping them leaves
the results unchanged. ``chunk`` bounds predictions per dispatch and
``corr_budget_bytes`` the B×T×hw correlation working set.

With a ``mesh`` (``parallel/mesh.py``) the prediction rows shard over the
ranks, as the JAX package shards its flat query×frame batch: the first pass
and the anchor re-tracking (most of a request) run each rank's share and
gather the rows back; the cosine similarities and the occlusion rule run on
every rank, so every rank returns the same answer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import TrackerConfig
from ..models import tracker
from ..parallel import mesh as mesh_lib
from ..utils import coords as coord_utils


@dataclasses.dataclass
class ModelInference:
    """Inference over a trained model + the cached refined stack.

    ``refined_features`` is the channels-last T×h'×w'×C f32 stack of
    ``tracker.cache_refined_embeddings``, the only resident copy."""

    model: tracker.Tracker
    refined_features: torch.Tensor
    cfg: TrackerConfig
    anchor_cosine_similarity_threshold: float = 0.5
    cosine_similarity_threshold: float = 0.5
    chunk: int = 4096
    # cap on the B×T×h'w' f32 correlation intermediate per dispatch
    corr_budget_bytes: int = 2 << 30
    mesh: Optional[mesh_lib.Mesh] = None  # shard the prediction rows

    def __post_init__(self):
        t, h, w, _ = self.refined_features.shape
        max_chunk = max(256, int(self.corr_budget_bytes / (t * h * w * 4)))
        self.chunk = min(self.chunk, max_chunk)
        self.device = self.refined_features.device
        self._view = tracker.make_frame_view(self.refined_features,
                                             self.cfg.torch_compute_dtype)
        self._scale = torch.tensor([self.cfg.video_w - 1, self.cfg.video_h - 1],
                                   dtype=torch.float32, device=self.device)

    def _multi_chunk(self, k: int) -> int:
        """Sources per dispatch: bound B×T×hw ``corr_all`` (plus head
        temporaries) by the budget and B·K by ``chunk``."""
        t, h, w, _ = self.refined_features.shape
        by_budget = int(self.corr_budget_bytes / ((t + 24) * h * w * 4))
        return max(1, min(by_budget, self.chunk // k))

    @torch.no_grad()
    def _predict_multi_chunked(self, source_points: torch.Tensor,
                               source_frames: torch.Tensor,
                               target_frames_bk: torch.Tensor) -> torch.Tensor:
        """B×3 pixel (x, y, ·) + B×K target frames -> B×K×2 pixel coords;
        with a mesh, each rank predicts its share of the B rows."""
        b, k = target_frames_bk.shape
        first, stop = mesh_lib.row_range(b, self.mesh)
        chunk = self._multi_chunk(k)
        outs = [torch.zeros((0, k, 2), device=self.device)]
        for s in range(first, stop, chunk):
            e = min(s + chunk, stop)
            out = tracker.get_point_predictions_multi_target(
                self.model, source_points[s:e], source_frames[s:e],
                target_frames_bk[s:e], self.refined_features, self.cfg,
                view=self._view)
            outs.append((out + 1.0) * 0.5 * self._scale)
        return mesh_lib.all_gather_rows(torch.cat(outs, dim=0), self.mesh, b)

    def compute_trajectories(self, query_points: torch.Tensor) -> torch.Tensor:
        """query_points N×3 (x, y, t) -> trajectories N×T×3 (x, y, t)."""
        q = query_points.to(self.device, torch.float32)
        n = q.shape[0]
        t = self.refined_features.shape[0]
        frames = torch.arange(t, device=self.device)
        coords = self._predict_multi_chunked(q, q[:, 2].long(),
                                             frames.expand(n, t))
        times = frames.float()[None, :, None].expand(n, t, 1)
        return torch.cat([coords, times], dim=-1)

    @torch.no_grad()
    def compute_trajectory_cos_sims(self, trajectories: torch.Tensor,
                                    query_points: torch.Tensor) -> torch.Tensor:
        """N×T cosine similarity between each trajectory point's feature and
        its query-frame feature (reference model_inference.py:110-126)."""
        n, t = trajectories.shape[:2]
        cfg = self.cfg
        norm = coord_utils.normalize_points_for_sampling(
            trajectories.reshape(n * t, -1), cfg.video_h, cfg.video_w,
            cfg.dino_patch_size, cfg.stride)
        feats = tracker.sample_embeddings(self.refined_features, norm)
        feats = feats.reshape(n, t, -1)  # N×T×C
        qframes = query_points[:, 2].to(self.device).long()
        qf = feats[torch.arange(n, device=self.device), qframes]  # N×C
        num = torch.einsum("ntc,nc->nt", feats, qf)
        den = (torch.linalg.vector_norm(feats, dim=-1)
               * torch.linalg.vector_norm(qf, dim=-1)[:, None])
        # torch cosine_similarity clamps the denominator at eps=1e-8
        return num / torch.clamp(den, min=1e-8)

    def compute_anchor_trajectories(self, trajectories: torch.Tensor,
                                    cos_sims: torch.Tensor):
        """G[q, a, t] = trajectory point (q, t) re-tracked onto anchor frame
        ``anchor_idx[q, a]`` (reference _get_model_preds_at_anchors:130-154).

        Anchors are each query's visible frames (cos >= threshold, reference
        model_inference.py:160-163), gathered in frame order onto an axis of
        the largest visible count A; padded slots repeat the row's first
        anchor and are masked by ``anchor_valid``.

        Returns (G N×A×T×2, anchor_idx N×A long, anchor_valid N×A bool).
        """
        n, t = trajectories.shape[:2]
        visible = cos_sims >= self.anchor_cosine_similarity_threshold
        a = max(int(visible.sum(1).max()), 1)
        # a stable sort of the invisible flags puts visible frames first, in
        # frame order
        order = torch.argsort((~visible).to(torch.uint8), dim=1,
                              stable=True)[:, :a]
        anchor_valid = torch.gather(visible, 1, order)
        anchor_idx = torch.where(anchor_valid, order, order[:, :1])

        # sources are the N·T trajectory points, each re-predicted onto its
        # query's A anchor frames: one multi-target row per trajectory point
        src = trajectories.reshape(-1, 3)
        anchors = anchor_idx[:, None, :].expand(n, t, a).reshape(-1, a)
        coords = self._predict_multi_chunked(src, src[:, 2].long(), anchors)
        coords = coords.reshape(n, t, a, 2).transpose(1, 2)  # N×A×T×2
        return coords, anchor_idx, anchor_valid

    def compute_occlusion(self, trajectories: torch.Tensor,
                          cos_sims: torch.Tensor,
                          anchor_trajectories: torch.Tensor,
                          anchor_idx: torch.Tensor,
                          anchor_valid: torch.Tensor) -> torch.Tensor:
        """Masked-median occlusion rule (reference model_inference.py:169-200)
        over the anchor axis of :meth:`compute_anchor_trajectories`.
        Returns N×T bool."""
        visible = cos_sims >= self.anchor_cosine_similarity_threshold  # N×T
        src = trajectories[:, :, :2]
        traj_at_anchor = torch.gather(
            src, 1, anchor_idx[:, :, None].expand(-1, -1, 2))  # N×A×2
        # dists[q, a, t] = ||G[q, a, t] - traj[q, anchor_idx[q, a]]||
        dists = torch.linalg.vector_norm(
            anchor_trajectories - traj_at_anchor[:, :, None, :], dim=-1)

        def masked_median(x, mask):
            """torch.median semantics (lower middle) over masked entries."""
            mask = mask.expand_as(x)  # gather below does not broadcast
            s = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
            cnt = mask.sum(-1)
            idx = torch.clamp((cnt - 1) // 2, min=0)
            med = torch.gather(s, -1, idx[..., None])[..., 0]
            return torch.where(cnt > 0, med, torch.inf)

        med_over_anchors = masked_median(dists.transpose(1, 2),
                                         anchor_valid[:, None, :])  # N×T
        med_at_visible = torch.where(visible, med_over_anchors, -torch.inf)
        th = med_at_visible.max(dim=-1, keepdim=True).values  # N×1
        return (med_over_anchors > th) | (
            cos_sims < self.cosine_similarity_threshold)

    def infer(self, query_points) -> Tuple[np.ndarray, np.ndarray]:
        """Query points N×3 (x, y, t) pixel -> (trajectories N×T×2 pixel,
        occlusions N×T bool), as numpy arrays."""
        qp = torch.as_tensor(np.asarray(query_points, np.float32),
                             device=self.device)
        trajs = self.compute_trajectories(qp)
        cos_sims = self.compute_trajectory_cos_sims(trajs, qp)
        anchors, anchor_idx, anchor_valid = self.compute_anchor_trajectories(
            trajs, cos_sims)
        occ = self.compute_occlusion(trajs, cos_sims, anchors, anchor_idx,
                                     anchor_valid)
        return trajs[:, :, :2].cpu().numpy(), occ.cpu().numpy()
