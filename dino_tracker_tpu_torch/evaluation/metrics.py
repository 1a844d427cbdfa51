"""TAP-Vid / BADJA evaluation metrics (NumPy): the port's own copy of
``dino_tracker_tpu/evaluation/metrics.py``, with the same arithmetic, so both
packages score saved predictions to the same bits.

Semantics match the official TAP-Vid metric code as used by the reference
(eval/metrics.py:7-147): occlusion accuracy, pts-within-{1,2,4,8,16}px,
Jaccard@δ and their averages, computed in 256×256-rescaled coordinates with
'first' or 'strided' query modes.

NB: the reference's per-video assembly has a known quirk — the query-point
rescale overwrites ``[..., 1]`` *before* computing ``[..., 2]`` from it
(eval/metrics.py:205-206). Strided metrics only consume the query *frame*
(column 0), so results are unaffected; we replicate the clean math and keep
column 0 exact.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np


THRESHOLDS = (1, 2, 4, 8, 16)


def compute_tapvid_metrics(query_points: np.ndarray,
                           gt_occluded: np.ndarray,
                           gt_tracks: np.ndarray,
                           pred_occluded: np.ndarray,
                           pred_tracks: np.ndarray,
                           query_mode: str,
                           get_trackwise_metrics: bool = False
                           ) -> Mapping[str, np.ndarray]:
    """Official TAP-Vid metrics over a [b, n, t] batch in 256×256 coords.

    query_points: [b, n, 3] (t, y, x); gt/pred_occluded: [b, n, t] bool;
    gt/pred_tracks: [b, n, t, 2] (x, y).
    """
    summing_axis = (2,) if get_trackwise_metrics else (1, 2)
    t = gt_tracks.shape[2]
    eye = np.eye(t, dtype=np.int32)
    if query_mode == "first":
        # only frames strictly after the query frame count
        frame_weights = np.cumsum(eye, axis=1) - eye
    elif query_mode == "strided":
        # every frame except the query frame counts
        frame_weights = 1 - eye
    else:
        raise ValueError(f"Unknown query mode {query_mode}")

    query_frame = np.round(query_points[..., 0]).astype(np.int32)
    eval_points = frame_weights[query_frame] > 0  # [b, n, t]

    gt_occluded = gt_occluded.astype(bool)
    pred_occluded = pred_occluded.astype(bool)
    metrics: Dict[str, np.ndarray] = {}
    metrics["occlusion_accuracy"] = (
        np.sum((pred_occluded == gt_occluded) & eval_points, axis=summing_axis)
        / np.sum(eval_points, axis=summing_axis))

    visible = ~gt_occluded
    pred_visible = ~pred_occluded
    frac_list, jac_list = [], []
    sq_dist = np.sum(np.square(pred_tracks - gt_tracks), axis=-1)
    for thresh in THRESHOLDS:
        within = sq_dist < thresh ** 2
        correct_visible = within & visible
        count_correct = np.sum(correct_visible & eval_points, axis=summing_axis)
        count_visible = np.sum(visible & eval_points, axis=summing_axis)
        frac = count_correct / count_visible
        metrics[f"pts_within_{thresh}"] = frac
        frac_list.append(frac)

        true_pos = np.sum(correct_visible & pred_visible & eval_points,
                          axis=summing_axis)
        gt_pos = np.sum(visible & eval_points, axis=summing_axis)
        false_pos = ((~visible) & pred_visible) | ((~within) & pred_visible)
        false_pos = np.sum(false_pos & eval_points, axis=summing_axis)
        jac = true_pos / (gt_pos + false_pos)
        metrics[f"jaccard_{thresh}"] = jac
        jac_list.append(jac)

    metrics["average_jaccard"] = np.mean(np.stack(jac_list, axis=1), axis=1)
    metrics["average_pts_within_thresh"] = np.mean(
        np.stack(frac_list, axis=1), axis=1)
    return metrics


def compute_tapvid_metrics_for_video(model_trajectories_dir: str,
                                     model_occ_pred_dir: str,
                                     benchmark_data: dict,
                                     video_idx: int,
                                     pred_video_sizes=None) -> Dict[str, float]:
    """Assemble saved per-query-frame predictions and evaluate one video
    (reference eval/metrics.py:150-223). pred_video_sizes = (w, h)."""
    from .tapvid import get_video_config_by_video_id
    cfg = get_video_config_by_video_id(benchmark_data, video_idx)
    pred_w = cfg["w"] if pred_video_sizes is None else pred_video_sizes[0]
    pred_h = cfg["h"] if pred_video_sizes is None else pred_video_sizes[1]

    qp_list, gt_occ_list, gt_trk_list, pr_occ_list, pr_trk_list = [], [], [], [], []
    for frame_idx in cfg["query_points"]:
        trk_path = os.path.join(model_trajectories_dir,
                                f"trajectories_{frame_idx}.npy")
        occ_path = os.path.join(model_occ_pred_dir,
                                f"occlusion_preds_{frame_idx}.npy")
        assert os.path.exists(trk_path), f"missing {trk_path}"
        assert os.path.exists(occ_path), f"missing {occ_path}"
        pred_tracks = np.load(trk_path)
        pred_occ = np.load(occ_path)

        qp = np.asarray(cfg["query_points"][frame_idx], dtype=np.float32)
        t_col = np.full((qp.shape[0], 1), frame_idx, dtype=np.float32)
        qp_list.append(np.concatenate([t_col, qp], axis=1))  # (t, x, y)
        gt_trk_list.append(np.asarray(cfg["target_points"][frame_idx]))
        gt_occ_list.append(np.asarray(cfg["occluded"][frame_idx]))
        pr_trk_list.append(pred_tracks)
        pr_occ_list.append(pred_occ)

    query_points = np.concatenate(qp_list, axis=0)
    gt_tracks = np.concatenate(gt_trk_list, axis=0).astype(np.float32)
    gt_occluded = np.concatenate(gt_occ_list, axis=0).astype(bool)
    pred_tracks = np.concatenate(pr_trk_list, axis=0).astype(np.float32)
    pred_occluded = np.concatenate(pr_occ_list, axis=0).astype(bool)

    # rescale to 256×256 metric coords; query cols 1/2 become (y, x) scaled
    query_scaled = query_points.copy()
    query_scaled[..., 1] = query_points[..., 2] * 256 / cfg["h"]
    query_scaled[..., 2] = query_points[..., 1] * 256 / cfg["w"]
    gt_tracks = gt_tracks * np.asarray([256 / cfg["w"], 256 / cfg["h"]],
                                       np.float32)
    pred_tracks = pred_tracks * np.asarray([256 / pred_w, 256 / pred_h],
                                           np.float32)

    metrics = compute_tapvid_metrics(query_scaled[None], gt_occluded[None],
                                     gt_tracks[None], pred_occluded[None],
                                     pred_tracks[None], query_mode="strided")
    return {k: float(v.item()) for k, v in metrics.items()}


def compute_badja_metrics_for_video(model_trajectories_dir: str,
                                    benchmark_data: dict,
                                    video_idx: int,
                                    pred_video_sizes=None) -> Dict[str, float]:
    """BADJA accuracy: within 0.2·√(segmentation area) and within 3px
    (reference eval/metrics.py:226-287)."""
    from .tapvid import get_video_config_by_video_id
    cfg = get_video_config_by_video_id(benchmark_data, video_idx)
    scale_w = 1.0 if pred_video_sizes is None else cfg["w"] / pred_video_sizes[0]
    scale_h = 1.0 if pred_video_sizes is None else cfg["h"] / pred_video_sizes[1]

    pred_list, gt_trk_list, gt_occ_list = [], [], []
    for frame_idx in cfg["target_points"]:
        path = os.path.join(model_trajectories_dir,
                            f"trajectories_{frame_idx}.npy")
        assert os.path.exists(path), f"missing {path}"
        pred_list.append(np.load(path))
        gt_trk_list.append(np.asarray(cfg["target_points"][frame_idx]))
        gt_occ_list.append(np.asarray(cfg["occluded"][frame_idx]))

    pred_tracks = np.concatenate(pred_list, axis=0).astype(np.float32)
    gt_tracks = np.concatenate(gt_trk_list, axis=0).astype(np.float32)
    gt_occluded = np.concatenate(gt_occ_list, axis=0)
    segs = (np.asarray(cfg["segmentations"]) > 0).astype(np.float32)

    pred_tracks = pred_tracks * np.asarray([scale_w, scale_h], np.float32)

    accs_seg, accs_3px = [], []
    for i in range(gt_tracks.shape[0]):
        for t in range(1, segs.shape[0]):
            if gt_occluded[i, t] != 0:
                continue
            thr = 0.2 * np.sqrt(segs[t].sum())
            dist = np.linalg.norm(pred_tracks[i, t] - gt_tracks[i, t])
            accs_seg.append(float(dist < thr))
            accs_3px.append(float(dist < 3.0))
    return {"acc_seg": float(np.mean(accs_seg) * 100.0),
            "acc_3px": float(np.mean(accs_3px) * 100.0)}
