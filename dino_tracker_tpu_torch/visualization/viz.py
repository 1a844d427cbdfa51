"""Track visualization: dotted tracks, stabilized motion trails, pred-vs-gt.
The port's own copy of ``dino_tracker_tpu/visualization/viz.py`` (numpy, with
OpenCV and matplotlib imported inside the functions); its seeded
``np.random.default_rng`` draws are the same, so both packages draw the same
frames.

Functional equivalents of the reference visualization/ package
(visualize_rainbow.py, viz_utils_tapir.py ``plot_tracks_v2`` /
``plot_tracks_tails`` / ``get_homographies_wrt_frame``,
visualize_pred_vs_gt.py), drawn with OpenCV primitives instead of a
matplotlib figure per frame (same outputs: uint8 T×H×W×3 videos; occluded
points hidden or drawn hollow; trails stabilized by RANSAC homographies
estimated from background flow trajectories).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rainbow_colors(n: int, rainbow: bool = True, seed: int = 0) -> np.ndarray:
    """n×3 uint8 BGR-independent RGB colors from the HSV wheel. With
    rainbow=False the hue order is shuffled (reference plot_tracks_v2
    z_list permutation)."""
    import matplotlib.cm as cm
    idx = np.arange(n)
    if not rainbow:
        idx = np.random.default_rng(seed).permutation(n)[idx % n]
    colors = cm.hsv(idx / max(n, 1))[:, :3]
    return (colors * 255).astype(np.uint8)


def plot_tracks(video_thwc: np.ndarray, tracks: np.ndarray,
                occluded: np.ndarray, point_size: int = 4,
                rainbow: bool = True,
                show_occluded_hollow: bool = False) -> np.ndarray:
    """Dotted-track video. tracks: N×T×2 pixel coords; occluded: N×T.

    Occluded points are hidden (alpha-0 in the reference) unless
    ``show_occluded_hollow`` draws them as outline circles.
    """
    import cv2
    t, h, w = video_thwc.shape[:3]
    n = tracks.shape[0]
    colors = rainbow_colors(n, rainbow)
    out = []
    for i in range(t):
        frame = np.ascontiguousarray(video_thwc[i].copy())
        pts = np.clip(tracks[:, i], 0, [w - 1, h - 1])
        for p in range(n):
            x, y = int(round(float(pts[p, 0]))), int(round(float(pts[p, 1])))
            color = tuple(int(c) for c in colors[p])
            if occluded[p, i]:
                if show_occluded_hollow:
                    cv2.circle(frame, (x, y), point_size, color, 1,
                               lineType=cv2.LINE_AA)
            else:
                cv2.circle(frame, (x, y), point_size, color, -1,
                           lineType=cv2.LINE_AA)
        out.append(frame)
    return np.stack(out)


def filter_bg_trajectories_for_homographies(bg_trajectories: np.ndarray,
                                            count: int = 500,
                                            canonical_frame: Optional[int] = None,
                                            min_len: int = 10,
                                            seed: int = 0) -> np.ndarray:
    """Pick long background trajectories covering every frame w.r.t. the
    canonical frame (reference visualize_rainbow.py:32-54)."""
    n, t = bg_trajectories.shape[:2]
    if canonical_frame is None:
        canonical_frame = t // 2
    valid = ~np.isnan(bg_trajectories).any(axis=-1)  # N×T
    lengths = valid.sum(axis=1)
    rng = np.random.default_rng(seed)
    per_frame = max(count // t, 1)
    picks = []
    for f in range(t):
        ok = valid[:, f] & valid[:, canonical_frame]
        idx = np.where(ok & (lengths > min_len))[0]
        if len(idx) < per_frame:
            idx = np.where(ok & (lengths > 5))[0]
        if len(idx) == 0:
            continue
        picks.append(rng.permutation(idx)[:per_frame])
    if not picks:
        return bg_trajectories[:0]
    uniq = np.unique(np.concatenate(picks))
    return bg_trajectories[uniq]


def estimate_homographies(bg_tracks: np.ndarray, occluded: np.ndarray,
                          canonical_frame: Optional[int] = None,
                          ransac_threshold: float = 0.014,
                          image_dimensions: Optional[Tuple[int, int]] = None,
                          min_inlier_frac: float = 0.25) -> np.ndarray:
    """Per-frame homography to the canonical frame from background tracks.

    RANSAC in NORMALIZED [0, 1] coordinates (the reference's own RANSAC
    rescales for numerical stability, viz_utils_tapir.py:389-441,530-534;
    its default outlier threshold is 0.07 of the image extent with two
    refinement passes — cv2.findHomography's LMeDS-polished RANSAC fills
    the same role here, with a tighter threshold since a single pass does
    both ransac + refinement). ``ransac_threshold`` is a fraction of the
    image extent; ``image_dimensions`` is (width, height) (inferred from
    the track extent when absent).

    Degenerate / low-inlier cases fall back to the previous frame's
    homography (identity at the start), keeping the trail stabilization
    finite and continuous instead of snapping through a garbage fit.

    Returns T×3×3 with identity at the canonical frame.
    """
    import cv2
    n, t = bg_tracks.shape[:2]
    if canonical_frame is None:
        canonical_frame = t // 2
    if image_dimensions is None:
        finite = bg_tracks[~occluded.astype(bool)]
        upper = finite.max(axis=0) if len(finite) else np.ones(2)
        image_dimensions = (max(float(upper[0]), 1.0),
                            max(float(upper[1]), 1.0))
    wh = np.asarray(image_dimensions, np.float64)
    s = np.diag([1.0 / wh[0], 1.0 / wh[1], 1.0])
    s_inv = np.diag([wh[0], wh[1], 1.0])

    homogs = np.tile(np.eye(3, dtype=np.float64)[None], (t, 1, 1))
    visible = ~occluded.astype(bool)

    def fit(f):
        ok = visible[:, f] & visible[:, canonical_frame]
        if ok.sum() < 8:
            return None
        src = bg_tracks[ok, f].astype(np.float64) / wh
        dst = bg_tracks[ok, canonical_frame].astype(np.float64) / wh
        hm, inliers = cv2.findHomography(src, dst, cv2.RANSAC,
                                         ransac_threshold)
        if hm is None or not np.isfinite(hm).all():
            return None
        if inliers is not None and inliers.sum() < max(
                8, min_inlier_frac * len(src)):
            return None
        return s_inv @ hm @ s

    # sweep outward from the canonical frame so the fallback chains the
    # nearest successful estimate (reference processes frames after the
    # reference frame ascending, then before it descending — :556-560)
    order = list(range(canonical_frame + 1, t)) + \
        list(range(canonical_frame - 1, -1, -1))
    for f in order:
        hm = fit(f)
        if hm is None:
            prev = f - 1 if f > canonical_frame else f + 1
            hm = homogs[prev]
        homogs[f] = hm
    return homogs


def _apply_homography(pts_n2: np.ndarray, hm: np.ndarray) -> np.ndarray:
    hom = np.concatenate([pts_n2, np.ones_like(pts_n2[:, :1])], axis=1)
    out = hom @ hm.T
    return out[:, :2] / np.clip(out[:, 2:3], 1e-8, None)


# ---------------------------------------------------------------------------
# canonical-point homography estimation (reference-fidelity path)
# ---------------------------------------------------------------------------

def _fit_homography_dlt(src_n2: np.ndarray, dst_n2: np.ndarray,
                        weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Least-squares homography src->dst via the DLT: the 9-vector h
    minimizing |A h| over the 2N constraint rows, taken from the SVD's
    smallest right singular vector (reference estimate_homography,
    viz_utils_tapir.py:312-368 builds the same system)."""
    n = src_n2.shape[0]
    if weights is None:
        weights = np.ones(n, np.float64)
    sx, sy = src_n2[:, 0], src_n2[:, 1]
    dx, dy = dst_n2[:, 0], dst_n2[:, 1]
    one = np.ones(n)
    zero = np.zeros(n)
    rows_x = np.stack([sx, sy, one, zero, zero, zero,
                       -dx * sx, -dx * sy, -dx], axis=1)
    rows_y = np.stack([zero, zero, zero, sx, sy, one,
                       -dy * sx, -dy * sy, -dy], axis=1)
    a = np.concatenate([rows_x * weights[:, None],
                        rows_y * weights[:, None]], axis=0)
    full = a.shape[0] <= 8
    _, _, vt = np.linalg.svd(a, full_matrices=full)
    return vt[-1].reshape(3, 3)


def _homography_errors(hm: np.ndarray, src_n2: np.ndarray,
                       dst_n2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Squared reprojection error of H(src) vs dst and the transformed
    points (sign-safe perspective divide, reference compute_inliers)."""
    hom = np.concatenate([src_n2, np.ones_like(src_n2[:, :1])], axis=1)
    out = hom @ hm.T
    wcol = out[:, 2:3]
    denom = np.maximum(1e-12, np.abs(wcol)) * np.where(wcol < 0, -1.0, 1.0)
    tformed = out[:, :2] / denom
    err = np.sum((dst_n2 - tformed) ** 2, axis=1)
    return err, tformed


def _ransac_fit(src_n2: np.ndarray, dst_n2: np.ndarray, vis: np.ndarray,
                thresh: float, targ_inlier_frac: float,
                rng: np.random.Generator) -> np.ndarray:
    """4-point RANSAC with a decaying acceptance threshold + final
    weighted least-squares refit on the inliers (reference
    ransac_homography, viz_utils_tapir.py:389-441). Coordinates must
    already be normalized to ~[0, 1]; ``thresh`` is in those units."""
    n = src_n2.shape[0]
    probs = vis / np.sum(vis)
    best_hm = np.zeros((3, 3))
    best_inliers = 0
    t2 = thresh * thresh
    for it in range(n):
        # terminate once the inlier count beats a target fraction that
        # decays with the iteration (guarantees progress even when the true
        # inlier rate is below targ_inlier_frac)
        accept = min(1.0 - (it + 1) / n,
                     targ_inlier_frac * 0.99 ** it) * n
        if best_inliers >= accept:
            break
        pick = rng.choice(n, 4, replace=False, p=probs)
        hm = _fit_homography_dlt(src_n2[pick], dst_n2[pick])
        err, _ = _homography_errors(hm, src_n2, dst_n2)
        inliers = int(np.sum(err < t2))
        if inliers > best_inliers:
            best_inliers, best_hm = inliers, hm
    err, _ = _homography_errors(best_hm, src_n2, dst_n2)
    return _fit_homography_dlt(src_n2, dst_n2,
                               (err < t2).astype(np.float64))


def _usable_homography(hm: np.ndarray) -> bool:
    """Reject non-finite or (near-)singular fits — a degenerate RANSAC round
    (collinear/coincident draws) can emit a rank-deficient H that would blow
    up plot_tracks_tails' inv(H) chaining downstream."""
    if not np.isfinite(hm).all():
        return False
    det = np.linalg.det(hm)
    return np.isfinite(det) and abs(det) > 1e-12 and np.linalg.cond(hm) < 1e12


def _update_canonical(tformed_tn2: np.ndarray, invalid_tn: np.ndarray,
                      err_tn: np.ndarray, thresh: float, outer_thresh: float,
                      required_inlier_frac: float, rng: np.random.Generator):
    """Outlier-robust canonical points: mean of each point's transformed
    positions over frames where it is visible and within ``outer_thresh``;
    points whose within-``thresh`` fraction is too low are re-seeded from a
    random visible frame (reference compute_canonical_points,
    viz_utils_tapir.py:465-497)."""
    visible = ~invalid_tn
    outlier = invalid_tn | (err_tn > outer_thresh ** 2)
    inlier_frac = (np.sum(visible & (err_tn < thresh ** 2), axis=0)
                   / np.maximum(1.0, np.sum(visible, axis=0)))
    keep = (~outlier).astype(np.float64)
    mean = (np.einsum("tnc,tn->nc", tformed_tn2, keep)
            / np.maximum(1.0, keep.sum(axis=0))[:, None])
    bad = inlier_frac < required_inlier_frac
    if np.any(bad):
        # re-seed each bad point from one of its visible frames (or 0s when
        # it is never visible)
        n = invalid_tn.shape[1]
        reseed = np.zeros((n, 2))
        for p in np.where(bad)[0]:
            frames = np.where(visible[:, p])[0]
            if len(frames):
                reseed[p] = tformed_tn2[rng.choice(frames), p]
        mean = np.where(bad[:, None], reseed, mean)
    return mean, bad


def estimate_homographies_canonical(
        tracks: np.ndarray, occluded: np.ndarray,
        image_dimensions: Tuple[float, float],
        reference_frame: Optional[int] = None, thresh: float = 0.07,
        outlier_point_threshold: float = 0.95,
        targ_inlier_frac: float = 0.7, num_refinement_passes: int = 2,
        seed: int = 0):
    """Reference-fidelity homography estimation: per-frame RANSAC against an
    evolving set of CANONICAL points (robust means in the reference frame's
    normalized coordinates), followed by global refinement passes
    (reference get_homographies_wrt_frame, viz_utils_tapir.py:499-662).

    tracks: N×T×2 pixel coords; occluded: N×T (1 = occluded);
    image_dimensions: (width, height). Returns (homogs T×3×3 mapping
    frame-f PIXEL coords to canonical-frame PIXEL coords, err N×T squared
    normalized-coordinate residuals, canonical_pts N×2 pixels).

    Differences from the cv2 path (``estimate_homographies``): the target is
    the canonical AVERAGE of each trajectory rather than one frame's
    observations, so frames with little direct overlap with the reference
    frame still register through intermediate frames.
    """
    rng = np.random.default_rng(seed)
    wh = np.asarray(image_dimensions, np.float64)
    pts = np.transpose(tracks, (1, 0, 2)).astype(np.float64) / wh  # T×N×2
    occ = np.transpose(occluded).astype(bool)  # T×N
    t, n = occ.shape
    if reference_frame is None:
        reference_frame = t // 2
    outer_thresh = 2.0 * thresh
    t2 = thresh * thresh

    canonical = pts[reference_frame].copy()
    canonical_invalid = occ[reference_frame].copy()
    tformed = np.zeros_like(pts)
    tformed[reference_frame] = canonical
    invalid = np.ones_like(occ)
    invalid[reference_frame] = canonical_invalid
    err = np.zeros((t, n))
    homogs = [None] * t
    homogs[reference_frame] = np.eye(3)

    order = (list(range(reference_frame + 1, t))
             + list(range(reference_frame - 1, -1, -1)))
    for f in order:
        vis = (~occ[f]) & (~canonical_invalid)
        if vis.sum() > 4:
            hm = _ransac_fit(pts[f], canonical, vis.astype(np.float64),
                             thresh, targ_inlier_frac, rng)
        else:
            hm = np.eye(3)
        if not _usable_homography(hm):
            # chain the neighboring frame's estimate (the cv2 path's
            # fallback) instead of letting a singular fit through
            prev = f - 1 if f > reference_frame else f + 1
            hm = homogs[prev]
        err[f], tformed[f] = _homography_errors(hm, pts[f], canonical)
        invalid[f] = occ[f]
        homogs[f] = hm
        canonical, canonical_invalid = _update_canonical(
            tformed, invalid, err, thresh, outer_thresh,
            outlier_point_threshold, rng)

    for _ in range(num_refinement_passes):
        for f in [reference_frame] + order:
            e, _ = _homography_errors(homogs[f], pts[f], canonical)
            good = ~(canonical_invalid | occ[f] | (e > t2))
            if good.sum() > 4:
                refit = _fit_homography_dlt(
                    pts[f], canonical, good.astype(np.float64))
                if _usable_homography(refit):
                    homogs[f] = refit
            err[f], tformed[f] = _homography_errors(homogs[f], pts[f],
                                                    canonical)
            canonical, canonical_invalid = _update_canonical(
                tformed, invalid, err, thresh, outer_thresh,
                outlier_point_threshold, rng)

    # pixel-in / pixel-out convention (matches plot_tracks_tails):
    # normalize -> H (to canonical normalized coords) -> denormalize
    s = np.diag([1.0 / wh[0], 1.0 / wh[1], 1.0])
    s_inv = np.diag([wh[0], wh[1], 1.0])
    out = np.stack([s_inv @ h @ s for h in homogs], axis=0)
    # fix scale: an H is defined up to scale; normalize so H[2,2] ~= 1 when
    # well-conditioned (keeps chaining inv(H_i) @ H_j stable)
    denom = out[:, 2:3, 2:3]
    denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    out = out / denom
    return out, np.transpose(err), canonical * wh


def plot_tracks_tails(video_thwc: np.ndarray, tracks: np.ndarray,
                      occluded: np.ndarray, homogs: Optional[np.ndarray] = None,
                      point_size: int = 4, linewidth: int = 1,
                      tail_length: Optional[int] = None,
                      trail_fade: bool = True) -> np.ndarray:
    """Motion-trail video: each point drags its (camera-stabilized) past
    positions (reference viz_utils_tapir.py:665-780). ``homogs[f]`` maps
    frame-f coords to the canonical frame; past points are re-projected into
    the current frame via inv(H_i) @ H_j.

    Matches the reference's matplotlib compositing: trail segments fade with
    age (``alpha = max(1 - 0.9·(i-j)/((i+1)·0.99), 0.1)``, viz_utils_tapir
    :758), segments with an occluded or out-of-frame endpoint are hidden
    (:740-752), and trail coordinates clamp into the image (:746-747) —
    rendered as one cv2 overlay blend per age slice."""
    import cv2
    t, h, w = video_thwc.shape[:3]
    n = tracks.shape[0]
    colors = rainbow_colors(n, rainbow=True)
    if homogs is None:
        homogs = np.tile(np.eye(3)[None], (t, 1, 1))
    inv_homogs = np.linalg.inv(homogs)
    out = []
    for i in range(t):
        frame = np.ascontiguousarray(video_thwc[i].copy())
        start = 0 if tail_length is None else max(0, i - tail_length)
        # past positions re-projected into frame i
        proj = []
        for j in range(start, i + 1):
            warped = _apply_homography(tracks[:, j], inv_homogs[i] @ homogs[j])
            proj.append(warped)
        proj = np.stack(proj, axis=1)  # N×L×2, L = i-start+1
        # a near-degenerate homography chain can fling reprojections to
        # inf/NaN — cv2.line hard-errors on those; treat as out-of-frame
        finite = np.isfinite(proj).all(axis=-1)
        oof = ((np.nan_to_num(proj) < 1.0)
               | (np.nan_to_num(proj) > [w, h])).any(axis=-1) | ~finite
        proj = np.clip(np.nan_to_num(proj), 1.0, [w - 1.0, h - 1.0])
        vis = (~occluded[:, start:i + 1].astype(bool)) & ~oof
        pts_i = np.rint(proj).astype(np.int32)
        for j in range(proj.shape[1] - 1):  # age slice: segment j -> j+1
            drawable = vis[:, j] & vis[:, j + 1]
            if not drawable.any():
                continue
            alpha = 1.0
            if trail_fade:
                age = (i - (start + j)) / ((i + 1) * 0.99)
                alpha = max(1.0 - 0.9 * age, 0.1)
            layer = frame.copy()
            for p in np.where(drawable)[0]:
                cv2.line(layer, tuple(pts_i[p, j]), tuple(pts_i[p, j + 1]),
                         tuple(int(c) for c in colors[p]), linewidth,
                         cv2.LINE_AA)
            frame = cv2.addWeighted(layer, alpha, frame, 1.0 - alpha, 0.0)
        for p in range(n):
            if not occluded[p, i]:
                x, y = int(round(tracks[p, i, 0])), int(round(tracks[p, i, 1]))
                cv2.circle(frame, (x, y), point_size,
                           tuple(int(c) for c in colors[p]), -1, cv2.LINE_AA)
        out.append(np.asarray(frame))
    return np.stack(out)


def overlay_pred_gt(video_thwc: np.ndarray, pred_tracks: np.ndarray,
                    pred_occluded: np.ndarray, gt_tracks: np.ndarray,
                    gt_occluded: np.ndarray, point_size: int = 4) -> np.ndarray:
    """Prediction-vs-GT overlay (reference visualize_pred_vs_gt.py:21-38):
    filled circle = visible prediction, cross = occluded prediction,
    hollow diamond-ish circle = ground truth."""
    import cv2
    t = video_thwc.shape[0]
    n = pred_tracks.shape[0]
    colors = rainbow_colors(n, rainbow=True)
    out = []
    for i in range(t):
        frame = np.ascontiguousarray(video_thwc[i].copy())
        for p in range(n):
            color = tuple(int(c) for c in colors[p])
            x, y = (int(round(pred_tracks[p, i, 0])),
                    int(round(pred_tracks[p, i, 1])))
            if pred_occluded[p, i]:
                d = point_size
                cv2.line(frame, (x - d, y - d), (x + d, y + d), color, 1,
                         cv2.LINE_AA)
                cv2.line(frame, (x - d, y + d), (x + d, y - d), color, 1,
                         cv2.LINE_AA)
            else:
                cv2.circle(frame, (x, y), point_size, color, -1, cv2.LINE_AA)
            if not gt_occluded[p, i]:
                gx, gy = (int(round(gt_tracks[p, i, 0])),
                          int(round(gt_tracks[p, i, 1])))
                cv2.circle(frame, (gx, gy), point_size + 2, color, 1,
                           cv2.LINE_AA)
        out.append(frame)
    return np.stack(out)


def erode_mask(mask_hw: np.ndarray, kernel_size: int) -> np.ndarray:
    """Binary erosion (replaces kornia.morphology.erosion,
    visualize_rainbow.py:90)."""
    import cv2
    kernel = np.ones((kernel_size, kernel_size), np.uint8)
    return cv2.erode(mask_hw.astype(np.uint8), kernel).astype(mask_hw.dtype)
