"""Visualization CLI of the port (reference visualization/visualize_rainbow.py +
visualize_pred_vs_gt.py): dotted tracks, stabilized rainbow trails, or
pred-vs-GT overlays from saved prediction artifacts, written as mp4 under
``D/visualizations``:

    python -m dino_tracker_tpu_torch.cli.visualize --data-path D [--mode dotted]

A copy of the JAX package's CLI on the port's own ``viz`` and ``video_io``
(host numpy, OpenCV and matplotlib); it draws the same frames.
"""

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--mode", default="rainbow",
                        choices=["rainbow", "dotted", "pred-vs-gt"])
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--point-size", type=int, default=4)
    parser.add_argument("--linewidth", type=int, default=1)
    parser.add_argument("--infer-res-size", type=int, nargs=2, default=None,
                        help="(h, w) prediction resolution for rescaling")
    parser.add_argument("--vis-start-frame", type=int, default=0)
    parser.add_argument("--vis-end-frame", type=int, default=None)
    parser.add_argument("--canonical-frame", type=int, default=None)
    parser.add_argument("--homography-method", default="canonical",
                        choices=["canonical", "cv2"],
                        help="'canonical' = reference-fidelity RANSAC "
                             "against evolving canonical points with "
                             "refinement passes; 'cv2' = per-frame "
                             "findHomography with fallback chaining")
    parser.add_argument("--erosion-kernel-size", type=int, default=None)
    parser.add_argument("--use-segm-mask", action="store_true", default=True)
    parser.add_argument("--benchmark-pickle-path", default=None,
                        help="for pred-vs-gt mode")
    parser.add_argument("--video-id", type=int, default=0)
    parser.add_argument("--query-frame", type=int, default=0)
    args = parser.parse_args(argv)

    from ..config import add_config_paths
    from ..utils import video_io
    from ..visualization import viz

    paths = add_config_paths(args.data_path)
    video = video_io.load_video(paths["video_folder"], num_frames=300)
    video = (np.transpose(video, (0, 2, 3, 1)) * 255).astype(np.uint8)
    t, h, w = video.shape[:3]
    os.makedirs(paths["model_vis_dir"], exist_ok=True)

    if args.mode == "pred-vs-gt":
        from ..evaluation.tapvid import (load_benchmark,
                                         get_video_config_by_video_id)
        cfg = get_video_config_by_video_id(
            load_benchmark(args.benchmark_pickle_path), args.video_id)
        f = args.query_frame
        pred = np.load(os.path.join(paths["trajectories_dir"],
                                    f"trajectories_{f}.npy"))
        pocc = np.load(os.path.join(paths["occlusions_dir"],
                                    f"occlusion_preds_{f}.npy"))
        if args.infer_res_size is not None:
            ph, pw = args.infer_res_size
            pred = pred * np.asarray([w / pw, h / ph], np.float32)
        gt = np.asarray(cfg["target_points"][f], np.float32)
        gocc = np.asarray(cfg["occluded"][f])
        gt = gt * np.asarray([w / cfg["w"], h / cfg["h"]], np.float32)
        out = viz.overlay_pred_gt(video, pred, pocc, gt, gocc,
                                  point_size=args.point_size)
        name = f"pred_vs_gt_frame_{f}_fps_{args.fps}.mp4"
        video_io.save_video(out, os.path.join(paths["model_vis_dir"], name),
                            fps=args.fps)
        print("saved", name)
        return

    tracks = np.load(os.path.join(paths["grid_trajectories_dir"],
                                  "grid_trajectories.npy"))
    occ_path = os.path.join(paths["grid_occlusions_dir"],
                            "grid_occlusions.npy")
    occluded = (np.load(occ_path).astype(np.int32) if os.path.exists(occ_path)
                else np.zeros(tracks.shape[:2], np.int32))
    if args.infer_res_size is not None:
        ph, pw = args.infer_res_size
        tracks = tracks * np.asarray([w / pw, h / ph], np.float32)

    # foreground filter by the start-frame mask
    if args.use_segm_mask and os.path.exists(paths["masks_path"]):
        masks = video_io.load_masks(paths["masks_path"], h_resize=h, w_resize=w)
        segm = masks[args.vis_start_frame] > 0
        if args.erosion_kernel_size:
            segm = viz.erode_mask(segm, args.erosion_kernel_size)
        coords = np.round(tracks[:, 0]).astype(np.int64)
        keep = segm[np.clip(coords[:, 1], 0, h - 1),
                    np.clip(coords[:, 0], 0, w - 1)] > 0
        tracks, occluded = tracks[keep], occluded[keep]

    s, e = args.vis_start_frame, args.vis_end_frame or t
    video_c, tracks_c, occ_c = video[s:e], tracks[:, s:e], occluded[:, s:e]

    dotted = viz.plot_tracks(video_c, tracks_c, occ_c,
                             point_size=args.point_size)
    name = f"dotted_tracks_fps_{args.fps}.mp4"
    video_io.save_video(dotted, os.path.join(paths["model_vis_dir"], name),
                        fps=args.fps)
    print("saved", name)

    if args.mode == "rainbow":
        bg = video_io.load_npz(paths["bg_trajectories_file"])["trajectories"]
        bg = bg[:, s:e]
        bg_tracks = viz.filter_bg_trajectories_for_homographies(
            bg, canonical_frame=args.canonical_frame)
        bg_occ = np.isnan(bg_tracks).any(axis=-1)
        bg_xy = np.nan_to_num(bg_tracks)
        if args.infer_res_size is not None:
            ph, pw = args.infer_res_size
            bg_xy = bg_xy * np.asarray([w / pw, h / ph], np.float32)
        if args.homography_method == "canonical":
            homogs, _, _ = viz.estimate_homographies_canonical(
                bg_xy, bg_occ, image_dimensions=(w, h),
                reference_frame=args.canonical_frame)
        else:
            homogs = viz.estimate_homographies(
                bg_xy, bg_occ, canonical_frame=args.canonical_frame,
                image_dimensions=(w, h))
        trails = viz.plot_tracks_tails(video_c, tracks_c, occ_c, homogs,
                                       point_size=args.point_size,
                                       linewidth=args.linewidth)
        name = f"rainbow_fps_{args.fps}.mp4"
        video_io.save_video(trails, os.path.join(paths["model_vis_dir"], name),
                            fps=args.fps)
        print("saved", name)


if __name__ == "__main__":
    main()
