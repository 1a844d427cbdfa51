"""Frame folders, masks and ``.npz`` artifacts on the host (numpy).

The port's own copy of the functions it needs from
``dino_tracker_tpu/utils/video_io.py``, with the same behaviour, so both
packages read a folder to the same bits: sorted jpg/png frames, LANCZOS
resize through the native loader (``native_io``) or else Pillow, [0, 1]
floats T×3×H×W; grayscale masks with a floor-index nearest resize; mask
frames written as jpgs with Pillow; videos written as mp4 with OpenCV and
video files read into frame folders with imageio. Each image library is
imported inside the functions, so the modules that import this one need
none.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def list_frame_files(folder: str):
    p = Path(folder)
    return sorted(list(p.glob("*.jpg")) + list(p.glob("*.png")))


def load_video(video_folder: str, resize: Optional[Tuple[int, int]] = None,
               num_frames: Optional[int] = None) -> np.ndarray:
    """A frame folder -> float32 T×3×H×W in [0, 1], ``resize`` = (H, W)
    with LANCZOS. The native decoder serves resized loads unless
    DINO_TRACKER_NATIVE_IO=0; Pillow serves the rest."""
    files = list_frame_files(video_folder)
    if num_frames is not None:
        files = files[:num_frames]
    if resize is not None and os.environ.get("DINO_TRACKER_NATIVE_IO", "1") != "0":
        from . import native_io
        out = native_io.decode_resize_batch(files, resize[0], resize[1])
        if out is not None:
            return out
    from PIL import Image
    frames = []
    for f in files:
        img = Image.open(str(f)).convert("RGB")
        if resize is not None:
            resh, resw = resize
            img = img.resize((resw, resh), Image.LANCZOS)
        arr = np.asarray(img, dtype=np.float32) / 255.0  # H×W×3
        frames.append(np.transpose(arr, (2, 0, 1)))
    return np.stack(frames)


def get_original_video_res(video_folder: str) -> Tuple[int, int, int]:
    """(H, W, T) of the raw frame folder."""
    from PIL import Image
    files = list_frame_files(video_folder)
    with Image.open(files[0]) as img:
        w, h = img.size
    return h, w, len(files)


def nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source index floor(i · n_in / n_out) of each output index: torch
    ``F.interpolate(mode="nearest")``."""
    return (np.arange(n_out, dtype=np.int64) * n_in) // n_out


def load_masks(masks_path: str, h_resize: Optional[int] = 476,
               w_resize: Optional[int] = 854) -> np.ndarray:
    """Grayscale masks, nearest-resized -> float32 T×H×W."""
    from PIL import Image
    masks = np.stack([np.asarray(Image.open(str(f)).convert("L"), dtype=np.float32)
                      for f in list_frame_files(masks_path)])
    th = masks.shape[1] if h_resize is None else h_resize
    tw = masks.shape[2] if w_resize is None else w_resize
    if (th, tw) != masks.shape[1:]:
        masks = masks[:, nearest_index(th, masks.shape[1])][
            :, :, nearest_index(tw, masks.shape[2])]
    return masks


def save_video_frames(video: np.ndarray, folder: str):
    """Save T×H×W[×C] uint8 frames as jpgs; returns the folder path. Pillow's
    default JPEG settings: the same bytes as the JAX package's
    ``imageio.imwrite``, which writes through Pillow."""
    from PIL import Image
    path = Path(folder)
    path.mkdir(exist_ok=True, parents=True)
    for idx, frame in enumerate(video):
        Image.fromarray(np.squeeze(frame)).save(path / f"{idx:05d}.jpg")
    return path


def save_video(video_thwc: np.ndarray, output_path: str, fps: int = 30):
    """Save a T×H×W×3 uint8 (RGB) video as mp4 with OpenCV's writer (the
    JAX package's ``save_video``)."""
    import cv2
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    h, w = video_thwc.shape[1:3]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    try:
        for frame in video_thwc:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def mp4_to_frames(mp4_file: str, output_folder: str):
    """Every frame of a video file as ``<output_folder>/<i:05d>.jpg``, read
    and written with imageio as the JAX package does (its ``mp4_to_frames``),
    so both write the same bytes."""
    try:
        import imageio
    except ImportError as e:
        raise ImportError("mp4_to_frames needs the imageio package (with an mp4 "
                          "reader such as imageio-ffmpeg) to read videos") from e
    os.makedirs(output_folder, exist_ok=True)
    with imageio.get_reader(mp4_file) as vid:
        for i, frame in enumerate(vid):
            imageio.imwrite(os.path.join(output_folder, f"{i:05d}.jpg"), frame)


def get_grid_query_points(res_h_w: Tuple[int, int], segm_mask: Optional[np.ndarray] = None,
                          interval: int = 10, query_frame: int = 0) -> np.ndarray:
    """Every-``interval``-pixel grid of (x, y, t) query points on one frame,
    optionally kept only where a segmentation mask is > 0."""
    h, w = res_h_w
    gyy, gxx = np.meshgrid(np.arange(0, h, interval), np.arange(0, w, interval),
                           indexing="ij")
    pts = np.stack([gxx.reshape(-1), gyy.reshape(-1)], axis=-1).astype(np.float32)
    if segm_mask is not None:
        if segm_mask.shape != (h, w):
            segm_mask = segm_mask[nearest_index(h, segm_mask.shape[0])][
                :, nearest_index(w, segm_mask.shape[1])]
        keep = segm_mask[np.round(pts[:, 1]).astype(np.int64),
                         np.round(pts[:, 0]).astype(np.int64)] > 0
        pts = pts[keep]
    t = np.full((pts.shape[0], 1), float(query_frame), dtype=np.float32)
    return np.concatenate([pts, t], axis=1)


def save_npz(path: str, **arrays):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}
