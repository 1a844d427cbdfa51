"""The port's visualization (``visualization/viz.py``, ``cli/visualize.py``)
and frame extraction (``utils/video_io.mp4_to_frames``,
``cli/mp4_to_frames.py``), held against the JAX package's on the same seeded
inputs.

Both are host numpy with OpenCV and matplotlib, and the port keeps the JAX
package's seeded ``np.random.default_rng`` draws, so every output must be
equal element for element: colours, picked trajectories, homographies,
drawn frames, and the jpg bytes of extracted frames.
"""

import os
import pickle
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

from dino_tracker_tpu.cli import visualize as jvisualize_cli  # noqa: E402
from dino_tracker_tpu.utils import video_io as jvideo_io  # noqa: E402
from dino_tracker_tpu.visualization import viz as jviz  # noqa: E402
from dino_tracker_tpu_torch.cli import mp4_to_frames as mp4_cli  # noqa: E402
from dino_tracker_tpu_torch.cli import visualize as visualize_cli  # noqa: E402
from dino_tracker_tpu_torch.config import add_config_paths  # noqa: E402
from dino_tracker_tpu_torch.utils import video_io  # noqa: E402
from dino_tracker_tpu_torch.visualization import viz  # noqa: E402

T, H, W = 12, 60, 80


def pan_tracks(rng, n, t=T, noise=0.3, outliers=0.2):
    """N×T×2 background tracks under a camera pan, with independent outliers
    and a few gaps (NaN)."""
    base = rng.random((n, 2)) * [W * 0.8, H * 0.8] + [W * 0.1, H * 0.1]
    shift = np.stack([np.arange(t) * 1.5, np.arange(t) * -0.8], -1)
    tracks = base[:, None] + shift[None] + rng.standard_normal((n, t, 2)) * noise
    k = int(n * outliers)
    tracks[:k] = rng.random((k, t, 2)) * [W, H]
    return tracks.astype(np.float32)


def video(rng, t=T):
    return (rng.random((t, H, W, 3)) * 255).astype(np.uint8)


def case(name):
    """(args, kwargs) of one viz function on seeded inputs."""
    rng = np.random.default_rng(sum(map(ord, name)))
    tracks = pan_tracks(rng, 40)
    occ = rng.random((40, T)) < 0.2
    if name == "rainbow_colors":
        return (37,), dict(rainbow=False, seed=5)
    if name == "filter_bg_trajectories_for_homographies":
        bg = pan_tracks(rng, 300)
        bg[:60, 7:] = np.nan
        bg[60:90, :3] = np.nan
        return (bg,), dict(count=120, canonical_frame=4)
    if name == "estimate_homographies":
        return (tracks.astype(np.float64), occ), dict(canonical_frame=3,
                                                      image_dimensions=(W, H))
    if name == "estimate_homographies_canonical":
        return (tracks, occ), dict(image_dimensions=(W, H))
    if name == "plot_tracks":
        return (video(rng), tracks, occ), dict(point_size=3, rainbow=False,
                                               show_occluded_hollow=True)
    if name == "plot_tracks_tails":
        homogs = jviz.estimate_homographies(tracks.astype(np.float64), occ,
                                            image_dimensions=(W, H))
        return (video(rng), tracks, occ, homogs), dict(point_size=2)
    if name == "overlay_pred_gt":
        gt = tracks + rng.standard_normal(tracks.shape).astype(np.float32) * 2
        return (video(rng), tracks, occ, gt, rng.random((40, T)) < 0.2), {}
    if name == "erode_mask":
        return ((rng.random((H, W)) < 0.7).astype(np.float32), 5), {}
    raise KeyError(name)


def assert_equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [
    "rainbow_colors", "filter_bg_trajectories_for_homographies", "estimate_homographies",
    "estimate_homographies_canonical", "plot_tracks", "plot_tracks_tails",
    "overlay_pred_gt", "erode_mask"])
def test_viz_equals_jax(name):
    args, kwargs = case(name)
    got = getattr(viz, name)(*args, **kwargs)
    want = getattr(jviz, name)(*args, **kwargs)
    assert_equal(got, want)
    if name.startswith("plot") or name == "overlay_pred_gt":
        assert (got != args[0]).any()  # something was drawn
    if name == "filter_bg_trajectories_for_homographies":
        assert 0 < len(got) < len(args[0])


def write_vis_dir(tmp_path):
    """A video directory with everything ``cli.visualize`` reads: frames,
    masks, grid and benchmark predictions, background trajectories, and the
    benchmark pickle (video 0, query frame 2, at 2× the frame size)."""
    from PIL import Image
    rng = np.random.default_rng(19)
    root = str(tmp_path / "vid")
    paths = add_config_paths(root)
    os.makedirs(paths["video_folder"])
    for i, frame in enumerate(video(rng)):
        Image.fromarray(frame).save(os.path.join(paths["video_folder"], f"{i:05d}.png"))
    masks = np.zeros((T, H, W), np.uint8)
    masks[:, 10:50, 15:70] = 255
    video_io.save_video_frames(masks, paths["masks_path"])
    grid = pan_tracks(rng, 30, outliers=0.0)
    for key, name, arr in (("grid_trajectories_dir", "grid_trajectories.npy", grid),
                           ("grid_occlusions_dir", "grid_occlusions.npy",
                            rng.random((30, T)) < 0.2),
                           ("trajectories_dir", "trajectories_2.npy", grid[:12]),
                           ("occlusions_dir", "occlusion_preds_2.npy",
                            rng.random((12, T)) < 0.2)):
        os.makedirs(paths[key])
        np.save(os.path.join(paths[key], name), arr)
    bg = pan_tracks(rng, 300)
    bg[:40, 8:] = np.nan
    video_io.save_npz(paths["bg_trajectories_file"], trajectories=bg)
    gt = (grid[:12] * 2 + rng.standard_normal((12, T, 2)) * 3).astype(np.float32)
    bench = {"videos": [{"video_idx": 0, "h": 2 * H, "w": 2 * W,
                         "query_points": {2: gt[:, 2].tolist()},
                         "target_points": {2: gt}, "occluded": {2: rng.random((12, T)) < 0.2}}]}
    pkl = str(tmp_path / "bench.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(bench, f)
    return root, pkl


@pytest.mark.parametrize("flags", [
    ["--mode", "rainbow"],
    ["--mode", "rainbow", "--homography-method", "cv2", "--canonical-frame", "5",
     "--erosion-kernel-size", "3"],
    ["--mode", "dotted", "--infer-res-size", "30", "40", "--vis-start-frame", "2",
     "--vis-end-frame", "9"],
    ["--mode", "pred-vs-gt", "--query-frame", "2", "--infer-res-size", "60", "80"]],
    ids=["rainbow", "rainbow-cv2", "dotted", "pred-vs-gt"])
def test_visualize_cli_equals_jax(tmp_path, monkeypatch, flags):
    """Both CLIs on one directory draw the same frames under the same file
    names (captured at ``save_video``)."""
    root, pkl = write_vis_dir(tmp_path)
    args = ["--data-path", root, "--benchmark-pickle-path", pkl, *flags]
    saved = {"jax": [], "port": []}
    for key, module in (("jax", jvideo_io), ("port", video_io)):
        monkeypatch.setattr(module, "save_video", lambda v, path, fps=30, key=key:
                            saved[key].append((os.path.basename(path), fps, v.copy())))
    monkeypatch.setattr(sys, "argv", ["visualize", *args])
    jvisualize_cli.main()
    visualize_cli.main(args)
    names = [n for n, _, _ in saved["port"]]
    assert names == [n for n, _, _ in saved["jax"]] and names
    if flags[1] == "rainbow":
        assert names == ["dotted_tracks_fps_10.mp4", "rainbow_fps_10.mp4"]
    for (_, fps, got), (_, jfps, want) in zip(saved["port"], saved["jax"]):
        assert fps == jfps
        assert_equal(got, want)
        assert got.dtype == np.uint8 and got.shape[1:] == (H, W, 3)


def test_save_video_writes_an_mp4(tmp_path):
    frames = video(np.random.default_rng(2), t=4)
    path = str(tmp_path / "out" / "v.mp4")
    video_io.save_video(frames, path, fps=5)
    cap = cv2.VideoCapture(path)
    try:
        n = 0
        while cap.read()[0]:
            n += 1
    finally:
        cap.release()
    assert n == 4


def write_gif(path, frames):
    import imageio
    imageio.mimwrite(path, list(frames), loop=0)


def write_mp4(path, frames):
    video_io.save_video(frames, path, fps=5)


@pytest.mark.parametrize("container", ["mp4", "gif"])
def test_mp4_to_frames_equals_jax(tmp_path, container):
    """The port's CLI and the JAX package's function write the same jpg
    bytes; the mp4 case needs an imageio mp4 reader (skipped without one)."""
    imageio = pytest.importorskip("imageio")
    frames = video(np.random.default_rng(4), t=5)
    path = str(tmp_path / f"v.{container}")
    (write_mp4 if container == "mp4" else write_gif)(path, frames)
    if container == "mp4":
        try:
            imageio.get_reader(path).close()
        except Exception as e:  # no ffmpeg or pyav plugin here
            pytest.skip(f"imageio cannot read mp4 here: {e}")
    mp4_cli.main(["--video-path", path, "--output-folder", str(tmp_path / "port")])
    jvideo_io.mp4_to_frames(path, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"{i:05d}.jpg" for i in range(5)]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def test_mp4_to_frames_without_imageio(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="needs the imageio package"):
        video_io.mp4_to_frames(str(tmp_path / "v.mp4"), str(tmp_path / "out"))
