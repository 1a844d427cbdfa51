"""The port's ViT feature stage of preprocessing — fg masks from the feature
PCA, the fg/bg trajectory split, and ``PreprocessingPipeline`` stages 2-4 on
a tiny on-disk video — held against the JAX package's functions on the CPU.

The JAX ``PreprocessingPipeline`` is not constructed here: its constructor
turns on JAX's persistent compile cache. Its stages are replayed from the
functions it calls, on the same frames and weights.

Tolerances: masks equal except pixels whose first PCA component lies within
1e-5 of the threshold (the two eigensolvers and reductions round
differently); the split bit-equal; f16 feature artifacts within the f32
feature tolerance (1e-4 of max) plus one f16 ulp of each value.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_tracker_tpu.models import vit as jvit
from dino_tracker_tpu.preprocessing import fg_mask as jfg
from dino_tracker_tpu.preprocessing import split_fg_bg as jsplit
from dino_tracker_tpu.utils import video_io as jvideo_io
from dino_tracker_tpu_torch.config import PreprocessConfig
from dino_tracker_tpu_torch.preprocessing import fg_mask, split_fg_bg
from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
from dino_tracker_tpu_torch.utils import video_io
from test_torch_vit import SMALL, jax_cfg, models

NEAR = 1e-5  # |comp0 - threshold| below this may flip between the packages


def scene_features(t, c, hp, wp, seed):
    """T×C×h'×w' features: a foreground blob in the middle, background on
    the border, plus noise."""
    rng = np.random.default_rng(seed)
    fg_dir, bg_dir = rng.standard_normal((2, c, 1, 1))
    yy, xx = np.mgrid[:hp, :wp]
    blob = (((yy - hp / 2) / (hp / 3)) ** 2 + ((xx - wp / 2) / (wp / 3)) ** 2) < 1
    feats = np.where(blob[None, None], fg_dir[None], bg_dir[None])
    return (feats + 0.8 * rng.standard_normal((t, c, hp, wp))).astype(np.float32)


def assert_masks_match(ours, ref, comp0, out_hw, threshold):
    """Equal masks, except where the comp0 cell of a pixel is within NEAR of
    the threshold."""
    h, w = out_hw
    hp, wp = comp0.shape[1:]
    near = np.abs(comp0 - threshold) < NEAR
    near = near[:, (np.arange(h) * hp) // h][:, :, (np.arange(w) * wp) // w]
    assert ours.shape == ref.shape == near.shape
    assert ((ours == ref) | near).all()
    assert near.mean() < 0.01


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fg_masks_match_jax(seed):
    feats = scene_features(3, 24, 9, 13, seed)
    if seed == 2:  # the other sign of the first component: the border rule
        feats = -feats
    out_hw = (40, 60)
    ref = jfg.compute_fg_masks(feats, out_hw, fg_mask_threshold=0.6)
    ours = fg_mask.compute_fg_masks(torch.from_numpy(feats), out_hw, 0.6)
    assert ours.dtype == torch.float32
    comp0 = fg_mask.first_component(torch.from_numpy(feats)).numpy()
    assert_masks_match(ours.numpy(), ref, comp0, out_hw, 0.6)
    # the blob is foreground whatever the sign of the eigenvector
    assert ours[:, 20, 30].eq(1).all() and ours[:, 0, 0].eq(0).all()


def test_split_fg_bg_bit_equal():
    rng = np.random.default_rng(3)
    t, h, w, n = 6, 20, 30, 500
    trajs = np.stack([rng.uniform(-2, w + 1, (n, t)), rng.uniform(-2, h + 1, (n, t))],
                     -1).astype(np.float32)
    trajs[rng.random((n, t)) < 0.3] = np.nan  # late starts and gaps
    masks = (rng.random((t, h, w)) < 0.4).astype(np.float32) * 255
    ours = split_fg_bg.split_fg_bg(trajs, masks)
    ref = jsplit.split_fg_bg(trajs, masks)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    assert len(ours[0]) and len(ours[1])


@pytest.mark.parametrize("channels", [(), (3,)])
def test_save_video_frames_matches_jax_bytes(tmp_path, channels):
    """The port writes jpgs with Pillow, the JAX package with imageio (which
    writes through Pillow): the same bytes, and the same masks read back."""
    rng = np.random.default_rng(5)
    frames = ((rng.random((3, 20, 30) + channels) < 0.4) * 255).astype(np.uint8)
    ours = video_io.save_video_frames(frames, str(tmp_path / "ours"))
    ref = jvideo_io.save_video_frames(frames, str(tmp_path / "ref"))
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and len(names) == 3
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes()
    np.testing.assert_array_equal(video_io.load_masks(str(ours), 40, 60),
                                  jvideo_io.load_masks(str(ref), 40, 60))


def write_frames(folder, video):
    os.makedirs(folder)
    for i, f in enumerate(video):
        Image.fromarray(np.round(f.transpose(1, 2, 0) * 255).astype(np.uint8)
                        ).save(os.path.join(folder, f"{i:05d}.png"))


def test_pipeline_stages_2_to_4_match_jax(tmp_path):
    """Stages 2-4 on a tiny video: one sweep for layers 1 and 2, f16
    artifacts, masks from layer 2 written as jpgs and read back, the split
    of synthetic trajectories; against the JAX functions on the same frames
    and weights."""
    h, w, t = 42, 56, 4
    root = str(tmp_path / "vid")
    rng = np.random.default_rng(4)
    write_frames(os.path.join(root, "video"), rng.random((t, 3, h, w)))
    cfg = PreprocessConfig(video_resh=h, video_resw=w, dino_layer=1,
                           mask_dino_layer=2, compute_dtype="float32",
                           extract_frames_per_batch=3)
    params, model = models(SMALL, seed=11)
    pipe = PreprocessingPipeline(root, cfg, vit=model, device=torch.device("cpu"))
    paths = pipe.paths
    feats, mask_feats = pipe.extract_dino_features(
        [1, 2], [paths["dino_embed_video_path"], paths["mask_dino_embed_video_path"]])
    masks = pipe.create_fg_masks(mask_feats)
    trajs = np.stack([rng.uniform(0, w - 1, (400, t)), rng.uniform(0, h - 1, (400, t))],
                     -1).astype(np.float32)
    trajs[rng.random((400, t)) < 0.2] = np.nan
    fg, bg = pipe.split_trajectories(trajs)
    pipe.join_saves()

    # the JAX package's stages on the same frames and weights
    video = jvideo_io.load_video(paths["video_folder"], resize=(h, w))
    jf, jmask_f = jvit.extract_feature_video(params, jnp.asarray(video), jax_cfg(SMALL),
                                             stride=7, layer=[1, 2],
                                             frames_per_batch=3, attn_impl="xla")
    for path, ref in ((paths["dino_embed_video_path"], jf),
                      (paths["mask_dino_embed_video_path"], jmask_f)):
        art = video_io.load_npz(path)["features"]
        ref = np.asarray(ref)
        assert art.dtype == np.float16 and art.shape == ref.shape == (t, 32, 5, 7)
        err = np.abs(art.astype(np.float32) - ref.astype(np.float16).astype(np.float32))
        bound = 1e-4 * np.abs(ref).max() + 2.0 ** -10 * np.abs(ref)
        assert (err <= bound).all(), err.max()
    jmasks = jfg.compute_fg_masks(np.asarray(jmask_f), (h, w), cfg.fg_mask_threshold)
    comp0 = fg_mask.first_component(mask_feats).numpy()
    assert_masks_match(masks, jmasks, comp0, (h, w), cfg.fg_mask_threshold)
    jdir = str(tmp_path / "jax_masks")
    jvideo_io.save_video_frames((jmasks * 255).astype(np.uint8), jdir)
    jfg_t, jbg_t = jsplit.split_fg_bg(trajs, jvideo_io.load_masks(jdir, h, w))
    np.testing.assert_array_equal(fg, jfg_t)
    np.testing.assert_array_equal(bg, jbg_t)
    for name, ref in (("fg_trajectories_file", fg), ("bg_trajectories_file", bg)):
        np.testing.assert_array_equal(
            video_io.load_npz(paths[name])["trajectories"], ref)
    assert 0 < masks.mean() < 1


def test_join_saves_reraises_writer_failure(tmp_path):
    root = str(tmp_path / "vid")
    write_frames(os.path.join(root, "video"), np.zeros((2, 3, 42, 56)))
    _, model = models(SMALL, seed=12)
    pipe = PreprocessingPipeline(root, PreprocessConfig(video_resh=42, video_resw=56,
                                                        compute_dtype="float32"),
                                 vit=model, device=torch.device("cpu"))
    blocker = str(tmp_path / "not_a_dir")
    open(blocker, "w").close()
    pipe.extract_dino_features(1, os.path.join(blocker, "f.npz"))
    with pytest.raises(OSError):
        pipe.join_saves()
    pipe.join_saves()  # nothing left to join
