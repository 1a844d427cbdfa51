"""The port's inference slice as a whole, held against the JAX package:
``cache_refined_embeddings`` -> ``ModelInference.infer``, and the port's
runtime/CLIs on a tiny on-disk video with a checkpoint the JAX trainer wrote.

Weights are the converted non-zero ones of test_torch_model_slice. Raw
features are well separated per position (as tests/test_inference.py makes
them), so the hard argmax has no ties. f32 with TF32 off; trajectories agree
within 1e-3 px and occlusion flags exactly.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_tracker_tpu.config import TrainConfig
from dino_tracker_tpu.inference.infer import ModelInference as JModelInference
from dino_tracker_tpu.models import tracker as jtracker
from dino_tracker_tpu.training import checkpoint as jckpt
from dino_tracker_tpu.training import train as jtrain
from dino_tracker_tpu.utils import video_io
from dino_tracker_tpu_torch import runtime
from dino_tracker_tpu_torch.cli import inference_benchmark, inference_grid
from dino_tracker_tpu_torch.inference.infer import ModelInference
from dino_tracker_tpu_torch.models import tracker
from test_torch_model_slice import H, W, configs, jax_weights, torch_model
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

T = 5
PX_TOL = 1e-3


def scene(c, seed=0, t=T):
    """Video frames and a per-position feature stack that drifts slowly over
    time (T×C×h'×w'), f16 like the artifact."""
    rng = np.random.default_rng(seed)
    hp, wp = configs()[1].feat_hw
    pos = rng.standard_normal((c, hp, wp)).astype(np.float32) * 3
    drift = rng.standard_normal((t, c, hp, wp)).astype(np.float32) * 0.6
    video = rng.random((t, 3, H, W), dtype=np.float32)
    return video, (pos[None] + drift).astype(np.float16)


QUERIES = np.array([[20.0, 30.0, 0.0], [50.0, 40.0, 2.0], [70.0, 10.0, 4.0],
                    [90.0, 60.0, 1.0], [5.0, 5.0, 3.0]], np.float32)


def jax_inference(params, stats, video, dino, jcfg):
    """The JAX package's refined cache and its inference runtime over it."""
    refined = jtracker.cache_refined_embeddings(
        params, stats, jnp.asarray(video), jnp.asarray(dino), jcfg,
        frames_chunk=4)
    mi = JModelInference(params=params, refined_features=refined, cfg=jcfg,
                         anchor_cosine_similarity_threshold=0.7,
                         cosine_similarity_threshold=0.6, chunk=64)
    return np.asarray(refined), mi


def test_slice_matches_jax():
    jcfg, pcfg = configs()
    params, stats = jax_weights(11)
    video, dino = scene(pcfg.delta_channels[-1])
    refined_j, mi_j = jax_inference(params, stats, video, dino, jcfg)
    trajs_j, occ_j = mi_j.infer(QUERIES)

    model = torch_model(params, stats, pcfg)
    refined = tracker.cache_refined_embeddings(
        model, torch.from_numpy(video), torch.from_numpy(dino), pcfg,
        frames_chunk=4)
    assert refined.shape == (T, *pcfg.feat_hw, pcfg.delta_channels[-1])
    np.testing.assert_allclose(refined.numpy(),
                               refined_j.transpose(0, 2, 3, 1),
                               rtol=1e-4, atol=1e-4)
    mi = ModelInference(model=model, refined_features=refined, cfg=pcfg,
                        anchor_cosine_similarity_threshold=0.7,
                        cosine_similarity_threshold=0.6, chunk=64)
    trajs, occ = mi.infer(QUERIES)
    assert trajs.shape == (len(QUERIES), T, 2) and occ.dtype == bool
    np.testing.assert_allclose(trajs, trajs_j, rtol=0, atol=PX_TOL)
    np.testing.assert_array_equal(occ, occ_j)


def test_refine_rejects_train_mode_and_other_feature_widths():
    """The refined cache needs eval-mode BN, and a feature stack from
    another DINO variant (other channel count) than the refiner emits is
    refused before any work."""
    _, pcfg = configs()
    params, stats = jax_weights(11)
    model = torch_model(params, stats, pcfg)
    video, dino = scene(pcfg.delta_channels[-1])
    with pytest.raises(ValueError, match="model.eval"):
        tracker.cache_refined_embeddings(model.train(), torch.from_numpy(video),
                                         torch.from_numpy(dino), pcfg)
    wide = np.concatenate([dino, dino], axis=1)
    with pytest.raises(ValueError, match="different DINO variant"):
        runtime.make_model_inference(model, torch.from_numpy(video),
                                     torch.from_numpy(wide), pcfg, 0.7, 0.6)


def write_video_dir(root, video, dino, state, step):
    frames = os.path.join(root, "video")
    os.makedirs(frames)
    for i, f in enumerate(video):
        Image.fromarray(np.round(f.transpose(1, 2, 0) * 255).astype(np.uint8)
                        ).save(os.path.join(frames, f"{i:05d}.png"))
    video_io.save_npz(os.path.join(root, "dino_embeddings",
                                   "dino_embed_video.npz"), features=dino)
    jckpt.save_state(os.path.join(root, "models", "dino_tracker"), state, step)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """A tiny per-video directory in the JAX package's layout, with a
    ``state_3.msgpack`` written by its trainer's save_state and a small
    ViT-S-width feature stack."""
    root = str(tmp_path_factory.mktemp("video"))
    cfg = TrainConfig(video_resh=H, video_resw=W, dino_model_name="dinov2_vits14",
                      compute_dtype="float32")
    channels = (3, 64, 128, 256, cfg.dino_embed_dim)
    jcfg, _ = configs(channels)
    params, stats = jax_weights(12, channels)
    state = jtrain.init_train_state(jax.random.PRNGKey(0), cfg, jcfg)
    state = state._replace(params=params, batch_stats=stats)
    video, dino = scene(cfg.dino_embed_dim, seed=1)
    write_video_dir(root, video, dino, state, 3)
    with open(os.path.join(root, "train.yaml"), "w") as f:
        f.write(f"video_resh: {H}\nvideo_resw: {W}\n"
                "dino_model_name: dinov2_vits14\ncompute_dtype: float32\n")
    bench = {"videos": [{"video_idx": 0, "h": H * 2, "w": W * 2,
                         "query_points": {0: [[40.0, 60.0], [100.0, 20.0]],
                                          3: [[150.0, 100.0]]}}]}
    with open(os.path.join(root, "bench.pkl"), "wb") as f:
        pickle.dump(bench, f)
    # the JAX package's inference on the same loaded frames and state
    loaded = video_io.load_video(os.path.join(root, "video"), resize=(H, W))
    queries = {0: np.array([[20.0, 30.0, 0.0], [50.0, 10.0, 0.0]], np.float32),
               3: np.array([[75.0, 50.0, 3.0]], np.float32)}
    grid = video_io.get_grid_query_points((H, W), interval=10)
    _, mi = jax_inference(params, stats, loaded, dino, jcfg)
    expect = {k: mi.infer(q) for k, q in [*queries.items(), ("grid", grid)]}
    return root, expect


def test_inference_benchmark_cli_matches_jax(video_dir):
    root, expect = video_dir
    inference_benchmark.main([
        "--config", os.path.join(root, "train.yaml"), "--data-path", root,
        "--benchmark-pickle-path", os.path.join(root, "bench.pkl"),
        "--device", "cpu"])
    for frame in (0, 3):
        trajs = np.load(os.path.join(root, "trajectories",
                                     f"trajectories_{frame}.npy"))
        occ = np.load(os.path.join(root, "occlusions",
                                   f"occlusion_preds_{frame}.npy"))
        np.testing.assert_allclose(trajs, expect[frame][0], rtol=0, atol=PX_TOL)
        np.testing.assert_array_equal(occ, expect[frame][1])


def test_inference_grid_cli_matches_jax(video_dir):
    root, expect = video_dir
    inference_grid.main(["--config", os.path.join(root, "train.yaml"),
                         "--data-path", root, "--iter", "3",
                         "--device", "cpu"])
    trajs = np.load(os.path.join(root, "grid_trajectories",
                                 "grid_trajectories.npy"))
    occ = np.load(os.path.join(root, "grid_occlusions", "grid_occlusions.npy"))
    np.testing.assert_allclose(trajs, expect["grid"][0], rtol=0, atol=PX_TOL)
    np.testing.assert_array_equal(occ, expect["grid"][1])
