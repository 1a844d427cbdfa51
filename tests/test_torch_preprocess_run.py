"""The port's whole preprocessing — ``PreprocessingPipeline.run()`` and
``cli/preprocess.py`` — on a tiny PNG folder, held against a replay of the
JAX package's stage functions on the CPU.

The JAX ``PreprocessingPipeline`` is not built here (its constructor turns
on JAX's persistent compile cache); its ``run()`` is replayed from the
functions it calls, with the same weights carried across. Stage 5 is
replayed on the port's own f32 features and unfiltered trajectories, so
upstream rounding cannot move an argmax. Tolerances: trajectories as in
``test_torch_trajectories.py`` (counts and NaN pattern equal, 1e-4 px), f16
features and masks as in ``test_torch_vit_preprocess.py``, the split and
every best-buddy coordinate and validity equal, cos within 1e-5 of max, r
within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tracker_tpu.models import raft as jraft
from dino_tracker_tpu.models import vit as jvit
from dino_tracker_tpu.preprocessing import best_buddies as jbb
from dino_tracker_tpu.preprocessing import fg_mask as jfg
from dino_tracker_tpu.preprocessing import flow as jflow
from dino_tracker_tpu.preprocessing import split_fg_bg as jsplit
from dino_tracker_tpu.preprocessing import trajectories as jtraj
from dino_tracker_tpu.utils import video_io as jvideo_io
from dino_tracker_tpu_torch.cli import preprocess as preprocess_cli
from dino_tracker_tpu_torch.cli import train as train_cli
from dino_tracker_tpu_torch.config import PreprocessConfig
from dino_tracker_tpu_torch.models import raft as praft
from dino_tracker_tpu_torch.models import vit as pvit
from dino_tracker_tpu_torch.preprocessing import fg_mask
from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
from dino_tracker_tpu_torch.structures import load_bb_data
from dino_tracker_tpu_torch.training import checkpoint as ckpt
from dino_tracker_tpu_torch.utils import video_io
from test_torch_best_buddies import assert_bb_equal
from test_torch_trajectories import video, write_frames
from test_torch_vit import SMALL, jax_cfg, models
from test_torch_vit_attention import dinov2_state_dict
from test_torch_vit_preprocess import assert_masks_match

CPU = torch.device("cpu")
T, H, W = 5, 42, 56
STAGES = ["preprocess/trajectories", "preprocess/dino_features", "preprocess/fg_masks",
          "preprocess/split_fg_bg", "preprocess/unfiltered_trajectories",
          "preprocess/best_buddies"]
SETTINGS = dict(video_resh=H, video_resw=W, raft_iters=3, threshold=0.5,
                direct_flow_threshold=0.25, dino_layer=1, mask_dino_layer=2,
                compute_dtype="float32", extract_frames_per_batch=3)
ARTIFACTS = ("trajectories_file", "unfiltered_trajectories_file", "fg_trajectories_file",
             "bg_trajectories_file", "dino_embed_video_path", "mask_dino_embed_video_path")


@pytest.fixture(scope="module")
def weights():
    """(JAX RAFT params, port RAFT, JAX ViT params, port ViT) from seeds."""
    params = jax.tree.map(np.asarray, jraft.init_raft(jax.random.PRNGKey(5)))
    vit_params, vit = models(SMALL, seed=21)
    return (params, praft.load_raft_state_dict(praft.raft_state_from_jax(params), CPU),
            vit_params, vit)


def video_dir(tmp_path, name="vid"):
    root = str(tmp_path / name)
    write_frames(os.path.join(root, "video"), video(2, T, H, W))
    return root


def bb_path(paths, name="dino_best_buddies_filtered.npz"):
    return os.path.join(paths["dino_bb_dir"], name)


def test_run_matches_jax_replay(tmp_path, weights):
    params, raft, vit_params, vit = weights
    root = video_dir(tmp_path)
    cfg = PreprocessConfig(**SETTINGS)
    pipe = PreprocessingPipeline(root, cfg, vit=vit, device=CPU, raft=raft)
    pipe.run()
    paths = pipe.paths
    assert [k for k in pipe.timings if k.startswith("preprocess/")] == STAGES
    assert {"bb_closest_grids", "bb_sweep", "bb_compaction", "bb_ambiguity",
            "bb_save"} <= set(pipe.timings)
    art = {k: video_io.load_npz(paths[k]) for k in ARTIFACTS}

    # stage 1: the JAX dual sweep on its own engine's flows
    frames = jvideo_io.load_video(paths["video_folder"], resize=(H, W))
    eng = jflow.RaftFlowEngine(params, frames, num_iters=3)
    fwd, bwd = eng.adjacent_flows()
    want_f, want_u = jtraj.extract_trajectories_dual(
        fwd, bwd, threshold=0.5, min_trajectory_length=2, direct_flow_threshold=0.25,
        direct_flow_fn=lambda s: eng.direct_flows(s, 0.5))
    trajs = art["trajectories_file"]["trajectories"]
    unfiltered = art["unfiltered_trajectories_file"]["trajectories"]
    for got, want in ((trajs, want_f), (unfiltered, want_u)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(want_f) != len(want_u) and len(want_u)

    # stages 2-3: one ViT sweep for layers 1 and 2, masks from layer 2
    jf, jmask_f = jvit.extract_feature_video(vit_params, jnp.asarray(frames), jax_cfg(SMALL),
                                             stride=7, layer=[1, 2], frames_per_batch=3,
                                             attn_impl="xla")
    for key, ref in (("dino_embed_video_path", jf), ("mask_dino_embed_video_path", jmask_f)):
        got, ref = art[key]["features"], np.asarray(ref)
        assert got.dtype == np.float16 and got.shape == ref.shape == (T, 32, 5, 7)
        err = np.abs(got.astype(np.float32) - ref.astype(np.float16).astype(np.float32))
        assert (err <= 1e-4 * np.abs(ref).max() + 2.0 ** -10 * np.abs(ref)).all()
    # the port's own f32 features, as run() kept them on the device
    feats, mask_feats = pvit.extract_feature_video(vit, torch.from_numpy(frames), stride=7,
                                                   layer=[1, 2], frames_per_batch=3)
    masks = video_io.load_masks(paths["masks_path"], H, W)
    jmasks = jfg.compute_fg_masks(np.asarray(jmask_f), (H, W), cfg.fg_mask_threshold)
    assert_masks_match((masks > 127).astype(np.float32), jmasks,
                       fg_mask.first_component(mask_feats).numpy(), (H, W),
                       cfg.fg_mask_threshold)

    # stage 4: the split of the masks on disk
    jfg_t, jbg_t = jsplit.split_fg_bg(trajs, jvideo_io.load_masks(paths["masks_path"], H, W))
    np.testing.assert_array_equal(art["fg_trajectories_file"]["trajectories"], jfg_t)
    np.testing.assert_array_equal(art["bg_trajectories_file"]["trajectories"], jbg_t)

    # stage 5 on the port's f32 features and unfiltered trajectories
    jtel = {}
    ref = jbb.extract_best_buddies(jnp.asarray(feats.numpy()), H, W, 7,
                                   unfiltered_trajectories=unfiltered, telemetry=jtel)
    ref = jbb.compute_bb_ambiguity(ref, jnp.asarray(feats.numpy()), H, W, 7)
    bb = load_bb_data(bb_path(paths))
    assert_bb_equal(bb, ref)
    assert bb.valid.any() and (bb.r[bb.valid] < 1).any()
    with open(bb_path(paths, "bb_truncation.json")) as f:
        tel = json.load(f)
    assert tel.pop("phases").keys() == {"closest_grids_s", "sweep_s", "compaction_s"}
    jtel.pop("phases")
    assert tel == jtel
    assert pipe.telemetry["bb_ambiguity"]["rows_total"] == int(
        bb.valid.sum()) - int(bb.valid.diagonal().sum())


def test_run_without_direct_filter_and_with_masks(tmp_path, weights, caplog):
    """The filter off: one chaining pass serves both trajectory artifacts.
    Masks on disk: the fg-mask stage is skipped, the masks stay as they
    were and only the training layer is swept."""
    _, raft, _, vit = weights
    root = video_dir(tmp_path)
    masks = (np.random.default_rng(22).random((T, H, W)) < 0.5).astype(np.uint8) * 255
    video_io.save_video_frames(masks, os.path.join(root, "masks"))
    before = {n: open(os.path.join(root, "masks", n), "rb").read()
              for n in sorted(os.listdir(os.path.join(root, "masks")))}
    cfg = PreprocessConfig(filter_using_direct_flow=False,
                           mask_dino_model_name="dinov2_vits14", **SETTINGS)
    pipe = PreprocessingPipeline(root, cfg, vit=vit, device=CPU, raft=raft)
    with caplog.at_level("INFO"):
        pipe.run()
    assert "masks exist, skipping fg-mask stage" in caplog.text
    assert "mask_dino_model_name" not in caplog.text  # warned only when masks are made
    assert "preprocess/fg_masks" not in pipe.timings
    assert "direct_sweep_and_chaining" not in pipe.timings and "chaining" in pipe.timings
    paths = pipe.paths
    assert not os.path.exists(paths["mask_dino_embed_video_path"])
    assert {n: open(os.path.join(root, "masks", n), "rb").read() for n in before} == before
    filtered = video_io.load_npz(paths["trajectories_file"])["trajectories"]
    unfiltered = video_io.load_npz(paths["unfiltered_trajectories_file"])["trajectories"]
    assert len(filtered)
    np.testing.assert_array_equal(filtered, unfiltered)
    assert os.path.exists(bb_path(paths))


def test_run_needs_weights(tmp_path, weights):
    _, raft, _, _ = weights
    root = video_dir(tmp_path)
    for kw, what in ((dict(), "RAFT weights"), (dict(raft=raft), "DINO weights")):
        pipe = PreprocessingPipeline(root, PreprocessConfig(**SETTINGS), device=CPU, **kw)
        with pytest.raises(ValueError, match=what):
            pipe.run()


def write_checkpoints_and_config(tmp_path, raft_params):
    """A princeton-vl RAFT ``.pth`` of ``raft_params``, a seeded DINOv2
    ViT-S/14 ``.pth`` and a preprocessing yaml of ``SETTINGS`` under
    ``tmp_path``; returns (raft path, ViT path, yaml path)."""
    raft_path, vit_path = str(tmp_path / "raft.pth"), str(tmp_path / "vits14.pth")
    torch.save({f"module.{k}": v for k, v in praft.raft_state_from_jax(raft_params).items()},
               raft_path)
    vits = pvit.ViTConfig.for_model("dinov2_vits14")
    torch.save({k: torch.from_numpy(v) for k, v in dinov2_state_dict(vits, 23).items()},
               vit_path)
    config = str(tmp_path / "preprocessing.yaml")
    with open(config, "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in SETTINGS.items())
                + "dino_model_name: dinov2_vits14\nmask_dino_model_name: dinov2_vits14\n")
    return raft_path, vit_path, config


def write_train_config(path, iterations=2, gates_after=1, checkpoint_interval=2):
    """A train yaml at the tiny video's size for the ViT-S/14 features."""
    with open(path, "w") as f:
        f.write(f"video_resh: {H}\nvideo_resw: {W}\n"
                "dino_model_name: dinov2_vits14\ncompute_dtype: float32\n"
                f"total_iterations: {iterations}\ncheckpoint_interval: {checkpoint_interval}\n"
                f"apply_cyc_after: {gates_after}\napply_cl_ref_after: {gates_after}\n"
                "train_batch_size: 16\nbatch_n_frames: 3\n"
                "cyc_n_frames: 2\ncyc_batch_size_per_frame: 8\n"
                "cl_n_frames: 2\ncl_points_per_pair: 16\n")
    return str(path)


def test_preprocess_cli_then_train_cli(tmp_path, weights):
    """``cli.preprocess --device cpu`` on checkpoints written here (a
    princeton-vl RAFT ``.pth`` and a DINOv2 ViT-S/14 ``.pth``) writes every
    artifact; ``cli.train`` trains on the directory; ``--devices 2`` is
    refused."""
    root = video_dir(tmp_path)
    raft_path, vit_path, config = write_checkpoints_and_config(tmp_path, weights[0])
    args = ["--config", config, "--data-path", root, "--raft-checkpoint", raft_path,
            "--dino-checkpoint", vit_path, "--device", "cpu"]
    with pytest.raises(SystemExit):
        preprocess_cli.main(args + ["--devices", "2"])
    pipe = preprocess_cli.main(args)
    assert [k for k in pipe.timings if k.startswith("preprocess/")] == STAGES
    for key in ARTIFACTS:
        assert os.path.exists(pipe.paths[key]), key
    assert video_io.load_npz(pipe.paths["dino_embed_video_path"])["features"].shape == (
        T, 384, 5, 7)
    assert len(os.listdir(pipe.paths["masks_path"])) == T
    for name in ("bb_truncation.json", "dino_best_buddies_filtered.npz"):
        assert os.path.exists(bb_path(pipe.paths, name))

    train_yaml = write_train_config(tmp_path / "train.yaml")
    train_cli.main(["--config", train_yaml, "--data-path", root, "--device", "cpu"])
    assert ckpt.checkpoint_steps(os.path.join(root, "models", "dino_tracker")) == [2]
