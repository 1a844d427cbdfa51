"""Per-video runtime of the port (single device): training and inference.

Port of dino_tracker_tpu/runtime.py: binds a video's on-disk artifacts
(frames, the DINO feature stack, fg masks, trajectories, best buddies, a
checkpoint) to tensors on one device, trains the per-video model and serves
trajectory and occlusion queries. The path contract and ``TrainConfig``
(``config.py``), frame loading (``utils/video_io.py``) and TAP-Vid query
points (``evaluation/tapvid.py``) are the port's own copies; Pillow is
imported only where frames are read.

Checkpoints: the port's trainer writes ``state_<step>.pt``; inference loads
the newest of those, and otherwise a ``state_<step>.msgpack`` written by the
JAX trainer. ``make_model_inference`` and ``load_model`` are the in-memory
entry points under ``DINOTrackerRuntime``: they take tensors, a model or a
checkpoint folder, and need no config file.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from . import convert
from .config import (TrackerConfig, TrainConfig, add_config_paths,
                     tracker_config_from_train)
from .evaluation.tapvid import get_query_points_from_benchmark_config
from .inference.infer import ModelInference
from .models import tracker as tracker_lib
from .structures import load_bb_data
from .training import checkpoint as ckpt_lib
from .training import train as train_lib
from .training.sampler import BankRotator, build_bank
from .utils import video_io
from .utils.profiling import stage_timer

logger = logging.getLogger(__name__)


def load_model(ckpt_folder: str, tcfg: TrackerConfig, device: torch.device,
               step: Optional[int] = None) -> tracker_lib.Tracker:
    """The trained model of a checkpoint, on ``device``: the port's newest
    ``state_<step>.pt`` (or that of ``step``), else the JAX trainer's
    ``state_<step>.msgpack``."""
    model = tracker_lib.Tracker(tcfg)
    port_steps = ckpt_lib.checkpoint_steps(ckpt_folder)
    if port_steps and (step is None or step in port_steps):
        state = ckpt_lib.load_state(ckpt_folder, port_steps[0] if step is None
                                    else step, map_location="cpu")
        model.load_state_dict(state["model"])
    else:
        state = convert.load_jax_checkpoint(
            convert.checkpoint_path(ckpt_folder, step))
        model.load_state_dict(convert.state_from_jax(state["params"],
                                                     state["batch_stats"]))
    return model.to(device)


def make_model_inference(model: tracker_lib.Tracker, video_tchw: torch.Tensor,
                         dino_embed_tchw: torch.Tensor, tcfg: TrackerConfig,
                         anchor_cosine_similarity_threshold: float,
                         cosine_similarity_threshold: float,
                         chunk: int = 4096) -> ModelInference:
    """Refine every frame's features (eval mode) and wrap them for queries.

    ``video_tchw`` T×3×H×W in [0, 1] and ``dino_embed_tchw`` T×C×h'×w' (the
    f16 artifact) lie on the device the model lives on."""
    want = tcfg.delta_channels[-1]
    if dino_embed_tchw.shape[1] != want:
        raise ValueError(
            f"feature stack has {dino_embed_tchw.shape[1]} channels but the "
            f"refiner emits {want}: the video was preprocessed with a "
            "different DINO variant than this config")
    model.eval()
    refined = tracker_lib.cache_refined_embeddings(model, video_tchw,
                                                   dino_embed_tchw, tcfg)
    return ModelInference(
        model=model, refined_features=refined, cfg=tcfg,
        anchor_cosine_similarity_threshold=anchor_cosine_similarity_threshold,
        cosine_similarity_threshold=cosine_similarity_threshold, chunk=chunk)


@dataclasses.dataclass
class DINOTrackerRuntime:
    data_path: str
    cfg: TrainConfig
    device: torch.device = torch.device("cuda")
    seed: int = 2

    def __post_init__(self):
        self.paths = add_config_paths(self.data_path)
        self.tcfg = tracker_config_from_train(self.cfg)

    def load_video_data(self) -> train_lib.VideoData:
        """Every training artifact of the video, on this runtime's device
        (JAX runtime.py:61-106). The feature stack stays f16 (the artifact
        dtype); the step upcasts the gathered frames, which is exact."""
        dev = self.device
        dino = video_io.load_npz(self.paths["dino_embed_video_path"])["features"]
        want = self.tcfg.delta_channels[-1]
        if dino.shape[1] != want:
            raise ValueError(
                f"feature artifact has {dino.shape[1]} channels but the "
                f"refiner emits {want} (dino_model_name="
                f"{self.cfg.dino_model_name}): the video was preprocessed "
                "with a different DINO variant than this config trains")
        # preprocessing may have capped the video at max_frames; every
        # artifact takes the feature video's length
        t_feat = dino.shape[0]
        video = video_io.load_video(
            self.paths["video_folder"],
            resize=(self.cfg.video_resh, self.cfg.video_resw),
            num_frames=t_feat)
        if video.shape[0] != t_feat:
            raise ValueError(f"video has {video.shape[0]} frames but the "
                             f"features cover {t_feat}")
        fg_masks = video_io.load_masks(self.paths["masks_path"],
                                       h_resize=self.cfg.video_resh,
                                       w_resize=self.cfg.video_resw)[:t_feat]
        bb = load_bb_data(os.path.join(self.paths["dino_bb_dir"],
                                       "dino_best_buddies_filtered.npz"), dev)
        fg = video_io.load_npz(self.paths["fg_trajectories_file"])["trajectories"]
        bg = video_io.load_npz(self.paths["bg_trajectories_file"])["trajectories"]
        self.bank_rotator = None
        if self.cfg.keep_traj_in_cpu:
            self.bank_rotator = BankRotator(fg, bg, device=dev)
            fg_bank, bg_bank = self.bank_rotator.current()
        else:
            fg_bank, bg_bank = build_bank(fg, device=dev), build_bank(bg, device=dev)
        return train_lib.VideoData(
            video=torch.from_numpy(video).to(dev),
            dino_embed=torch.from_numpy(dino).to(dev),
            fg_masks=torch.from_numpy(fg_masks).to(dev), bb=bb,
            fg_bank=fg_bank, bg_bank=bg_bank)

    def train(self) -> tracker_lib.Tracker:
        """Train (or resume) this video's model; checkpoints go to
        ``models/dino_tracker/state_<step>.pt``. Loading the artifacts is
        a stage timer (``train/load_data``), fenced on the device."""
        with stage_timer("train/load_data", fence=self.device):
            data = self.load_video_data()
        return train_lib.Trainer(
            cfg=self.cfg, tcfg=self.tcfg, data=data,
            ckpt_folder=self.paths["ckpt_folder"], seed=self.seed,
            bank_rotator=self.bank_rotator, device=self.device).train()

    def load_state(self, step: Optional[int] = None) -> tracker_lib.Tracker:
        """The trained model (see ``load_model``) on this runtime's device."""
        return load_model(self.paths["ckpt_folder"], self.tcfg, self.device,
                          step)

    def get_model_inference(self, step: Optional[int] = None,
                            chunk: int = 4096) -> ModelInference:
        dino = video_io.load_npz(self.paths["dino_embed_video_path"])["features"]
        video = video_io.load_video(
            self.paths["video_folder"],
            resize=(self.cfg.video_resh, self.cfg.video_resw),
            num_frames=dino.shape[0])
        return make_model_inference(
            self.load_state(step),
            torch.from_numpy(video).to(self.device),
            torch.from_numpy(dino).to(self.device), self.tcfg,
            self.cfg.anchor_cosine_similarity_threshold,
            self.cfg.cosine_similarity_threshold, chunk)

    def infer_benchmark(self, benchmark_pickle_path: str, video_id: int,
                        step: Optional[int] = None, chunk: int = 4096):
        """Per-query-frame trajectory/occlusion predictions saved as .npy
        (reference inference_benchmark.py:13-41). The refine and each query
        frame's request are stage timers (``inference/refine``,
        ``inference/query_frame_<f>``), fenced on the device."""
        with stage_timer("inference/refine", fence=self.device):
            mi = self.get_model_inference(step, chunk)
        qp = get_query_points_from_benchmark_config(
            benchmark_pickle_path, video_id,
            rescale_sizes=[self.cfg.video_resw, self.cfg.video_resh])
        os.makedirs(self.paths["trajectories_dir"], exist_ok=True)
        os.makedirs(self.paths["occlusions_dir"], exist_ok=True)
        for frame_idx in sorted(qp.keys()):
            pts = np.asarray(qp[frame_idx], np.float32)
            with stage_timer(f"inference/query_frame_{frame_idx}", fence=self.device):
                trajs, occ = mi.infer(pts)
            np.save(os.path.join(self.paths["trajectories_dir"],
                                 f"trajectories_{frame_idx}.npy"), trajs)
            np.save(os.path.join(self.paths["occlusions_dir"],
                                 f"occlusion_preds_{frame_idx}.npy"), occ)
            logger.info("saved predictions for query frame %d (%d points)",
                        frame_idx, len(pts))

    def infer_grid(self, interval: int = 10, start_frame: int = 0,
                   use_segm_mask: bool = False, step: Optional[int] = None,
                   chunk: int = 4096):
        """Every-``interval``-px grid queries on one frame (reference
        inference_grid.py:12-41), in original-resolution pixels scaled to the
        model resolution."""
        orig_h, orig_w, _ = video_io.get_original_video_res(
            self.paths["video_folder"])
        mi = self.get_model_inference(step, chunk)
        segm = None
        if use_segm_mask:
            segm = video_io.load_masks(self.paths["masks_path"],
                                       h_resize=None, w_resize=None)[start_frame]
        qp = video_io.get_grid_query_points((orig_h, orig_w), segm_mask=segm,
                                            interval=interval,
                                            query_frame=start_frame)
        scale = np.asarray([self.cfg.video_resw / orig_w,
                            self.cfg.video_resh / orig_h, 1.0], np.float32)
        trajs, occ = mi.infer(qp * scale)
        os.makedirs(self.paths["grid_trajectories_dir"], exist_ok=True)
        os.makedirs(self.paths["grid_occlusions_dir"], exist_ok=True)
        np.save(os.path.join(self.paths["grid_trajectories_dir"],
                             "grid_trajectories.npy"), trajs)
        np.save(os.path.join(self.paths["grid_occlusions_dir"],
                             "grid_occlusions.npy"), occ)
        return trajs, occ
