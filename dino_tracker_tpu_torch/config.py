"""Configuration and on-disk path contract of the PyTorch port.

``TrackerConfig`` mirrors ``dino_tracker_tpu/models/tracker.py TrackerConfig``
minus the XLA code-path switches (``blurpool_impl``, ``reflect_pad_vjp``,
``bias_stopgrad``): on CUDA the blurpool always runs the hand-written kernel.
``add_config_paths``, ``TrainConfig`` and ``PreprocessConfig`` are the port's
own copies of ``dino_tracker_tpu/config.py`` (the port imports nothing of the
JAX package), with the same fields, defaults and artifact layout, so both
packages read each other's files. PyYAML is imported only inside
``from_yaml``: the GPU machine may lack it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch


def feature_grid_size(h: int, w: int, patch_size: int = 14,
                      stride: int = 7) -> Tuple[int, int]:
    """Spatial size of the overlapping-patch ViT feature grid:
    h' = 1 + (h - patch) // stride (same as dino_tracker_tpu.config)."""
    return 1 + (h - patch_size) // stride, 1 + (w - patch_size) // stride


def add_config_paths(data_path: str, config: Optional[dict] = None) -> dict:
    """Map a per-video ``data_path`` to every artifact path of the pipeline
    (the reference's utils.py:10-29 contract, with ``.npz`` containers)."""
    config = dict(config) if config else {}
    j = os.path.join
    # preprocessing artifacts
    config["video_folder"] = j(data_path, "video")
    config["trajectories_file"] = j(data_path, "of_trajectories", "trajectories.npz")
    config["unfiltered_trajectories_file"] = j(
        data_path, "of_trajectories", "trajectories_wo_direct_filter.npz")
    config["fg_trajectories_file"] = j(data_path, "of_trajectories", "fg_trajectories.npz")
    config["bg_trajectories_file"] = j(data_path, "of_trajectories", "bg_trajectories.npz")
    config["dino_embed_video_path"] = j(data_path, "dino_embeddings", "dino_embed_video.npz")
    config["mask_dino_embed_video_path"] = j(
        data_path, "dino_embeddings", "dino_embed_video-layer=23.npz")
    config["dino_bb_dir"] = j(data_path, "dino_best_buddies")
    config["masks_path"] = j(data_path, "masks")
    # model checkpoints
    config["ckpt_folder"] = j(data_path, "models", "dino_tracker")
    # outputs
    config["trajectories_dir"] = j(data_path, "trajectories")
    config["occlusions_dir"] = j(data_path, "occlusions")
    config["grid_trajectories_dir"] = j(data_path, "grid_trajectories")
    config["grid_occlusions_dir"] = j(data_path, "grid_occlusions")
    config["model_vis_dir"] = j(data_path, "visualizations")
    return config


def _from_yaml(cls, path: str):
    import yaml
    with open(path, "r") as f:
        raw = yaml.safe_load(f.read()) or {}
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """All training hyper-parameters (reference config/train.yaml)."""

    # checkpointing
    checkpoint_interval: int = 2500
    # data loader
    video_resw: int = 854
    video_resh: int = 476
    fg_traj_ratio: float = 0.5
    keep_traj_in_cpu: bool = False
    train_batch_size: int = 512
    batch_n_frames: int = 4
    sampler_batch_iterations: int = 100_000
    # optimization
    total_iterations: int = 10_000
    lr_delta_dino: float = 0.01
    lr_cnn_refiner: float = 0.01
    apply_scheduler_every: int = 40
    scheduler_gamma: float = 0.999
    # cycle-consistency loss
    lambda_cyc: float = 0.5
    apply_cyc_after: int = 5000
    cyc_n_frames: int = 4
    cyc_batch_size_per_frame: int = 256
    cyc_fg_points_ratio: float = 0.7
    cyc_thresh: float = 4.0
    cyc_gamma: float = 0.8
    # refined feature regularization
    lambda_emb_norm: float = 0.0001
    lambda_angle: float = 0.0001
    # contrastive losses
    lambda_cl_dino_bb: float = 0.00025
    lambda_cl_ref_bb: float = 0.00005
    cl_n_frames: int = 4
    cl_points_per_pair: int = 256
    cl_fg_points_ratio: float = 0.7
    cl_temp: float = 0.1
    cl_div_dino_bb: float = 700.0
    cl_div_ref_bb: float = 900.0
    apply_cl_ref_after: int = 5000
    # ambiguity weighting
    bb_amb_sig_a: float = 27.0
    bb_amb_sig_b: float = -5.7
    # DINO backbone
    stride: int = 7
    dino_patch_size: int = 14
    # occlusion prediction
    anchor_cosine_similarity_threshold: float = 0.7
    cosine_similarity_threshold: float = 0.6
    # DINO variant (sets the feature dim the DeltaDINO refiner must emit)
    dino_model_name: str = "dinov2_vitl14"
    # padded best-buddy capacity; None = adaptive
    bb_max_pairs_per_frame_pair: Optional[int] = None
    compute_dtype: str = "bfloat16"  # conv/GEMM operand dtype
    steps_per_call: int = 25  # read for file compatibility; the port steps one at a time

    @property
    def dino_embed_dim(self) -> int:
        dims = {"vits": 384, "vitb": 768, "vitl": 1024, "vitg": 1536}
        for key, dim in dims.items():
            if key in self.dino_model_name:
                return dim
        raise ValueError(f"unknown dino model {self.dino_model_name}")

    @classmethod
    def from_yaml(cls, path: str) -> "TrainConfig":
        return _from_yaml(cls, path)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Preprocessing hyper-parameters (reference config/preprocessing.yaml)."""

    video_resh: int = 476
    video_resw: int = 854
    # optical-flow trajectories
    min_trajectory_length: int = 2
    threshold: float = 1.5
    filter_using_direct_flow: bool = True
    direct_flow_threshold: float = 2.5
    raft_iters: int = 24
    raft_compute_dtype: str = "float32"
    # DINO embeddings for training & best-buddies
    dino_model_name: str = "dinov2_vitl14"
    dino_facet: str = "tokens"
    dino_layer: int = 15
    dino_stride: int = 7
    # DINO embeddings for FG mask
    mask_dino_model_name: str = "dinov2_vitl14"
    mask_dino_facet: str = "tokens"
    mask_dino_layer: int = 23
    mask_dino_stride: int = 7
    # FG mask
    fg_mask_threshold: float = 0.6
    # DINO best-buddies
    dino_bb_box_size: int = 30
    dino_bb_iou_threshold: float = 0.2
    dino_bb_nms_topk: int = 400
    bb_max_pairs_per_frame_pair: Optional[int] = None  # None = adaptive
    max_frames: int = 400  # cap on feature extraction length
    compute_dtype: str = "bfloat16"  # ViT extraction matmul dtype
    extract_frames_per_batch: int = 4
    # on-disk dtype of the T×D×h'×w' feature video; consumers upcast to f32
    feature_store_dtype: str = "float16"
    # write feature artifacts from a background thread; failures re-raise
    # at join_saves()
    async_artifact_save: bool = True

    @classmethod
    def from_yaml(cls, path: str) -> "PreprocessConfig":
        return _from_yaml(cls, path)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    video_h: int = 476
    video_w: int = 854
    dino_patch_size: int = 14
    stride: int = 7
    argmax_radius: float = 35.0
    delta_channels: Tuple[int, ...] = (3, 64, 128, 256, 1024)
    # conv/GEMM operand dtype ("float32" | "bfloat16"); accumulation is f32
    # and batch-norm statistics, the residual and the head stay f32
    compute_dtype: str = "float32"

    @property
    def feat_hw(self) -> Tuple[int, int]:
        return feature_grid_size(self.video_h, self.video_w,
                                 self.dino_patch_size, self.stride)

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]


def tracker_config_from_train(cfg: TrainConfig) -> TrackerConfig:
    """TrackerConfig of a ``TrainConfig`` (as the JAX runtime builds it)."""
    return TrackerConfig(
        video_h=cfg.video_resh, video_w=cfg.video_resw,
        dino_patch_size=cfg.dino_patch_size, stride=cfg.stride,
        delta_channels=(3, 64, 128, 256, cfg.dino_embed_dim),
        compute_dtype=cfg.compute_dtype)
