"""Preprocessing orchestrator of the port, every stage in one process (port
of ``dino_tracker_tpu/preprocessing/pipeline.py``).

``run()`` calls the stages in the JAX package's order:
  1. RAFT flows → chained trajectories: ``extract_trajectories_both`` (both
     passes, with and without the direct-flow filter, in one sweep; the
     filtered one written as ``trajectories.npz``), or the single pass
     ``extract_trajectories`` for both artifacts when the filter is off;
  2. DINO feature video (layer 15 tokens, stride 7) — with the fg-mask layer
     (23) from the same ViT sweep when both share facet and stride;
  3. fg masks from the layer-23 feature PCA (``fg_mask.py``), skipped when
     the masks folder exists;
  4. fg/bg trajectory split (``split_fg_bg.py``);
  5. best buddies (``best_buddies.py``): the unfiltered trajectories are
     written, then the mutual-NN sweep with the optical-flow filter fused,
     ``bb_truncation.json``, the NMS ambiguity and
     ``dino_best_buddies_filtered.npz``, all on the f32 features the ViT
     stage left on the device.
Artifacts land in the JAX package's layout (``config.add_config_paths``), so
the two packages read each other's files. Feature videos are cast to the
store dtype (f16) on the device and written from a background thread; a
writer failure is re-raised by ``join_saves``. ``timings`` holds the host
seconds of each stage (under the JAX package's stage names) and phase, each
ending in a device sync; ``run()`` also records its stages in the process-wide
stage timers of ``utils/profiling.py`` and logs their report.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..config import PreprocessConfig, add_config_paths
from ..models import vit_convert
from ..models.raft import RAFT, load_raft_state_dict
from ..models.vit import VisionTransformer, extract_feature_video
from ..structures import save_bb_data
from ..utils import video_io
from ..utils.profiling import dump_stage_report, stage_timer
from . import best_buddies as bb_lib
from . import fg_mask as fg_lib
from . import split_fg_bg as split_lib
from . import trajectories as traj_lib
from .flow import RaftFlowEngine

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass
class PreprocessingPipeline:
    data_path: str
    cfg: PreprocessConfig
    vit: Optional[VisionTransformer] = None  # on ``device``
    device: torch.device = torch.device("cuda")
    # T×3×H×W frames in [0, 1]; when None they are read from the video folder
    frames: Optional[torch.Tensor] = None
    raft: Optional[RAFT] = None  # on ``device``

    @classmethod
    def from_checkpoints(cls, data_path: str, cfg: PreprocessConfig,
                         raft_checkpoint: Optional[str] = None,
                         dino_checkpoint: Optional[str] = None,
                         device: torch.device = torch.device("cuda")):
        """The pipeline with its weights loaded onto ``device`` from a
        princeton-vl RAFT checkpoint and a DINOv2 state-dict checkpoint
        (either may be None: the stages that need it then raise)."""
        model = vit = None
        if raft_checkpoint:
            model = load_raft_state_dict(raft_checkpoint, device)
        if dino_checkpoint:
            state, vcfg = vit_convert.load_dinov2_state_dict(dino_checkpoint,
                                                             cfg.dino_model_name)
            vit = vit_convert.build_vit(state, vcfg, device)
        return cls(data_path, cfg, vit=vit, device=device, raft=model)

    def __post_init__(self):
        self.paths = add_config_paths(self.data_path)
        self._save_threads = []
        self._engine = None
        # host seconds of each stage and phase, each ending in a device sync
        self.timings: Dict[str, float] = {}
        # the best-buddy stage's sweep and ambiguity telemetry
        self.telemetry: Dict[str, dict] = {}

    @property
    def video(self) -> torch.Tensor:
        """The video, T×3×H×W f32 in [0, 1] on the device (at most
        ``max_frames`` frames, resized to the config's resolution)."""
        if self.frames is None:
            self.frames = torch.from_numpy(video_io.load_video(
                self.paths["video_folder"],
                resize=(self.cfg.video_resh, self.cfg.video_resw),
                num_frames=self.cfg.max_frames))
        self.frames = self.frames.to(self.device)
        return self.frames

    @property
    def flow_engine(self) -> RaftFlowEngine:
        if self._engine is None:
            if self.raft is None:
                raise ValueError("RAFT weights required")
            self._engine = RaftFlowEngine(
                self.raft, self.video, num_iters=self.cfg.raft_iters,
                compute_dtype=_DTYPES[self.cfg.raft_compute_dtype], device=self.device)
        return self._engine

    def _timed(self, name: str, fn):
        """``fn()``, its host seconds up to a device sync kept under ``name``."""
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0
        return out

    def _adjacent_flows(self):
        eng = self.flow_engine
        self._timed("encode", eng.encodings)
        logger.info("adjacent RAFT flows (%d pairs)", eng.t - 1)
        return self._timed("adjacent_flows", eng.adjacent_flows)

    def extract_trajectories(self, use_direct_filter: bool, out_path: str) -> np.ndarray:
        """One chaining pass, with or without the direct-flow filter; writes
        ``out_path`` and returns the N×T×2 trajectories."""
        fwd, bwd = self._adjacent_flows()
        direct_fn = None
        if use_direct_filter:
            direct_fn = lambda s: self.flow_engine.direct_flows(s, self.cfg.threshold)
        trajs = self._timed("chaining", lambda: traj_lib.extract_trajectories(
            fwd, bwd, threshold=self.cfg.threshold,
            min_trajectory_length=self.cfg.min_trajectory_length,
            direct_flow_fn=direct_fn,
            direct_flow_threshold=self.cfg.direct_flow_threshold))
        video_io.save_npz(out_path, trajectories=trajs)
        logger.info("saved %s: %s", out_path, trajs.shape)
        return trajs

    def extract_trajectories_both(self):
        """Stage 1 and the best-buddy stage's unfiltered pass in one sweep
        over the start frames (the reference runs its chaining script once
        per pass). Writes the filtered trajectories to ``trajectories.npz``
        and returns (filtered, unfiltered)."""
        fwd, bwd = self._adjacent_flows()
        eng = self.flow_engine
        trajs, unfiltered = traj_lib.extract_trajectories_dual(
            fwd, bwd, direct_flow_fn=lambda s: eng.direct_flows(s, self.cfg.threshold),
            threshold=self.cfg.threshold,
            min_trajectory_length=self.cfg.min_trajectory_length,
            direct_flow_threshold=self.cfg.direct_flow_threshold,
            timings=self.timings)
        video_io.save_npz(self.paths["trajectories_file"], trajectories=trajs)
        logger.info("saved %s: %s", self.paths["trajectories_file"], trajs.shape)
        return trajs, unfiltered

    def extract_dino_features(self, layer: Union[int, Sequence[int]],
                              out_path: Union[str, Sequence[str]],
                              facet: Optional[str] = None,
                              stride: Optional[int] = None):
        """One ViT sweep for one layer, or for several in a single pass when
        ``layer`` and ``out_path`` are lists. Returns the f32 feature
        video(s) on the device; each artifact is its store-dtype cast, made
        on the device and written from a background thread."""
        if self.vit is None:
            raise ValueError("DINO weights required")
        single = isinstance(layer, int)
        layers = [layer] if single else list(layer)
        out_paths = [out_path] if single else list(out_path)
        feats = extract_feature_video(
            self.vit, self.video,
            stride=self.cfg.dino_stride if stride is None else stride,
            layer=layers, facet=self.cfg.dino_facet if facet is None else facet,
            frames_per_batch=self.cfg.extract_frames_per_batch,
            compute_dtype=_DTYPES[self.cfg.compute_dtype])
        store = _DTYPES[self.cfg.feature_store_dtype]
        for f, path in zip(feats, out_paths):
            stored = f.to(store)  # on the device: halves the fetch, not only the file
            if self.cfg.async_artifact_save:
                self._save_async(stored, path)
            else:
                self._save(stored, path)
        return feats[0] if single else feats

    def _save(self, features: torch.Tensor, path: str):
        video_io.save_npz(path, features=features.cpu().numpy())
        logger.info("saved %s: %s (%s)", path, tuple(features.shape),
                    features.dtype)

    def _save_async(self, features: torch.Tensor, path: str):
        slot = {"exc": None}

        def run():
            try:
                self._save(features, path)
            except BaseException as e:  # re-raised in join_saves
                slot["exc"] = e

        th = threading.Thread(target=run, name=f"save:{path}")
        th.start()
        self._save_threads.append((th, slot))

    def create_fg_masks(self, mask_features: torch.Tensor) -> np.ndarray:
        """T×H×W {0, 1} masks from the mask-layer features, written as jpg
        frames to the masks folder (0/255)."""
        masks = fg_lib.compute_fg_masks(
            mask_features, (self.cfg.video_resh, self.cfg.video_resw),
            fg_mask_threshold=self.cfg.fg_mask_threshold).cpu().numpy()
        video_io.save_video_frames((masks * 255).astype(np.uint8),
                                   self.paths["masks_path"])
        return masks

    def split_trajectories(self, trajs: np.ndarray):
        """Split N×T×2 trajectories by the masks on disk; writes both banks."""
        masks = video_io.load_masks(self.paths["masks_path"],
                                    h_resize=self.cfg.video_resh,
                                    w_resize=self.cfg.video_resw)
        fg, bg = split_lib.split_fg_bg(trajs, masks)
        video_io.save_npz(self.paths["fg_trajectories_file"], trajectories=fg)
        video_io.save_npz(self.paths["bg_trajectories_file"], trajectories=bg)
        logger.info("split: %d fg / %d bg trajectories", len(fg), len(bg))
        return fg, bg

    def compute_best_buddies(self, features: torch.Tensor,
                             unfiltered_trajs: np.ndarray):
        """Stage 5 on the f32 feature video: the sweep with the optical-flow
        filter fused before the cap, ``bb_truncation.json`` beside the
        artifact, the ambiguity pass, ``dino_best_buddies_filtered.npz``."""
        h, w = self.cfg.video_resh, self.cfg.video_resw
        stride = self.cfg.dino_stride
        sweep: dict = {}
        bb = bb_lib.extract_best_buddies(
            features, h, w, stride, cap=self.cfg.bb_max_pairs_per_frame_pair,
            unfiltered_trajectories=unfiltered_trajs, telemetry=sweep)
        phases = sweep["phases"]
        self.timings["bb_closest_grids"] = phases["closest_grids_s"]
        self.timings["bb_sweep"] = phases["sweep_s"]
        self.timings["bb_compaction"] = phases["compaction_s"]
        # the reference keeps every mutual pair; the cap's truncation is
        # recorded beside the artifact so it is never silent
        os.makedirs(self.paths["dino_bb_dir"], exist_ok=True)
        with open(os.path.join(self.paths["dino_bb_dir"], "bb_truncation.json"), "w") as f:
            json.dump(sweep, f, indent=1)
        ambiguity: dict = {}
        bb = self._timed("bb_ambiguity", lambda: bb_lib.compute_bb_ambiguity(
            bb, features, h, w, stride, box_size=float(self.cfg.dino_bb_box_size),
            iou_thresh=self.cfg.dino_bb_iou_threshold, topk=self.cfg.dino_bb_nms_topk,
            telemetry=ambiguity))
        self.telemetry.update(best_buddies=sweep, bb_ambiguity=ambiguity)
        out = os.path.join(self.paths["dino_bb_dir"], "dino_best_buddies_filtered.npz")
        self._timed("bb_save", lambda: save_bb_data(out, bb))
        logger.info("saved %s", out)
        return bb

    def run(self):
        """Every stage, in the JAX package's order (its ``run()``,
        ``pipeline.py:226-289``), then a per-stage report of ``timings``."""
        cfg, paths = self.cfg, self.paths

        def stage(name, fn):
            with stage_timer(f"preprocess/{name}"):
                return self._timed(f"preprocess/{name}", fn)

        if cfg.filter_using_direct_flow:
            trajs, unfiltered = stage("trajectories", self.extract_trajectories_both)
        else:  # without the direct filter both passes are one computation
            trajs = unfiltered = stage("trajectories", lambda: self.extract_trajectories(
                False, paths["trajectories_file"]))
        need_masks = not os.path.exists(paths["masks_path"])
        if need_masks and cfg.mask_dino_model_name != cfg.dino_model_name:
            logger.warning(
                "mask_dino_model_name %s != dino_model_name %s — the loaded DINO "
                "weights are used for both", cfg.mask_dino_model_name, cfg.dino_model_name)
        if need_masks and (cfg.mask_dino_facet, cfg.mask_dino_stride) == (
                cfg.dino_facet, cfg.dino_stride):  # both layers from one ViT sweep
            feats, mask_feats = stage("dino_features", lambda: self.extract_dino_features(
                [cfg.dino_layer, cfg.mask_dino_layer],
                [paths["dino_embed_video_path"], paths["mask_dino_embed_video_path"]]))
            stage("fg_masks", lambda: self.create_fg_masks(mask_feats))
            del mask_feats
        else:
            feats = stage("dino_features", lambda: self.extract_dino_features(
                cfg.dino_layer, paths["dino_embed_video_path"]))
            if need_masks:
                stage("fg_masks", lambda: self.create_fg_masks(self.extract_dino_features(
                    cfg.mask_dino_layer, paths["mask_dino_embed_video_path"],
                    facet=cfg.mask_dino_facet, stride=cfg.mask_dino_stride)))
            else:
                logger.info("masks exist, skipping fg-mask stage")
        stage("split_fg_bg", lambda: self.split_trajectories(trajs))
        stage("unfiltered_trajectories", lambda: video_io.save_npz(
            paths["unfiltered_trajectories_file"], trajectories=unfiltered))
        logger.info("saved %s: %s", paths["unfiltered_trajectories_file"], unfiltered.shape)
        stage("best_buddies", lambda: self.compute_best_buddies(feats, unfiltered))
        self.join_saves()
        logger.info("stage timing report:\n%s", dump_stage_report())

    def join_saves(self):
        """Block until every async artifact write has landed; re-raise the
        first writer failure."""
        threads, self._save_threads = self._save_threads, []
        first_exc = None
        for th, slot in threads:
            th.join()
            if slot["exc"] is not None and first_exc is None:
                first_exc = slot["exc"]
        if first_exc is not None:
            raise first_exc
