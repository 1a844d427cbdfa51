"""Per-video runtime of the port: training and inference, on one device or
data parallel over the ranks of a ``mesh`` (``parallel/mesh.py``).

Port of dino_tracker_tpu/runtime.py: binds a video's on-disk artifacts
(frames, the DINO feature stack, fg masks, trajectories, best buddies, a
checkpoint) to tensors on one device, trains the per-video model and serves
trajectory and occlusion queries. The path contract and ``TrainConfig``
(``config.py``), frame loading (``utils/video_io.py``) and TAP-Vid query
points (``evaluation/tapvid.py``) are the port's own copies; Pillow is
imported only where frames are read.

Checkpoints: the port's trainer writes ``state_<step>.pt``; inference serves
the newest readable one of those, and otherwise the newest readable
``state_<step>.msgpack`` written by the JAX trainer, skipping a file cut by a
kill mid-save as the JAX runtime does. ``make_model_inference`` and
``load_model`` are the in-memory entry points under ``DINOTrackerRuntime``:
they take tensors, a model or a checkpoint folder, and need no config file.
A runtime keeps the training data it loaded, and inference after ``train``
serves from it (JAX runtime.py:58-63, 135-136).

With a ``mesh`` (the JAX runtime's ``mesh_devices``, runtime.py:38-49) every
rank loads the video's artifacts onto its own device and runs the same
calls: training shards the frame set and the point batches, the refine cache
its frames and inference its prediction rows; rank 0 alone writes files.
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
from .parallel import mesh as mesh_lib
from .structures import load_bb_data
from .training import checkpoint as ckpt_lib
from .training import train as train_lib
from .training.sampler import BankRotator, build_bank
from .utils import video_io
from .utils.profiling import stage_timer

logger = logging.getLogger(__name__)


def read_checkpoint_file(path: str) -> dict:
    """What one checkpoint file holds: the port's state (``.pt``) or the JAX
    trainer's train state (``.msgpack``), on the host."""
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    return convert.load_jax_checkpoint(path)


def read_checkpoint(ckpt_folder: str, step: Optional[int] = None) -> tuple:
    """(path, contents) of the checkpoint inference serves.

    ``step`` None: the first readable file of the port's ``state_<step>.pt``
    newest first, then the JAX trainer's ``state_<step>.msgpack`` newest
    first; an unreadable one (e.g. truncated by a kill mid-save) is logged
    and skipped, as the JAX ``load_state(step=None)`` skips it
    (training/checkpoint.py:115-143). A folder with no checkpoint raises
    ``FileNotFoundError``, one whose every file is unreadable the last read
    error. An explicit ``step`` reads its ``.pt``, else its ``.msgpack``, and
    fails hard."""
    if step is not None:
        path = ckpt_lib.checkpoint_file(ckpt_folder, step)
        if not os.path.exists(path):
            path = convert.checkpoint_path(ckpt_folder, step)
        return path, read_checkpoint_file(path)
    paths = ([ckpt_lib.checkpoint_file(ckpt_folder, s)
              for s in ckpt_lib.checkpoint_steps(ckpt_folder)]
             + [convert.checkpoint_path(ckpt_folder, s)
                for s in convert.checkpoint_steps(ckpt_folder)])
    if not paths:
        raise FileNotFoundError(f"no checkpoint in {ckpt_folder}")
    for path in paths:
        try:
            return path, read_checkpoint_file(path)
        except Exception as e:  # truncated or corrupt file
            last = e
            logger.warning("checkpoint %s unreadable (%s); falling back", path, e)
    raise last


def model_from_checkpoint(path: str, contents: dict, tcfg: TrackerConfig,
                          device: torch.device) -> tracker_lib.Tracker:
    """The trained model of a file ``read_checkpoint`` read, on ``device``. A
    state that does not fit ``tcfg`` raises: that is a wrong config, not a
    damaged file."""
    model = tracker_lib.Tracker(tcfg)
    model.load_state_dict(contents["model"] if path.endswith(".pt") else
                          convert.state_from_jax(contents["params"],
                                                 contents["batch_stats"]))
    logger.info("serving checkpoint %s", path)
    return model.to(device)


def load_model(ckpt_folder: str, tcfg: TrackerConfig, device: torch.device,
               step: Optional[int] = None) -> tracker_lib.Tracker:
    """The trained model of a checkpoint (``read_checkpoint``), on ``device``."""
    return model_from_checkpoint(*read_checkpoint(ckpt_folder, step), tcfg,
                                 device)


def make_model_inference(model: tracker_lib.Tracker, video_tchw: torch.Tensor,
                         dino_embed_tchw: torch.Tensor, tcfg: TrackerConfig,
                         anchor_cosine_similarity_threshold: float,
                         cosine_similarity_threshold: float,
                         chunk: int = 4096, mesh=None) -> ModelInference:
    """Refine every frame's features (eval mode) and wrap them for queries.

    ``video_tchw`` T×3×H×W in [0, 1] and ``dino_embed_tchw`` T×C×h'×w' (the
    f16 artifact) lie on the device the model lives on. With a ``mesh`` the
    refine and the queries shard over its ranks."""
    want = tcfg.delta_channels[-1]
    if dino_embed_tchw.shape[1] != want:
        raise ValueError(
            f"feature stack has {dino_embed_tchw.shape[1]} channels but the "
            f"refiner emits {want}: the video was preprocessed with a "
            "different DINO variant than this config")
    model.eval()
    refined = tracker_lib.cache_refined_embeddings(model, video_tchw,
                                                   dino_embed_tchw, tcfg, mesh=mesh)
    return ModelInference(
        model=model, refined_features=refined, cfg=tcfg,
        anchor_cosine_similarity_threshold=anchor_cosine_similarity_threshold,
        cosine_similarity_threshold=cosine_similarity_threshold, chunk=chunk,
        mesh=mesh)


@dataclasses.dataclass
class DINOTrackerRuntime:
    data_path: str
    cfg: TrainConfig
    device: torch.device = torch.device("cuda")
    seed: int = 2
    mesh: Optional[mesh_lib.Mesh] = None  # data parallel over its ranks

    def __post_init__(self):
        if self.mesh is not None:
            self.device = self.mesh.device
        self.paths = add_config_paths(self.data_path)
        self.tcfg = tracker_config_from_train(self.cfg)
        self._data = None
        self.checkpoint = None  # the file load_state served last

    def load_video_data(self) -> train_lib.VideoData:
        """Every training artifact of the video, on this runtime's device
        (JAX runtime.py:58-106). The feature stack stays f16 (the artifact
        dtype); the step upcasts the gathered frames, which is exact. The
        runtime keeps the data until it is dropped: a second call, and
        inference after ``train``, use it again."""
        if self._data is not None:
            return self._data
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
        self._data = train_lib.VideoData(
            video=torch.from_numpy(video).to(dev),
            dino_embed=torch.from_numpy(dino).to(dev),
            fg_masks=torch.from_numpy(fg_masks).to(dev), bb=bb,
            fg_bank=fg_bank, bg_bank=bg_bank)
        return self._data

    def train(self) -> tracker_lib.Tracker:
        """Train (or resume) this video's model; checkpoints go to
        ``models/dino_tracker/state_<step>.pt``. Loading the artifacts is
        a stage timer (``train/load_data``), fenced on the device."""
        with stage_timer("train/load_data", fence=self.device):
            data = self.load_video_data()
        return train_lib.Trainer(
            cfg=self.cfg, tcfg=self.tcfg, data=data,
            ckpt_folder=self.paths["ckpt_folder"], seed=self.seed,
            bank_rotator=self.bank_rotator, device=self.device,
            mesh=self.mesh).train()

    def load_state(self, step: Optional[int] = None) -> tracker_lib.Tracker:
        """The trained model (see ``read_checkpoint``) on this runtime's
        device. On a mesh with ``step`` None, rank 0 picks the file and every
        rank loads that one, with no fallback of its own: ranks that chose
        apart (a checkpoint written while they list the folder) would serve
        different weights, which the refine's ``all_gather_rows`` would mix."""
        folder = self.paths["ckpt_folder"]
        if step is not None or not mesh_lib.is_parallel(self.mesh):
            path, contents = read_checkpoint(folder, step)
        else:
            name, err = None, None
            if mesh_lib.is_main(self.mesh):
                try:
                    path, contents = read_checkpoint(folder)
                    name = os.path.basename(path)
                except Exception as e:  # every rank raises, none waits
                    err = e
            name = mesh_lib.broadcast_object(name, self.mesh)
            if err is not None:
                raise err
            if name is None:
                raise RuntimeError(f"rank 0 found no readable checkpoint in {folder}")
            if not mesh_lib.is_main(self.mesh):
                path = os.path.join(folder, name)
                contents = read_checkpoint_file(path)
        self.checkpoint = path
        return model_from_checkpoint(path, contents, self.tcfg, self.device)

    def get_model_inference(self, step: Optional[int] = None,
                            chunk: int = 4096) -> ModelInference:
        """The refined cache and its queries (JAX runtime.py:125-152), from
        the frames and features ``load_video_data`` holds, else read from
        disk. The reuse depends on training never writing ``video`` or
        ``dino_embed``: the step only gathers frames out of them
        (``tracker.get_refined_embeddings``), so they still equal the
        artifacts and the predictions a fresh read's, bit for bit."""
        if self._data is not None:
            video, dino = self._data.video, self._data.dino_embed
        else:
            dino_np = video_io.load_npz(self.paths["dino_embed_video_path"])["features"]
            video = torch.from_numpy(video_io.load_video(
                self.paths["video_folder"],
                resize=(self.cfg.video_resh, self.cfg.video_resw),
                num_frames=dino_np.shape[0])).to(self.device)
            dino = torch.from_numpy(dino_np).to(self.device)
        return make_model_inference(
            self.load_state(step), video, dino, self.tcfg,
            self.cfg.anchor_cosine_similarity_threshold,
            self.cfg.cosine_similarity_threshold, chunk, self.mesh)

    def infer_benchmark(self, benchmark_pickle_path: str, video_id: int,
                        step: Optional[int] = None, chunk: int = 4096):
        """Per-query-frame trajectory/occlusion predictions saved as .npy
        (reference inference_benchmark.py:13-41). The refine and each query
        frame's request are stage timers (``inference/refine``,
        ``inference/query_frame_<f>``), fenced on the device. Rank 0 writes
        the files."""
        with stage_timer("inference/refine", fence=self.device):
            mi = self.get_model_inference(step, chunk)
        qp = get_query_points_from_benchmark_config(
            benchmark_pickle_path, video_id,
            rescale_sizes=[self.cfg.video_resw, self.cfg.video_resh])
        main = mesh_lib.is_main(self.mesh)
        if main:
            os.makedirs(self.paths["trajectories_dir"], exist_ok=True)
            os.makedirs(self.paths["occlusions_dir"], exist_ok=True)
        for frame_idx in sorted(qp.keys()):
            pts = np.asarray(qp[frame_idx], np.float32)
            with stage_timer(f"inference/query_frame_{frame_idx}", fence=self.device):
                trajs, occ = mi.infer(pts)
            if not main:
                continue
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
        if not mesh_lib.is_main(self.mesh):
            return trajs, occ
        os.makedirs(self.paths["grid_trajectories_dir"], exist_ok=True)
        os.makedirs(self.paths["grid_occlusions_dir"], exist_ok=True)
        np.save(os.path.join(self.paths["grid_trajectories_dir"],
                             "grid_trajectories.npy"), trajs)
        np.save(os.path.join(self.paths["grid_occlusions_dir"],
                             "grid_occlusions.npy"), occ)
        return trajs, occ
