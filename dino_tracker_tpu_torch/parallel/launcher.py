"""Multi-video benchmark fan-out of the port (counterpart of
``dino_tracker_tpu/parallel/launcher.py``).

The reference's benchmark protocol is "run preprocess/train/inference once
per video id" by hand (README.md:139-154). This launcher runs the per-video
pipeline for a whole TAP-Vid benchmark directory as a work queue, one video
after another in one process on one device; several hosts (or processes)
share the queue through lockfile claims on a shared filesystem. Nothing of
one video stays on the device into the next: every tensor of a video is
dropped with its pipeline, runtime and trainer before the next one starts.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import os
import socket
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..utils.profiling import dump_stage_report, reset_stage_timers, stage_report, stage_timer

logger = logging.getLogger(__name__)


def claim_video(claim_dir: str, video_id: str) -> bool:
    """Atomically claim a work item (O_EXCL lockfile on shared storage)."""
    os.makedirs(claim_dir, exist_ok=True)
    path = os.path.join(claim_dir, f"{video_id}.claim")
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        json.dump({"host": socket.gethostname(), "pid": os.getpid(),
                   "time": time.time()}, f)
    return True


def mark_done(claim_dir: str, video_id: str):
    with open(os.path.join(claim_dir, f"{video_id}.done"), "w") as f:
        f.write(str(time.time()))


def is_done(claim_dir: str, video_id: str) -> bool:
    return os.path.exists(os.path.join(claim_dir, f"{video_id}.done"))


@dataclasses.dataclass
class BenchmarkLauncher:
    """Drive preprocess→train→inference for every video directory under
    ``dataset_root`` (one subdir per video id, each with ``video/``) on
    ``device``. ``reports`` holds, per finished video, its stage timers
    (``utils/profiling.stage_report``) and, on a GPU, its peak device memory
    and the memory allocated before and after it (bytes)."""

    dataset_root: str
    benchmark_pickle_path: str
    train_config_path: str
    preprocess_config_path: str
    raft_checkpoint: Optional[str] = None
    dino_checkpoint: Optional[str] = None
    stages: Sequence[str] = ("preprocess", "train", "inference")
    device: torch.device = torch.device("cuda")
    reports: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.device = torch.device(self.device)

    def video_ids(self) -> List[str]:
        return sorted(d for d in os.listdir(self.dataset_root)
                      if not d.startswith(".")
                      and os.path.isdir(os.path.join(self.dataset_root, d)))

    @staticmethod
    def resolve_video_index(video_id: str) -> int:
        """TAP-Vid benchmark pickles key videos by integer index; resolve it
        up front so a bad directory name fails BEFORE preprocessing/training
        burn chip time."""
        try:
            return int(video_id)
        except ValueError:
            raise ValueError(
                f"video directory {video_id!r} is not an integer benchmark "
                "index; rename it to its TAP-Vid video_idx (or run stages "
                "without 'inference')")

    def run_video(self, video_id: str):
        data_path = os.path.join(self.dataset_root, video_id)
        if "inference" in self.stages:
            video_index = self.resolve_video_index(video_id)
        from ..config import PreprocessConfig, TrainConfig
        from ..runtime import DINOTrackerRuntime

        dev = self.device
        if "preprocess" in self.stages:
            from ..preprocessing.pipeline import PreprocessingPipeline
            with stage_timer("video/preprocess", fence=dev):
                PreprocessingPipeline.from_checkpoints(
                    data_path, PreprocessConfig.from_yaml(self.preprocess_config_path),
                    self.raft_checkpoint, self.dino_checkpoint, dev).run()

        rt = DINOTrackerRuntime(data_path, TrainConfig.from_yaml(self.train_config_path),
                                dev)
        if "train" in self.stages:
            with stage_timer("video/train", fence=dev):
                rt.train()
        if "inference" in self.stages:
            with stage_timer("video/inference", fence=dev):
                rt.infer_benchmark(self.benchmark_pickle_path, video_index)

    def run(self, claim_dir: Optional[str] = None):
        """Work through the queue; with ``claim_dir`` multiple hosts share it."""
        cuda = self.device.type == "cuda"
        for vid in self.video_ids():
            if claim_dir is not None:
                if is_done(claim_dir, vid) or not claim_video(claim_dir, vid):
                    logger.info("skip %s (claimed/done)", vid)
                    continue
            logger.info("=== video %s ===", vid)
            t0 = time.time()
            reset_stage_timers()
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
                before = torch.cuda.memory_allocated(self.device)
            try:
                self.run_video(vid)
            except Exception:
                logger.exception("video %s failed", vid)
                continue
            finally:
                gc.collect()  # the video's tensors held in reference cycles
            report = {"stages": stage_report()}
            if cuda:
                report.update(peak_bytes=torch.cuda.max_memory_allocated(self.device),
                              allocated_before_bytes=before,
                              allocated_after_bytes=torch.cuda.memory_allocated(self.device))
            self.reports[vid] = report
            if claim_dir is not None:
                mark_done(claim_dir, vid)
            logger.info("video %s done in %.1f min; stage report:\n%s", vid,
                        (time.time() - t0) / 60, dump_stage_report())
