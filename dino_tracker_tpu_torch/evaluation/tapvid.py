"""TAP-Vid benchmark pickle adapter: the port's own copy of
``dino_tracker_tpu/evaluation/tapvid.py`` (reference data/tapvid.py).

Benchmark format: ``{"videos": [{"video_idx", "h", "w",
"query_points": {frame: [(x, y), ...]}, "target_points", "occluded"}]}``.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Union


def load_benchmark(path_or_dict: Union[str, dict]) -> dict:
    if isinstance(path_or_dict, str):
        with open(path_or_dict, "rb") as f:
            return pickle.load(f)
    return path_or_dict


def get_video_config_by_video_id(benchmark_config: dict,
                                 video_id: int) -> Optional[dict]:
    for video_config in benchmark_config["videos"]:
        if video_config["video_idx"] == video_id:
            return video_config
    return None


def get_query_points_from_benchmark_config(benchmark_config: Union[str, dict],
                                           video_idx: int,
                                           rescale_sizes=None) -> Dict[int, list]:
    """{frame: [[x, y, frame], ...]}, rescaled to the model resolution when
    ``rescale_sizes`` = (w, h) is given."""
    cfg = get_video_config_by_video_id(load_benchmark(benchmark_config),
                                       video_idx)
    if cfg is None:
        raise KeyError(f"video {video_idx} is not in the benchmark")
    fx = 1.0 if rescale_sizes is None else rescale_sizes[0] / cfg["w"]
    fy = 1.0 if rescale_sizes is None else rescale_sizes[1] / cfg["h"]
    return {frame_idx: [[fx * p[0], fy * p[1], frame_idx] for p in pts]
            for frame_idx, pts in cfg["query_points"].items()}
