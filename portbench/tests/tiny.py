"""CPU-sized cells of the generators (the real traffic mixes, on copies of
``dt-l14-davis`` cut to CPU size), their limits, and runs of them."""

import atexit
import copy
import json
import os
import shutil
import tempfile
import time

from conftest import ROOT

import run

CELL = "tiny.train-on"
BASE = "portbench/configs/dt-l14-davis.json"
# the CPU-sized cut of dt-l14-davis: top-level values replaced, nested groups updated
TINY = {"frames": 6, "height": 70, "width": 98, "delta_channels": [3, 8, 8, 8, 32],
        "train": {"video_resw": 98, "video_resh": 70, "train_batch_size": 32,
                  "batch_n_frames": 3, "cyc_n_frames": 2, "cyc_batch_size_per_frame": 16,
                  "cl_n_frames": 2, "cl_points_per_pair": 16},
        "data": {"trajectories": 400, "bb_capacity": 24}}
# the preprocessing cell's further cut: a ViT-S/14 and RAFT at 4 iterations
TINY_PRE = {"vit": {"model": "dinov2_vits14", "embed_dim": 384, "depth": 12, "heads": 6,
                    "layers": [3, 5]},
            "raft": {"iters": 4},
            "preprocess": {"video_resh": 70, "video_resw": 98, "raft_iters": 4,
                           "dino_model_name": "dinov2_vits14", "dino_layer": 3,
                           "mask_dino_model_name": "dinov2_vits14", "mask_dino_layer": 5}}
_DIR = []


def config_file(name: str, *overrides: dict) -> str:
    """A copy of dt-l14-davis cut by ``overrides``, written once a process
    into a temporary folder (removed at exit); returns its absolute path."""
    if not _DIR:
        _DIR.append(tempfile.mkdtemp(prefix="portbench-tests-"))
        atexit.register(shutil.rmtree, _DIR[0], True)
    path = os.path.join(_DIR[0], f"{name}.json")
    if not os.path.exists(path):
        cfg = run.load_json(os.path.join(ROOT, BASE))
        for over in overrides:
            for k, v in over.items():
                cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
        cfg.update(name=name, source="a CPU-sized copy of dt-l14-davis for the harness's tests",
                   reduced=sorted({k for over in overrides for k in over}))
        with open(path, "w") as f:
            json.dump(cfg, f)
    return path


def _add_config(b: dict, name: str, *overrides: dict) -> None:
    b["configs"].append({"name": name, "source": "a CPU-sized copy for the harness's tests",
                         "file": config_file(name, *overrides), "reduced": [], "why": "tests"})
# set from the tiny cell's CPU readings (program 1.7e-5 / 2.0e-8 / 2.5e-3
# at most, the float8 control 1.4e-3 / 2.4e-2 / 6.0e-2 at least, seeds 5-7)
LIMITS = {"loss": 3e-4, "grad": 2e-3, "change": 1.5e-2, "change_median": 1.5e-2}


def bench() -> dict:
    """BENCHMARK.json with the tiny cell added."""
    b = copy.deepcopy(run.load_json(os.path.join(ROOT, "BENCHMARK.json")))
    _add_config(b, "tiny", TINY)
    b["workloads"].append({"name": CELL, "config": "tiny", "traffic": "train-on", "chips": 1,
                           "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "dt-l14-davis.train-on" in m["workloads"]:
            m["workloads"].append(CELL)
    return b


def run_tiny(trace=False, seed=5, seconds=0.5):
    return run.run_cell(bench(), CELL, seed, seconds, trace, "cpu", t_start=time.perf_counter(),
                        limits=LIMITS)


def bench_dp4() -> dict:
    """``bench()`` with a 4-rank copy of the tiny cell (gloo ranks on the
    CPU)."""
    b = bench()
    _add_config(b, "tiny-dp4", TINY)
    b["workloads"].append({"name": CELL_DP4, "config": "tiny-dp4", "traffic": "train-on",
                           "chips": 4, "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "dt-l14-davis-dp4.train-on" in m["workloads"]:
            m["workloads"].append(CELL_DP4)
    return b


CELL_DP4 = "tiny-dp4.train-on"


# set from the tiny mesh's CPU readings (1.1e-4 / 6.1e-3 / 2.2e-2 at most,
# seeds 5-7; the gradients' exchange left out 1.7e-3 / 5.2 / 0.14 at least)
LIMITS_DP4 = {"loss": 6e-4, "grad": 0.1, "change": 0.06}


def run_tiny_dp4(seed=5, seconds=0.5, plant=None, trace=False):
    return run.run_cell(bench_dp4(), CELL_DP4, seed, seconds, trace, "cpu",
                        t_start=time.perf_counter(), limits=LIMITS_DP4, plant=plant)


CELL_PRE = "tiny-pre.preprocess-t8"


def bench_pre() -> dict:
    """``bench()`` with a CPU-sized preprocessing cell: a ViT-S/14 and RAFT
    at 4 iterations on 98×70 frames."""
    b = bench()
    _add_config(b, "tiny-pre", TINY, TINY_PRE)
    b["workloads"].append({"name": CELL_PRE, "config": "tiny-pre", "traffic": "preprocess-t8",
                           "chips": 1, "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "dt-l14-davis.preprocess-t8" in m["workloads"]:
            m["workloads"].append(CELL_PRE)
    return b


# set from the tiny preprocessing cell's CPU readings (program: trajectories
# and split equal, position gap 7.6e-6 px, 1 − token cosine 6e-7; the
# control, float8 ViT operands: 1 − token cosine 1.0e-3 at least; a flow
# altered by half a pixel: trajectories 1.9, 3.6 px; seeds 5-7)
LIMITS_PRE = {"traj": 0.01, "traj_px": 1e-3, "feat": 1e-4, "mask": 1e-3, "split": 0.01,
              "bb": 0.01, "bb_r": 0.01}


def run_tiny_pre(seed=5, seconds=0.5, trace=False):
    return run.run_cell(bench_pre(), CELL_PRE, seed, seconds, trace, "cpu",
                        t_start=time.perf_counter(), limits=LIMITS_PRE)


def jax_on_rank_2():
    """A planted fault: rank 2 of a mesh loads a module named ``jax``."""
    import sys
    import types
    import torch.distributed as dist
    if dist.get_rank() == 2:
        sys.modules["jax"] = types.ModuleType("jax")
