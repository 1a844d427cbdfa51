"""``cli.train`` then ``cli.inference_benchmark`` with ``--devices 2
--device cpu`` (two gloo ranks) against ``--devices 1`` on a tiny video
directory in the JAX package's layout.

Training: the same checkpoints (steps 2 and 4) with the same step,
schedule and generator state; the model state is held only to its scale.
This tiny freshly initialised model's early DeltaDINO gradients are tiny
once its zero-initialised last layer moves, so two valid orders of
summation (one device on another thread count, too) already differ in
their low bits, and Adam turns every entry whose sign is uncertain into a
step of ±lr; so the parameters are held to Adam's step, at most 2·lr apart
for each update, and the BN running statistics, which those parameters
feed, to 1e-2 of their largest magnitude. The
step's own equality with one device, gradients and statistics included, is
held in ``test_torch_mesh_train.py`` on weights whose gradients are not
noise.
Each rank reports its stage timers, with the slowest rank's steps beside
its own. Inference of one checkpoint at W = 2 and W = 1: trajectories
within 1e-3 px, occlusion flags equal; rank 0 alone writes.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.cli import inference_benchmark
from dino_tracker_tpu_torch.cli import train as train_cli
from dino_tracker_tpu_torch.ops import _guard
from dino_tracker_tpu_torch.training import checkpoint as ckpt
from test_torch_threads import one_thread  # noqa: F401

@pytest.fixture(scope="module")
def video_dirs(tmp_path_factory):
    """Two copies of one directory: ``a`` for the two ranks, ``b`` for one
    device."""
    from test_torch_train_step import H, W, video_arrays, write_video_dir
    root = tmp_path_factory.mktemp("mesh_cli")
    a = str(root / "a")
    write_video_dir(a, video_arrays(4, t=5, c=384), 384)
    bench = {"videos": [{"video_idx": 0, "h": H * 2, "w": W * 2,
                         "query_points": {0: [[40.0, 60.0], [100.0, 20.0],
                                              [150.0, 90.0]],
                                          3: [[150.0, 100.0]]}}]}
    with open(os.path.join(a, "bench.pkl"), "wb") as f:
        pickle.dump(bench, f)
    b = str(root / "b")
    shutil.copytree(a, b)
    return a, b


def train_args(root, devices):
    return ["--config", os.path.join(root, "train.yaml"), "--data-path", root,
            "--device", "cpu", "--devices", str(devices)]


@pytest.fixture(scope="module")
def trained(video_dirs):
    a, b = video_dirs
    return train_cli.main(train_args(a, 2)), train_cli.main(train_args(b, 1))


def test_train_cli_on_two_ranks_matches_one_device(video_dirs, trained):
    a, b = video_dirs
    folder = lambda root: os.path.join(root, "models", "dino_tracker")
    assert ckpt.checkpoint_steps(folder(a)) == ckpt.checkpoint_steps(folder(b)) == [4, 2]
    for step in (2, 4):
        two, one = (ckpt.load_state(folder(r), step) for r in (a, b))
        assert two["step"] == one["step"] == step
        assert two["scheduler"] == one["scheduler"]
        assert torch.equal(two["generator"], one["generator"])
        lr = one["optimizer"]["param_groups"][0]["lr"]
        for k, v in one["model"].items():
            got = two["model"][k]
            assert torch.isfinite(got).all(), k
            atol = (1e-2 * float(v.abs().max()) if "running" in k
                    else 2 * lr * step)
            torch.testing.assert_close(got, v, rtol=0, atol=atol, msg=k)


def test_a_second_two_rank_run_resumes_at_the_last_checkpoint(video_dirs, trained):
    """Every rank resumes from the same newest file: no step runs, and rank 0
    rewrites the last checkpoint with the model it loaded."""
    a, _ = video_dirs
    folder = os.path.join(a, "models", "dino_tracker")
    before = ckpt.load_state(folder, 4)["model"]
    reports = train_cli.main(train_args(a, 2))
    assert all(not any(k.startswith("train/steps") for k in r["stages"]) for r in reports)
    assert ckpt.checkpoint_steps(folder) == [4, 2]
    for k, v in ckpt.load_state(folder, 4)["model"].items():
        assert torch.equal(v, before[k]), k


def test_each_rank_reports_its_own_timers(trained):
    two, one = trained
    assert len(two) == 2 and len(one) == 1
    for report in two:
        stages = report["stages"]
        for gates in ("off", "on"):
            own = stages[f"train/steps_gates_{gates}"]["total_s"]
            slowest = stages[f"train/steps_gates_{gates}/slowest_rank"]["total_s"]
            assert 0 < own <= slowest
        assert list(report["launches"]) == list(_guard.KERNELS)
    assert "train/checkpoint" in two[0]["stages"]      # rank 0 writes
    assert "train/checkpoint" not in two[1]["stages"]


def test_inference_cli_on_two_ranks_matches_one_device(video_dirs, trained):
    a, _ = video_dirs
    args = ["--config", os.path.join(a, "train.yaml"), "--data-path", a,
            "--benchmark-pickle-path", os.path.join(a, "bench.pkl"), "--device", "cpu"]

    def outputs():
        out = {}
        for f in (0, 3):
            out[f] = (np.load(os.path.join(a, "trajectories", f"trajectories_{f}.npy")),
                      np.load(os.path.join(a, "occlusions", f"occlusion_preds_{f}.npy")))
        shutil.rmtree(os.path.join(a, "trajectories"))
        shutil.rmtree(os.path.join(a, "occlusions"))
        return out

    inference_benchmark.main(args + ["--devices", "2"])
    two = outputs()
    inference_benchmark.main(args + ["--devices", "1"])
    one = outputs()
    for f in (0, 3):
        assert two[f][0].shape == (3 if f == 0 else 1, 5, 2)
        np.testing.assert_allclose(two[f][0], one[f][0], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(two[f][1], one[f][1])
