"""The port's multi-video launcher (``parallel/launcher.py``) and
``cli/run_benchmark.py``: the whole system, frame folder to metrics CSV.

The JAX launcher's claim and queue tests run against both launchers. The
whole system runs on the CPU on one tiny video (5 PNG frames at 42×56, the
small RAFT and ViT-S/14 ``.pth`` checkpoints and settings of
``test_torch_preprocess_run.py``, 4 training iterations across both phase
gates) and is held against the same directory built by the port's separate
CLIs (``cli.preprocess``, ``cli.train``, ``cli.inference_benchmark``, the same
seed): every artifact, every checkpoint tensor and every prediction must be
equal. Its eval row must equal the JAX package's
``compute_tapvid_metrics_for_video`` on the port's predictions. The slice is
held against the JAX package through that, and through the stage tests of
the earlier slices (``test_torch_preprocess_run.py``,
``test_torch_train_step.py``, ``test_torch_inference.py``), which hold each
CLI's work to the JAX package's.
"""

import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from dino_tracker_tpu.evaluation import metrics as jmetrics
from dino_tracker_tpu.parallel import launcher as jlauncher
from dino_tracker_tpu_torch.cli import eval_benchmark as eval_cli
from dino_tracker_tpu_torch.cli import inference_benchmark as inference_cli
from dino_tracker_tpu_torch.cli import preprocess as preprocess_cli
from dino_tracker_tpu_torch.cli import run_benchmark
from dino_tracker_tpu_torch.cli import train as train_cli
from dino_tracker_tpu_torch.config import add_config_paths
from dino_tracker_tpu_torch.parallel import launcher as plauncher
from dino_tracker_tpu_torch.utils import video_io
from test_torch_preprocess_run import (ARTIFACTS, H, T, W, video_dir, weights,  # noqa: F401
                                       write_checkpoints_and_config, write_train_config)
from test_torch_threads import one_thread  # noqa: F401

LAUNCHERS = pytest.mark.parametrize("launcher", [jlauncher, plauncher], ids=["jax", "port"])


def make_launcher(launcher, root, **kw):
    if launcher is plauncher:
        kw["device"] = "cpu"
    return launcher.BenchmarkLauncher(
        dataset_root=str(root), benchmark_pickle_path="x", train_config_path="x",
        preprocess_config_path="x", **kw)


@LAUNCHERS
def test_claims_are_exclusive(tmp_path, launcher):
    d = str(tmp_path)
    assert launcher.claim_video(d, "0")
    assert not launcher.claim_video(d, "0")  # second claim loses
    assert launcher.claim_video(d, "1")
    assert not launcher.is_done(d, "0")
    launcher.mark_done(d, "0")
    assert launcher.is_done(d, "0")


@LAUNCHERS
def test_video_id_listing(tmp_path, launcher):
    for name in ("0", "3", "1", ".hidden"):
        (tmp_path / name).mkdir()
    (tmp_path / "file.txt").write_text("x")
    assert make_launcher(launcher, tmp_path).video_ids() == ["0", "1", "3"]


@LAUNCHERS
def test_run_loop_claims_failures_and_completion(tmp_path, launcher):
    """Two launchers sharing a claim dir process each video exactly once;
    a failing video is claimed (not retried by the peer) but never marked
    done, and the loop continues past it."""
    root = tmp_path / "videos"
    root.mkdir()
    for v in ("0", "1", "2"):
        (root / v).mkdir()
    claim_dir = str(tmp_path / "claims")
    processed = []

    def make(fail=()):
        b = make_launcher(launcher, root)

        def fake_run_video(video_id):
            processed.append(video_id)
            if video_id in fail:
                raise RuntimeError("boom")

        b.run_video = fake_run_video
        return b

    make(fail=("1",)).run(claim_dir=claim_dir)
    assert processed == ["0", "1", "2"]
    assert launcher.is_done(claim_dir, "0")
    assert not launcher.is_done(claim_dir, "1")  # failed: not done
    assert launcher.is_done(claim_dir, "2")

    # a second host joins: everything claimed -> nothing re-processed,
    # including the failed video (its claim stands until manually cleared)
    make().run(claim_dir=claim_dir)
    assert processed == ["0", "1", "2"]

    # clearing the failed claim lets the next pass retry exactly it
    os.remove(os.path.join(claim_dir, "1.claim"))
    make().run(claim_dir=claim_dir)
    assert processed == ["0", "1", "2", "1"]
    assert launcher.is_done(claim_dir, "1")


def test_video_index_resolved_before_any_stage(tmp_path, monkeypatch, caplog):
    """A directory name that is no benchmark index fails before
    preprocessing or training start; the loop logs it, leaves it claimed and
    not done, and reports nothing for it."""
    from dino_tracker_tpu_torch.preprocessing import pipeline
    from dino_tracker_tpu_torch import runtime
    started = []
    monkeypatch.setattr(pipeline.PreprocessingPipeline, "from_checkpoints",
                        classmethod(lambda *a, **k: started.append("preprocess")))
    monkeypatch.setattr(runtime.DINOTrackerRuntime, "__post_init__",
                        lambda self: started.append("runtime"))
    (tmp_path / "videos" / "bear").mkdir(parents=True)
    b = make_launcher(plauncher, tmp_path / "videos")
    with pytest.raises(ValueError, match="not an integer benchmark index"):
        b.run_video("bear")
    claims = str(tmp_path / "claims")
    with caplog.at_level(logging.ERROR):
        b.run(claim_dir=claims)
    assert started == [] and b.reports == {}
    assert "video bear failed" in caplog.text
    assert os.path.exists(os.path.join(claims, "bear.claim"))
    assert not plauncher.is_done(claims, "bear")


QUERY_FRAMES = (0, 2)
N_POINTS = 6


def write_benchmark(path):
    """Video 0 at the frames' own size: points on query frames 0 and 2 that
    move (1.0, 0.5) px a frame, occluded where they leave the frame."""
    rng = np.random.default_rng(31)
    entry = {"video_idx": 0, "h": H, "w": W, "query_points": {}, "target_points": {},
             "occluded": {}}
    for f in QUERY_FRAMES:
        q = rng.random((N_POINTS, 2)) * [W - 1, H - 1]
        tracks = q[:, None] + (np.arange(T) - f)[None, :, None] * [1.0, 0.5]
        entry["query_points"][f] = q.tolist()
        entry["target_points"][f] = tracks.astype(np.float32)
        entry["occluded"][f] = ((tracks < 0) | (tracks > [W - 1, H - 1])).any(-1)
    with open(path, "wb") as f:
        pickle.dump({"videos": [entry]}, f)
    return str(path)


def assert_same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)  # NaN where NaN
    else:
        assert a == b, where


def read_tree(data_path):
    """Every file the stages wrote under a video directory, read back:
    arrays for .npz/.npy, tensors for checkpoints, bytes for the rest
    (``bb_truncation.json`` without its timings)."""
    out = {}
    for dirpath, _, names in os.walk(data_path):
        for name in names:
            path = os.path.join(dirpath, name)
            key = os.path.relpath(path, data_path)
            if name.endswith(".npz"):
                out[key] = video_io.load_npz(path)
            elif name.endswith(".npy"):
                out[key] = np.load(path)
            elif name.endswith(".pt"):
                out[key] = torch.load(path, map_location="cpu", weights_only=False)
            elif name == "bb_truncation.json":
                with open(path) as f:
                    tel = json.load(f)
                tel.pop("phases")
                out[key] = tel
            else:
                with open(path, "rb") as f:
                    out[key] = f.read()
    return out


def test_run_benchmark_equals_the_separate_clis(tmp_path, weights):  # noqa: F811
    raft_path, vit_path, pre_yaml = write_checkpoints_and_config(tmp_path, weights[0])
    train_yaml = write_train_config(tmp_path / "train.yaml", iterations=4, gates_after=2)
    pkl = write_benchmark(tmp_path / "bench.pkl")
    root = tmp_path / "bench"
    video_dir(root, "0")
    claims = str(tmp_path / "claims")
    launcher = run_benchmark.main([
        "--dataset-root-dir", str(root), "--benchmark-pickle-path", pkl,
        "--train-config", train_yaml, "--preprocess-config", pre_yaml,
        "--raft-checkpoint", raft_path, "--dino-checkpoint", vit_path,
        "--claim-dir", claims, "--device", "cpu"])
    assert plauncher.is_done(claims, "0")
    stages = launcher.reports["0"]["stages"]
    assert {"video/preprocess", "video/train", "video/inference", "preprocess/best_buddies",
            "train/load_data", "train/init", "train/steps_gates_off", "train/steps_gates_on",
            "train/checkpoint", "inference/refine", "inference/query_frame_0",
            "inference/query_frame_2"} <= stages.keys()
    assert stages["video/train"]["calls"] == stages["train/steps_gates_on"]["calls"] == 1
    assert stages["train/checkpoint"]["calls"] == 2  # the interval save and the last

    # the same video through the port's separate CLIs, in a directory of its own
    sep = video_dir(tmp_path / "separate", "0")
    preprocess_cli.main(["--config", pre_yaml, "--data-path", sep, "--raft-checkpoint",
                         raft_path, "--dino-checkpoint", vit_path, "--device", "cpu"])
    train_cli.main(["--config", train_yaml, "--data-path", sep, "--device", "cpu"])
    inference_cli.main(["--config", train_yaml, "--data-path", sep, "--benchmark-pickle-path",
                        pkl, "--video-id", "0", "--device", "cpu"])
    got, want = read_tree(str(root / "0")), read_tree(sep)
    paths = add_config_paths(sep)
    for key in ARTIFACTS:
        assert os.path.relpath(paths[key], sep) in want, key
    assert {"models/dino_tracker/state_2.pt", "models/dino_tracker/state_4.pt",
            "trajectories/trajectories_2.npy", "occlusions/occlusion_preds_2.npy"} <= want.keys()
    assert sorted(got) == sorted(want)
    for key in want:
        assert_same(got[key], want[key], key)

    # the eval CSV's row: the JAX package's metrics on the port's predictions
    rows = eval_cli.main(["--dataset-root-dir", str(root), "--benchmark-pickle-path", pkl,
                          "--pred-w", str(W), "--pred-h", str(H),
                          "--out-file", str(tmp_path / "metrics.csv")])
    d = str(root / "0")
    with open(pkl, "rb") as f:
        bench = pickle.load(f)
    ref = jmetrics.compute_tapvid_metrics_for_video(
        os.path.join(d, "trajectories"), os.path.join(d, "occlusions"), bench, 0,
        pred_video_sizes=[W, H])
    assert [label for label, _ in rows] == [0, "average"]
    assert rows[0][1] == ref == rows[1][1]
    assert all(0 <= v <= 1 for v in ref.values())
