"""Which checkpoint the port's inference serves, and what a runtime that
trained serves from.

With no step given, inference serves the newest READABLE checkpoint, as the
JAX runtime does (``training/checkpoint.py load_state(step=None)``): the
port's ``state_<step>.pt`` newest first, then the JAX trainer's
``state_<step>.msgpack`` newest first; a file cut by a kill mid-save is
logged and skipped. An explicit step on such a file raises. Through
``runtime.load_model``, both inference CLIs and the launcher, on one device
and on two gloo ranks (rank 0 picks the file, every rank loads it).

A ``DINOTrackerRuntime`` that trained keeps the frames and the feature stack
it loaded and serves from them without reading the disk again; its
predictions equal a fresh runtime's bit for bit.

The JAX package is reached only through its checkpoint module (never its
``DINOTrackerRuntime``, whose constructor turns on JAX's persistent compile
cache), and only inside functions: spawned ranks must not import JAX.
"""

import logging
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch import convert, runtime
from dino_tracker_tpu_torch.cli import inference_benchmark, inference_grid, run_benchmark
from dino_tracker_tpu_torch.config import TrackerConfig, TrainConfig
from dino_tracker_tpu_torch.models import tracker
from dino_tracker_tpu_torch.training import checkpoint as ckpt
from dino_tracker_tpu_torch.utils import video_io
from test_torch_threads import one_thread  # noqa: F401

H, W = 70, 98
CHANNELS = (3, 4, 4, 4, 16)
TCFG = TrackerConfig(video_h=H, video_w=W, delta_channels=CHANNELS,
                     compute_dtype="float32")
CPU = torch.device("cpu")


def model_state(seed):
    torch.manual_seed(seed)
    return tracker.Tracker(TCFG).state_dict()


def truncate_copy(src, dst):
    """``dst``: the first half of ``src``'s bytes, as a kill mid-save leaves
    a file."""
    with open(src, "rb") as f:
        blob = f.read()
    with open(dst, "wb") as f:
        f.write(blob[: len(blob) // 2])


def assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_pt_falls_back_past_a_truncated_newest(tmp_path, caplog):
    folder = str(tmp_path)
    good = ckpt.save_state(folder, {"model": model_state(10), "step": 10}, 10)
    truncate_copy(ckpt.save_state(folder, {"model": model_state(20), "step": 20}, 20),
                  os.path.join(folder, "state_20.pt"))
    with caplog.at_level(logging.WARNING, logger=runtime.logger.name):
        newest = runtime.load_model(folder, TCFG, CPU)
    assert any("state_20.pt" in r.getMessage() and r.levelno == logging.WARNING
               for r in caplog.records)
    assert_states_equal(newest.state_dict(),
                        runtime.load_model(folder, TCFG, CPU, step=10).state_dict())
    assert_states_equal(newest.state_dict(), model_state(10))
    assert runtime.read_checkpoint(folder)[0] == good
    with pytest.raises(Exception):
        runtime.load_model(folder, TCFG, CPU, step=20)


@pytest.fixture(scope="module")
def jax_states():
    """Two JAX train states of the small config (non-zero DeltaDINO
    residuals), and the restore template."""
    import jax
    from dino_tracker_tpu.config import TrainConfig as JTrainConfig
    from dino_tracker_tpu.training import train as jtrain
    from test_torch_model_slice import configs, jax_weights
    jcfg, _ = configs(CHANNELS)
    template = jtrain.init_train_state(jax.random.PRNGKey(0), JTrainConfig(), jcfg)
    states = {}
    for step, seed in ((3, 12), (6, 13)):
        params, stats = jax_weights(seed, CHANNELS)
        states[step] = template._replace(params=params, batch_stats=stats)
    return template, states


def test_msgpack_falls_back_past_a_truncated_newest(tmp_path, jax_states):
    """The port serves what the JAX ``load_state(step=None)`` restores from
    the same folder."""
    from dino_tracker_tpu.training import checkpoint as jckpt
    template, states = jax_states
    folder = str(tmp_path)
    jckpt.save_state(folder, states[3], 3)
    truncate_copy(jckpt.save_state(folder, states[6], 6),
                  os.path.join(folder, "state_6.msgpack"))
    restored = jckpt.load_state(folder, template, step=None)
    want = convert.state_from_jax(restored.params, restored.batch_stats)
    got = runtime.load_model(folder, TCFG, CPU).state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert runtime.read_checkpoint(folder)[0] == os.path.join(folder, "state_3.msgpack")
    with pytest.raises(Exception):
        runtime.load_model(folder, TCFG, CPU, step=6)

    # every .pt unreadable: the newest readable .msgpack
    truncate_copy(ckpt.save_state(folder, {"model": model_state(1)}, 9),
                  os.path.join(folder, "state_9.pt"))
    assert_states_equal(runtime.load_model(folder, TCFG, CPU).state_dict(), got)


def test_no_checkpoint_or_none_readable_raises(tmp_path):
    for folder in (tmp_path / "empty", tmp_path / "missing"):
        if folder.name == "empty":
            folder.mkdir()
        with pytest.raises(FileNotFoundError):
            runtime.load_model(str(folder), TCFG, CPU)
    folder = str(tmp_path / "broken")
    truncate_copy(ckpt.save_state(folder, {"model": model_state(0)}, 5),
                  os.path.join(folder, "state_5.pt"))
    bad = os.path.join(folder, "state_7.msgpack")
    with open(bad, "wb") as f:
        f.write(b"\xde\xad\xbe")
    with pytest.raises(Exception) as last:  # the last file tried: the .msgpack
        convert.load_jax_checkpoint(bad)
    with pytest.raises(type(last.value)):
        runtime.load_model(folder, TCFG, CPU)


def test_a_readable_state_of_another_width_raises(tmp_path):
    """Only the read is caught: a newest file that reads but does not fit
    the config is a wrong config, and no older file is served instead."""
    folder = str(tmp_path)
    ckpt.save_state(folder, {"model": model_state(1)}, 1)
    wide = TrackerConfig(video_h=H, video_w=W, delta_channels=(3, 4, 4, 8, 16))
    torch.manual_seed(0)
    ckpt.save_state(folder, {"model": tracker.Tracker(wide).state_dict()}, 2)
    with pytest.raises(RuntimeError, match="size mismatch"):
        runtime.load_model(folder, TCFG, CPU)


# --- a trained video directory: the CLIs, the launcher, two ranks, reuse ---

QUERIES = np.array([[20.0, 30.0, 0.0], [50.0, 40.0, 2.0], [70.0, 10.0, 4.0]],
                   np.float32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny video directory trained for 4 iterations by a runtime kept for
    inference (state_2.pt and state_4.pt), and a benchmark pickle."""
    from test_torch_train_step import video_arrays, write_video_dir
    base = tmp_path_factory.mktemp("runtime_ckpt")
    root = str(base / "trained")
    write_video_dir(root, video_arrays(4, t=5, c=384), 384)
    rt = runtime.DINOTrackerRuntime(
        root, TrainConfig.from_yaml(os.path.join(root, "train.yaml")), CPU)
    rt.train()
    assert ckpt.checkpoint_steps(os.path.join(root, "models", "dino_tracker")) == [4, 2]
    bench = str(base / "bench.pkl")
    with open(bench, "wb") as f:
        pickle.dump({"videos": [{"video_idx": 0, "h": H * 2, "w": W * 2,
                                 "query_points": {0: [[40.0, 60.0], [100.0, 20.0]],
                                                  3: [[150.0, 100.0]]}}]}, f)
    return base, root, rt, bench


def copy_dir(src, dst, cut=False):
    """A copy of the trained directory's inputs and checkpoints; ``cut``
    adds a truncated ``state_5.pt`` newer than any."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "trajectories", "occlusions", "grid_*"))
    if cut:
        folder = os.path.join(dst, "models", "dino_tracker")
        truncate_copy(ckpt.checkpoint_file(folder, 4), ckpt.checkpoint_file(folder, 5))
    return dst


def outputs(root):
    return {os.path.relpath(os.path.join(d, n), root): np.load(os.path.join(d, n))
            for sub in ("trajectories", "occlusions", "grid_trajectories",
                        "grid_occlusions")
            if os.path.isdir(d := os.path.join(root, sub))
            for n in sorted(os.listdir(d))}


def serve(entry, data_path, bench, yaml, extra=()):
    """Serve ``data_path`` through one entry point; returns its reports."""
    if entry == "run_benchmark":  # the launcher, inference alone: video "0"
        launcher = run_benchmark.main([
            "--dataset-root-dir", os.path.dirname(data_path),
            "--benchmark-pickle-path", bench, "--train-config", yaml,
            "--stages", "inference", "--device", "cpu"])
        assert "0" in launcher.reports  # the video did not fail
        return None
    args = ["--config", yaml, "--data-path", data_path, "--device", "cpu", *extra]
    if entry == "inference_benchmark":
        return inference_benchmark.main(args + ["--benchmark-pickle-path", bench])
    return inference_grid.main(args + ["--interval", "20"])


@pytest.mark.parametrize("entry", ["inference_benchmark", "inference_grid",
                                   "run_benchmark"])
def test_entry_points_serve_the_newest_readable_checkpoint(trained, entry):
    """Each entry point writes the same files with a truncated newest
    checkpoint in the folder as without it."""
    base, root, _, bench = trained
    yaml = os.path.join(root, "train.yaml")
    got, want = (copy_dir(root, str(base / entry / name / "0"), cut=name == "cut")
                 for name in ("cut", "good"))
    reports = [serve(entry, d, bench, yaml) for d in (got, want)]
    if reports[0] is not None:
        assert [r["checkpoint"] for r in reports[0]] == [
            os.path.join(got, "models", "dino_tracker", "state_4.pt")]
    got, want = outputs(got), outputs(want)
    assert got and got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_two_ranks_serve_the_same_readable_checkpoint(trained):
    """``--devices 2 --device cpu`` with a truncated newest file: both ranks
    serve state_4.pt, and the predictions equal one device's on the folder
    without the bad file."""
    base, root, _, bench = trained
    yaml = os.path.join(root, "train.yaml")
    got = copy_dir(root, str(base / "ranks" / "cut"), cut=True)
    want = copy_dir(root, str(base / "ranks" / "good"))
    reports = serve("inference_benchmark", got, bench, yaml, ["--devices", "2"])
    assert [r["checkpoint"] for r in reports] == [
        os.path.join(got, "models", "dino_tracker", "state_4.pt")] * 2
    serve("inference_benchmark", want, bench, yaml, ["--devices", "1"])
    got, want = outputs(got), outputs(want)
    assert got.keys() == want.keys() and len(got) == 4
    for k, v in want.items():
        if k.startswith("trajectories"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_two_ranks_fail_together_without_a_readable_checkpoint(trained):
    """Rank 0 finds no readable file: it raises its read error after telling
    the other rank, which raises too instead of waiting."""
    base, root, _, bench = trained
    got = copy_dir(root, str(base / "ranks_none" / "0"), cut=True)
    folder = os.path.join(got, "models", "dino_tracker")
    for step in (2, 4):
        os.remove(ckpt.checkpoint_file(folder, step))
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed") as failed:
        serve("inference_benchmark", got, bench, os.path.join(root, "train.yaml"),
              ["--devices", "2"])
    assert "found no readable checkpoint" in str(failed.value)
    assert "PytorchStreamReader" in str(failed.value)


def test_a_runtime_that_trained_serves_from_the_data_it_holds(trained, monkeypatch):
    """After ``train()`` the same runtime serves with the frame and feature
    reads patched to raise; its predictions equal a fresh runtime's bit for
    bit, and the training left the frames and features as they were read."""
    _, root, rt, _ = trained
    fresh = runtime.DINOTrackerRuntime(root, rt.cfg, CPU)
    want = fresh.get_model_inference().infer(QUERIES)
    data = fresh.load_video_data()
    assert torch.equal(rt._data.video, data.video)
    assert torch.equal(rt._data.dino_embed, data.dino_embed)
    assert rt._data.dino_embed.dtype == torch.float16

    def no_read(*args, **kwargs):
        raise AssertionError("read from disk")

    monkeypatch.setattr(video_io, "load_video", no_read)
    monkeypatch.setattr(video_io, "load_npz", no_read)
    assert rt.load_video_data() is rt._data
    got = rt.get_model_inference().infer(QUERIES)
    assert rt.checkpoint == fresh.checkpoint == ckpt.checkpoint_file(
        os.path.join(root, "models", "dino_tracker"), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
