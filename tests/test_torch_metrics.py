"""The port's TAP-Vid / BADJA metrics and its eval CLI, held against the JAX
package's on the same seeded inputs.

The metrics are numpy in both packages with the same arithmetic, so every
value must be exactly equal, NaN where NaN (a track or video with no visible
evaluation point divides 0 by 0). The port's CSV, written with the ``csv``
module, must read as the JAX CLI's pandas CSV: header, row labels in string
order, every number, and empty fields where pandas writes NaN.
"""

import csv
import os
import pickle
import sys

import numpy as np
import pytest

from dino_tracker_tpu.cli import eval_benchmark as jeval_cli
from dino_tracker_tpu.evaluation import metrics as jmetrics
from dino_tracker_tpu_torch.cli import eval_benchmark as eval_cli
from dino_tracker_tpu_torch.evaluation import metrics


def assert_metrics_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def batch(seed, b=2, n=7, t=9):
    """(query_points, gt_occluded, gt_tracks, pred_occluded, pred_tracks) in
    256×256 coordinates; track (0, 0) is never visible."""
    rng = np.random.default_rng(seed)
    qp = np.concatenate([rng.integers(0, t, (b, n, 1)).astype(np.float32),
                         rng.random((b, n, 2), dtype=np.float32) * 256], -1)
    gt_occ = rng.random((b, n, t)) < 0.3
    gt_occ[0, 0] = True
    pred_occ = rng.random((b, n, t)) < 0.3
    gt = rng.random((b, n, t, 2)).astype(np.float32) * 256
    pred = gt + rng.standard_normal((b, n, t, 2)).astype(np.float32) * 6
    return qp, gt_occ, gt, pred_occ, pred


@pytest.mark.parametrize("trackwise", [False, True])
@pytest.mark.parametrize("mode", ["first", "strided"])
def test_tapvid_metrics_equal_jax(mode, trackwise):
    args = batch(3)
    got = metrics.compute_tapvid_metrics(*args, query_mode=mode,
                                         get_trackwise_metrics=trackwise)
    want = jmetrics.compute_tapvid_metrics(*args, query_mode=mode,
                                           get_trackwise_metrics=trackwise)
    assert_metrics_equal(got, want)
    if trackwise:  # the never-visible track
        assert np.isnan(got["pts_within_1"][0, 0])
        assert np.isnan(got["average_pts_within_thresh"][0, 0])
        assert got["average_jaccard"].shape == (2, 7)
    else:
        assert np.isfinite(got["average_jaccard"]).all()
    with pytest.raises(ValueError, match="Unknown query mode"):
        metrics.compute_tapvid_metrics(*args, query_mode="last")


def video_entry(rng, idx, h, w, t, n, frames=(0, 3), all_occluded=False):
    """A benchmark video (original resolution h×w) and its saved predictions
    at the model resolution ``PRED`` (w, h)."""
    entry = {"video_idx": idx, "h": h, "w": w, "query_points": {}, "target_points": {},
             "occluded": {}}
    preds = {}
    for f in frames:
        gt = (rng.random((n, t, 2)) * [w - 1, h - 1]).astype(np.float32)
        occ = rng.random((n, t)) < 0.25
        if all_occluded:
            occ[:] = True
        entry["query_points"][f] = [[float(x), float(y)] for x, y in gt[:, f]]
        entry["target_points"][f] = gt
        entry["occluded"][f] = occ
        scale = np.asarray([PRED[0] / w, PRED[1] / h], np.float32)
        pred = gt * scale + rng.standard_normal((n, t, 2)).astype(np.float32) * 2
        pocc = occ if all_occluded else rng.random((n, t)) < 0.25
        preds[f] = (pred, pocc)
    entry["segmentations"] = (rng.random((t, h, w)) < 0.4).astype(np.uint8)
    return entry, preds


PRED = (64, 48)


def write_root(tmp_path, names=("0", "2", "10"), nan_video="2"):
    """A dataset root with one prediction directory per video id and the
    benchmark pickle; ``nan_video`` has no visible evaluation point."""
    rng = np.random.default_rng(7)
    root = tmp_path / "root"
    videos = []
    for name in names:
        entry, preds = video_entry(rng, int(name), 90, 120, 6, 5,
                                   all_occluded=name == nan_video)
        videos.append(entry)
        for sub in ("trajectories", "occlusions"):
            (root / name / sub).mkdir(parents=True)
        for f, (pred, pocc) in preds.items():
            np.save(root / name / "trajectories" / f"trajectories_{f}.npy", pred)
            np.save(root / name / "occlusions" / f"occlusion_preds_{f}.npy", pocc)
    (root / ".hidden").mkdir()
    (root / "notes.txt").write_text("x")
    pkl = tmp_path / "bench.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"videos": videos}, f)
    return str(root), str(pkl), {"videos": videos}


@pytest.mark.parametrize("sizes", [None, PRED])
def test_tapvid_metrics_for_video_equal_jax(tmp_path, sizes):
    root, _, bench = write_root(tmp_path)
    for name in ("0", "2"):
        d = os.path.join(root, name)
        args = (os.path.join(d, "trajectories"), os.path.join(d, "occlusions"), bench,
                int(name))
        got = metrics.compute_tapvid_metrics_for_video(*args, pred_video_sizes=sizes)
        want = jmetrics.compute_tapvid_metrics_for_video(*args, pred_video_sizes=sizes)
        assert list(got) == list(want)
        for k in want:
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
        assert np.isnan(got["average_jaccard"]) == (name == "2")


@pytest.mark.parametrize("sizes", [None, PRED])
def test_badja_metrics_for_video_equal_jax(tmp_path, sizes):
    root, _, bench = write_root(tmp_path)
    traj = os.path.join(root, "0", "trajectories")
    got = metrics.compute_badja_metrics_for_video(traj, bench, 0, pred_video_sizes=sizes)
    want = jmetrics.compute_badja_metrics_for_video(traj, bench, 0, pred_video_sizes=sizes)
    assert got == want and 0 <= got["acc_3px"] <= got["acc_seg"] <= 100


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("dataset_type", ["tapvid", "BADJA"])
def test_eval_cli_csv_equals_jax(tmp_path, monkeypatch, capsys, dataset_type):
    """Rows in string order ("10" before "2"), a NaN video whose metrics the
    average skips, empty fields where pandas writes NaN."""
    pytest.importorskip("pandas")
    root, pkl, _ = write_root(tmp_path)
    flags = ["--dataset-root-dir", root, "--benchmark-pickle-path", pkl,
             "--dataset-type", dataset_type, "--pred-w", str(PRED[0]),
             "--pred-h", str(PRED[1])]
    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "out" / "port.csv")
    monkeypatch.setattr(sys, "argv", ["eval_benchmark", *flags, "--out-file", jax_csv])
    if dataset_type == "BADJA":  # BADJA's all-occluded video: np.mean([]) is NaN
        with pytest.warns(RuntimeWarning):
            jeval_cli.main()
    else:
        jeval_cli.main()
    rows = eval_cli.main([*flags, "--out-file", port_csv])
    assert "Total metrics:" in capsys.readouterr().out
    got, want = read_csv(port_csv), read_csv(jax_csv)
    assert got == want  # every field as text: the same numbers and empty fields
    assert [r[0] for r in got] == ["video_idx", "0", "10", "2", "average"]
    assert any(x == "" for x in got[3])  # video 2's NaN fields
    assert all(x != "" for x in got[4])  # the average skips them
    assert [label for label, _ in rows] == [0, 10, 2, "average"]
