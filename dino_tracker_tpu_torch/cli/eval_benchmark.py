"""Dataset evaluation CLI of the port (reference eval/eval_benchmark.py):
walks a root of per-video prediction directories and writes a per-video
metrics CSV with a last ``average`` row:

    python -m dino_tracker_tpu_torch.cli.eval_benchmark --dataset-root-dir R \\
        --benchmark-pickle-path P [--out-file comp_metrics.csv]

The CSV is the one the JAX CLI writes with pandas, written with the ``csv``
module: the header ``video_idx,<metrics>``, rows in ``sorted(os.listdir)``
order, the average a per-column mean that skips NaN (pandas' ``mean``), and
NaN written as an empty field.
"""

import argparse
import csv
import os

import numpy as np


def nanmean(values) -> float:
    """pandas' ``Series.mean()``: the sum of the non-NaN values over their
    count, NaN where there is none."""
    x = np.asarray(values, np.float64)
    keep = ~np.isnan(x)
    n = int(keep.sum())
    return float(np.where(keep, x, 0.0).sum() / n) if n else float("nan")


def csv_field(value) -> str:
    return "" if isinstance(value, float) and np.isnan(value) else repr(value)


def main(argv=None):
    """Writes the CSV, prints the average row and returns the rows:
    ``[(video_idx or "average", {metric: value}), ...]``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root-dir", required=True)
    parser.add_argument("--benchmark-pickle-path", required=True)
    parser.add_argument("--out-file", default="./comp_metrics.csv")
    parser.add_argument("--dataset-type", default="tapvid",
                        choices=["tapvid", "BADJA"])
    parser.add_argument("--pred-w", type=int, default=854)
    parser.add_argument("--pred-h", type=int, default=476)
    args = parser.parse_args(argv)

    from ..evaluation import metrics as M
    from ..evaluation.tapvid import load_benchmark
    from ..utils.profiling import stage_timer

    benchmark_data = load_benchmark(args.benchmark_pickle_path)
    rows = []
    for name in sorted(os.listdir(args.dataset_root_dir)):
        if name.startswith("."):
            continue
        video_dir = os.path.join(args.dataset_root_dir, name)
        if not os.path.isdir(video_dir):
            continue
        video_idx = int(name)
        with stage_timer(f"eval/{name}"):
            if args.dataset_type == "tapvid":
                m = M.compute_tapvid_metrics_for_video(
                    os.path.join(video_dir, "trajectories"),
                    os.path.join(video_dir, "occlusions"),
                    benchmark_data, video_idx,
                    pred_video_sizes=[args.pred_w, args.pred_h])
            else:
                m = M.compute_badja_metrics_for_video(
                    os.path.join(video_dir, "trajectories"),
                    benchmark_data, video_idx,
                    pred_video_sizes=[args.pred_w, args.pred_h])
        rows.append((video_idx, m))
    if not rows:
        raise ValueError(f"no video directories under {args.dataset_root_dir}")

    columns = list(rows[0][1])
    average = {c: nanmean([m[c] for _, m in rows]) for c in columns}
    rows.append(("average", average))
    os.makedirs(os.path.dirname(args.out_file) or ".", exist_ok=True)
    with open(args.out_file, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["video_idx", *columns])
        for label, m in rows:
            out.writerow([label, *(csv_field(m[c]) for c in columns)])
    print("Total metrics:")
    for c in columns:
        print(f"{c}: {average[c]}")
    return rows


if __name__ == "__main__":
    main()
