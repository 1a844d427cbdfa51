"""Whole-benchmark fan-out CLI of the port: preprocess→train→inference for
every video directory under a dataset root, in one process on one device
(a work queue shared across hosts through --claim-dir):

    python -m dino_tracker_tpu_torch.cli.run_benchmark --dataset-root-dir R \\
        --benchmark-pickle-path P --raft-checkpoint raft-things.pth \\
        --dino-checkpoint dinov2_vitl14.pth [--device cpu]

then ``cli.eval_benchmark`` on the same root writes the metrics CSV.
"""

import argparse
import logging


def main(argv=None):
    """Runs the queue and returns the launcher (its per-video ``reports``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root-dir", required=True,
                        help="one subdir per video id, each with video/")
    parser.add_argument("--benchmark-pickle-path", required=True)
    parser.add_argument("--train-config", default="./config/train.yaml")
    parser.add_argument("--preprocess-config",
                        default="./config/preprocessing.yaml")
    parser.add_argument("--raft-checkpoint", default=None)
    parser.add_argument("--dino-checkpoint", default=None)
    parser.add_argument("--stages", nargs="+",
                        default=["preprocess", "train", "inference"])
    parser.add_argument("--claim-dir", default=None,
                        help="shared dir for multi-host work claims")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    from ..parallel.launcher import BenchmarkLauncher

    launcher = BenchmarkLauncher(
        dataset_root=args.dataset_root_dir,
        benchmark_pickle_path=args.benchmark_pickle_path,
        train_config_path=args.train_config,
        preprocess_config_path=args.preprocess_config,
        raft_checkpoint=args.raft_checkpoint,
        dino_checkpoint=args.dino_checkpoint,
        stages=tuple(args.stages),
        device=torch.device(args.device),
    )
    launcher.run(claim_dir=args.claim_dir)
    return launcher


if __name__ == "__main__":
    main()
