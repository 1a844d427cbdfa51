"""Per-video test-time training CLI of the port (reference train.py):

    python -m dino_tracker_tpu_torch.cli.train --data-path D [--device cpu]

Writes ``D/models/dino_tracker/state_<step>.pt`` and resumes from the newest
one it can read; the port's inference CLIs serve it.
"""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config/train.yaml")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--seed", default=2, type=int)
    parser.add_argument("--devices", type=int, default=0, choices=(0, 1),
                        help="single device only in this port (0 or 1)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    from dino_tracker_tpu.config import TrainConfig
    from ..runtime import DINOTrackerRuntime

    cfg = TrainConfig.from_yaml(args.config)
    DINOTrackerRuntime(args.data_path, cfg, torch.device(args.device),
                       seed=args.seed).train()


if __name__ == "__main__":
    main()
