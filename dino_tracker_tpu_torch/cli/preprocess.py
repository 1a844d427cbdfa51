"""Preprocessing CLI of the port (reference preprocessing/main_preprocessing.py
and preprocessing_dino_bb/main_dino_bb_preprocessing.py), every stage in one
process:

    python -m dino_tracker_tpu_torch.cli.preprocess --data-path D \\
        --raft-checkpoint raft-things.pth --dino-checkpoint dinov2_vitl14.pth \\
        [--config config/preprocessing.yaml] [--device cpu]

``D/video/`` holds the frames; every artifact of the JAX package's
preprocessing is written under ``D`` in its layout, and the port's
``cli.train`` trains on the result.
"""

import argparse
import logging


def main(argv=None):
    """Runs the pipeline and returns it (its ``timings`` and ``telemetry``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config/preprocessing.yaml")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--raft-checkpoint", default=None,
                        help="princeton-vl RAFT checkpoint (raft-things.pth)")
    parser.add_argument("--dino-checkpoint", default=None,
                        help="DINOv2 state-dict checkpoint (.pth/.npz)")
    parser.add_argument("--devices", type=int, default=0, choices=(0, 1),
                        help="0 or 1: preprocessing runs on one device; its "
                             "stages do not shard over ranks yet")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    from ..config import PreprocessConfig
    from ..preprocessing.pipeline import PreprocessingPipeline

    pipe = PreprocessingPipeline.from_checkpoints(
        args.data_path, PreprocessConfig.from_yaml(args.config), args.raft_checkpoint,
        args.dino_checkpoint, torch.device(args.device))
    pipe.run()
    return pipe


if __name__ == "__main__":
    main()
