"""Preprocessing CLI of the port (reference preprocessing/main_preprocessing.py
and preprocessing_dino_bb/main_dino_bb_preprocessing.py), every stage in one
process, or in one process per rank with ``--devices N``:

    python -m dino_tracker_tpu_torch.cli.preprocess --data-path D \\
        --raft-checkpoint raft-things.pth --dino-checkpoint dinov2_vitl14.pth \\
        [--config config/preprocessing.yaml] [--device cpu] [--devices N]
        [--share-device]

``D/video/`` holds the frames; every artifact of the JAX package's
preprocessing is written under ``D`` in its layout, and the port's
``cli.train`` trains on the result. ``--devices N`` shards the ViT frames,
RAFT's frames and pairs, the best-buddy pairs and the ambiguity rows over N
ranks (``cli/_ranks.py``); rank 0 writes the artifacts. ``main`` returns
each rank's report: its ``timings``, ``telemetry`` and
``utils.profiling.rank_report``.
"""

import argparse

from . import _ranks


def _preprocess(mesh, args):
    from ..config import PreprocessConfig
    from ..preprocessing.pipeline import PreprocessingPipeline
    from ..utils import profiling
    device = _ranks.setup(mesh, args)
    pipe = PreprocessingPipeline.from_checkpoints(
        args.data_path, PreprocessConfig.from_yaml(args.config), args.raft_checkpoint,
        args.dino_checkpoint, device, mesh=mesh)
    pipe.run()
    # not the pipeline: a rank's return value is saved to disk, and the
    # pipeline holds the ViT and the feature video
    return dict(timings=pipe.timings, telemetry=pipe.telemetry,
                **profiling.rank_report(device))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config/preprocessing.yaml")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--raft-checkpoint", default=None,
                        help="princeton-vl RAFT checkpoint (raft-things.pth)")
    parser.add_argument("--dino-checkpoint", default=None,
                        help="DINOv2 state-dict checkpoint (.pth/.npz)")
    _ranks.add_arguments(parser)
    return _ranks.run(_preprocess, parser.parse_args(argv))


if __name__ == "__main__":
    main()
