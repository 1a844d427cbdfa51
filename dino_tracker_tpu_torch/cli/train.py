"""Per-video test-time training CLI of the port (reference train.py):

    python -m dino_tracker_tpu_torch.cli.train --data-path D [--device cpu]
        [--devices N]

Writes ``D/models/dino_tracker/state_<step>.pt`` and resumes from the newest
one it can read; the port's inference CLIs serve it. ``--devices N`` trains
data parallel over N ranks (``cli/_ranks.py``); rank 0 writes the
checkpoints. ``main`` returns each rank's ``utils.profiling.rank_report``.
"""

import argparse

from . import _ranks


def _train(mesh, args):
    from ..config import TrainConfig
    from ..runtime import DINOTrackerRuntime
    from ..utils import profiling
    device = _ranks.setup(mesh, args)
    DINOTrackerRuntime(args.data_path, TrainConfig.from_yaml(args.config), device,
                       seed=args.seed, mesh=mesh).train()
    return profiling.rank_report(device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config/train.yaml")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--seed", default=2, type=int)
    _ranks.add_arguments(parser)
    return _ranks.run(_train, parser.parse_args(argv))


if __name__ == "__main__":
    main()
