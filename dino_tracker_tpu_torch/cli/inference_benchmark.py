"""TAP-Vid benchmark inference CLI of the port (reference
inference_benchmark.py); serves the newest readable checkpoint: the port
trainer's state_<step>.pt, else the JAX trainer's state_<step>.msgpack.
``--devices N`` shards the refine and the prediction rows over N ranks
(``cli/_ranks.py``); rank 0 writes the files. ``main`` returns each rank's
``utils.profiling.rank_report`` with the checkpoint file it served
(``checkpoint``)."""

import argparse

from . import _ranks


def _infer(mesh, args):
    from ..config import TrainConfig
    from ..runtime import DINOTrackerRuntime
    from ..utils import profiling
    device = _ranks.setup(mesh, args)
    rt = DINOTrackerRuntime(args.data_path, TrainConfig.from_yaml(args.config),
                            device, mesh=mesh)
    rt.infer_benchmark(args.benchmark_pickle_path, args.video_id,
                       step=args.iter, chunk=args.batch_size)
    return {**profiling.rank_report(device), "checkpoint": rt.checkpoint}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config/train.yaml")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--benchmark-pickle-path", required=True)
    parser.add_argument("--video-id", type=int, default=0)
    parser.add_argument("--iter", type=int, default=None,
                        help="checkpoint iteration (default: latest)")
    parser.add_argument("--batch-size", type=int, default=4096)
    _ranks.add_arguments(parser)
    return _ranks.run(_infer, parser.parse_args(argv))


if __name__ == "__main__":
    main()
