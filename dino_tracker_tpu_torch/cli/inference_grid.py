"""Grid-query inference CLI of the port (reference inference_grid.py);
serves the newest checkpoint: the port trainer's state_<step>.pt, else the
JAX trainer's state_<step>.msgpack."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config/train.yaml")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--iter", type=int, default=None)
    parser.add_argument("--start-frame", type=int, default=0)
    parser.add_argument("--interval", type=int, default=10)
    parser.add_argument("--use-segm-mask", action="store_true", default=False)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--devices", type=int, default=0, choices=(0, 1),
                        help="single device only in this port (0 or 1)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    from ..config import TrainConfig
    from ..runtime import DINOTrackerRuntime

    cfg = TrainConfig.from_yaml(args.config)
    rt = DINOTrackerRuntime(args.data_path, cfg, torch.device(args.device))
    rt.infer_grid(interval=args.interval, start_frame=args.start_frame,
                  use_segm_mask=args.use_segm_mask, step=args.iter,
                  chunk=args.batch_size)


if __name__ == "__main__":
    main()
