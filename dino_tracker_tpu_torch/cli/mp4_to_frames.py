"""Video file → frame folder CLI of the port (reference
preprocessing/mp4_to_frames.py):

    python -m dino_tracker_tpu_torch.cli.mp4_to_frames --video-path V.mp4 \\
        --output-folder D/video

Needs imageio with an mp4 reader; the jpgs are the JAX CLI's bytes.
"""

import argparse

from ..utils.video_io import mp4_to_frames


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--video-path", required=True)
    parser.add_argument("--output-folder", required=True)
    args = parser.parse_args(argv)
    mp4_to_frames(args.video_path, args.output_folder)


if __name__ == "__main__":
    main()
