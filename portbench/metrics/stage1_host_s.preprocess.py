"""stage1_host_s.preprocess: seconds of a traced video's stage 1 (the
program's ``preprocess/trajectories`` span) in which no operation ran on
the card. Moves ``preprocess_s_per_video``."""

from yardstick import spans


def read(record):
    return spans.per_video(record, lambda host, device: spans.idle_in_s(
        host, device, ["preprocess/trajectories"]))
