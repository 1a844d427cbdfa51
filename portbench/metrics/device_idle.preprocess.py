"""device_idle.preprocess: the share of a traced video's preprocessing in
which no operation ran on the card (``torch.profiler``), in percent. Moves
``preprocess_s_per_video``."""

from yardstick import rooflines


def read(record):
    return rooflines.idle(record)
