"""device_idle.train: the share of the traced stretches of train steps in
which no operation ran on the card (``torch.profiler``), in percent. Moves
``train_ms_per_iter``."""

from yardstick import rooflines


def read(record):
    return rooflines.idle(record)
