"""k1_bwd_roofline.train: K1-bwd (``blurpool_up_kernel``) over the traced
train steps, its bound over its measured time at the step's three blurpool
shapes, in percent (``yardstick.rooflines.k1``). Moves
``train_ms_per_iter``."""

from yardstick import rooflines


def read(record):
    return rooflines.k1(record, "blurpool_up_kernel")
