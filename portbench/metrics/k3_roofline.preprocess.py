"""k3_roofline.preprocess: K3 (``corr_lookup_kernel``) over a traced video,
its bound over its measured time at the decode batches' shape, in percent
(``yardstick.rooflines.k3``). Moves ``preprocess_s_per_video``."""

from yardstick import rooflines


def read(record):
    return rooflines.k3(record)
