"""k2_roofline.preprocess: K2 (``flash_fwd_wgmma_kernel``) over a traced
video, its bound over its measured time at the ViT's attention shapes, in
percent (``yardstick.rooflines.k2``). Moves ``preprocess_s_per_video``."""

from yardstick import rooflines


def read(record):
    return rooflines.k2(record)
