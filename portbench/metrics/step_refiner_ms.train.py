"""step_refiner_ms.train: device ms a traced train step spends in the
DeltaDINO refiner, forward and backward (the program's
``train/step/refiner`` and ``train/step/refiner_bwd`` spans), averaged over
the traced stretches' steps. Moves ``train_ms_per_iter``."""

from yardstick import spans


def read(record):
    try:
        from dino_tracker_tpu_torch.utils.profiling import stage_report
    except ImportError:  # no program to read
        return None
    return spans.step_ms(record, stage_report(), ["refiner", "refiner_bwd"])
