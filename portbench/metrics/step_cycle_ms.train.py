"""step_cycle_ms.train: device ms a traced train step spends in the
cycle-consistency term's forward, its data and its heads included (the
program's ``train/step/cycle`` span), averaged over the traced stretches'
steps. Moves ``train_ms_per_iter``."""

from yardstick import spans


def read(record):
    try:
        from dino_tracker_tpu_torch.utils.profiling import stage_report
    except ImportError:  # no program to read
        return None
    return spans.step_ms(record, stage_report(), ["cycle"])
