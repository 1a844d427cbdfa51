"""step_head_ms.train: device ms a traced train step spends in the tracker
head's forward, every call inside the flow and cycle terms (the program's
``train/step/head`` span), averaged over the traced stretches' steps. Moves
``train_ms_per_iter``."""

from yardstick import spans


def read(record):
    try:
        from dino_tracker_tpu_torch.utils.profiling import stage_report
    except ImportError:  # no program to read
        return None
    return spans.step_ms(record, stage_report(), ["head"])
