"""step_contrastive_ms.train: device ms a traced train step spends in the
two best-buddy contrastive terms' forward, the refined term's mining
included (the program's ``train/step/contrastive_dino`` and, where its gate
is on, ``train/step/contrastive_ref`` spans), averaged over the traced
stretches' steps. Moves ``train_ms_per_iter``."""

from yardstick import spans


def read(record):
    try:
        from dino_tracker_tpu_torch.utils.profiling import stage_report
    except ImportError:  # no program to read
        return None
    return spans.step_ms(record, stage_report(), ["contrastive_dino"], optional=["contrastive_ref"])
