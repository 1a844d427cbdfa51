"""step_flow_term_ms.train: device ms a traced train step spends in the
optical-flow term's forward, its head included (the program's
``train/step/flow_term`` span), averaged over the traced stretches' steps.
Moves ``train_ms_per_iter``."""

from yardstick import spans


def read(record):
    try:
        from dino_tracker_tpu_torch.utils.profiling import stage_report
    except ImportError:  # no program to read
        return None
    return spans.step_ms(record, stage_report(), ["flow_term"])
