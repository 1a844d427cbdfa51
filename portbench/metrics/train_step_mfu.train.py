"""train_step_mfu.train: the train step's model FLOPs (``yardstick.counts``)
over the step time of the measured window times the H100's dense bf16 peak,
in percent. Moves ``train_ms_per_iter``."""

from yardstick import peaks


def read(record):
    if not record.get("card") or not record.get("step_s"):  # a device metric: the card's
        return None
    return 100.0 * record["flops_per_step"] / (record["step_s"] * peaks.BF16_FLOPS)
