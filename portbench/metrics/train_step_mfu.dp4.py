"""train_step_mfu.dp4: the global train step's model FLOPs over the
slowest rank's step time of the measured window times the four cards'
dense bf16 peak, in percent. Moves ``train_ms_per_iter``."""

from yardstick import peaks


def read(record):
    if not record.get("card") or not record.get("step_s") or "world" not in record:
        return None
    return 100.0 * record["flops_per_step"] / (record["step_s"] * record["world"] * peaks.BF16_FLOPS)
