"""nccl_ms_per_iter.dp4: rank 0's device time in NCCL kernels per traced
train step (waiting for its peers included), in ms. Moves
``train_ms_per_iter``."""


def read(record):
    ranks = record.get("ranks")
    if not ranks or ranks[0].get("trace") is None or not ranks[0].get("traced_steps"):
        return None
    launches, seconds = ranks[0]["trace"].kernel("nccl")
    return 1e3 * seconds / ranks[0]["traced_steps"] if launches else None
