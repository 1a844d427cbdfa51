"""device_idle.dp4: the largest share, over the ranks, of the traced
stretches of mesh train steps in which no operation ran on the card, NCCL's
kernels not counted as busy (they spin while they wait for a peer), in
percent. Moves ``train_ms_per_iter``."""


def read(record):
    ranks = [r.get("trace") for r in record.get("ranks", [])]
    if not ranks or any(t is None or t.window_s <= 0 for t in ranks):
        return None
    idle = [1.0 - t.busy_s_without("nccl") / t.window_s for t in ranks]
    return 100.0 * max(idle) if all(t.busy_s > 0 for t in ranks) else None
