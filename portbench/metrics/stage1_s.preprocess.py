"""stage1_s.preprocess: seconds a video spends in stage 1 (RAFT flows and
both passes of chaining), the program's own ``preprocess/trajectories``
stage timer (host clock, fenced on the card), averaged over the window's
videos. Moves ``preprocess_s_per_video``."""


def read(record):
    if not record.get("card") or "stage1_s" not in record:
        return None
    return record["stage1_s"]
