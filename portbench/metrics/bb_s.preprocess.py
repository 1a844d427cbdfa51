"""bb_s.preprocess: seconds of a traced video's best-buddy stage (the
program's ``preprocess/best_buddies`` span, on the trace's clock). Moves
``preprocess_s_per_video``."""

from yardstick import spans


def read(record):
    return spans.per_video(record, lambda host, device: spans.span_s(
        host, ["preprocess/best_buddies"]))
