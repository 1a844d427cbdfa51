"""stage1_decode_s.preprocess: device seconds of a traced video's stage-1
RAFT work: the operations launched inside the program's
``preprocess/trajectories/encode``, ``.../adjacent_flows`` and
``.../direct_flows`` spans, matched by the trace's correlation ids. Moves
``preprocess_s_per_video``."""

from yardstick import spans

DECODE = ["preprocess/trajectories/encode", "preprocess/trajectories/adjacent_flows",
          "preprocess/trajectories/direct_flows"]


def read(record):
    return spans.per_video(record, lambda host, device: spans.launched_in_s(host, device, DECODE))
