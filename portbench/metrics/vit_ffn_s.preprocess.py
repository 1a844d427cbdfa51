"""vit_ffn_s.preprocess: device seconds of a traced video's ViT FFNs: the
operations launched inside the program's ``vit/ffn`` spans (each block's
norm2, its two linears and their gate, the layerscale and the residual
add), matched by the trace's correlation ids. None for a program without
the span. Moves ``preprocess_s_per_video``."""

from yardstick import spans

FFN = ["vit/ffn"]


def read(record):
    return spans.per_video(record, lambda host, device: spans.launched_in_s(host, device, FFN))
