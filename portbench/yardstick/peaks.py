"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full power limit of 700 W) and the least time a piece of work
can take on it."""

BF16_FLOPS = 989e12   # dense bf16 / fp16 tensor-core FLOP/s
F32_FLOPS = 67e12     # f32 outside the tensor cores
HBM_BYTES = 3.35e12   # device-memory bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least seconds for ``flops`` operations at ``peak_flops`` and
    ``nbytes`` moved to or from device memory, whichever bounds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
