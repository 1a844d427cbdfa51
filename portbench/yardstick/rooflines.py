"""Readings of a traced run: a kernel's share of its roofline (the summed
bound of its traced launches over their summed measured time) and the
device's idle share. A reading that finds nothing to read, or a launch count
other than the traced work makes, gives None."""

from . import counts, peaks


def k1(record, kernel: str):
    """K1 (either direction) at the train step's blurpool shapes, in percent;
    None where the trace holds no launch or not one a shape for each traced
    step (a CUDA graph's replays can lose kernels in a trace)."""
    trace, steps = record.get("trace"), record.get("traced_steps", 0)
    if trace is None or not steps:
        return None
    shapes = record["k1_shapes"]
    launches, seconds = trace.kernel(kernel)
    if launches != len(shapes) * steps or seconds <= 0:
        return None
    return 100.0 * steps * sum(counts.k1_bound_s(s) for s in shapes) / seconds


def _share(record, kernel, launches_expected, bound_s):
    trace = record.get("trace")
    if trace is None:
        return None
    launches, seconds = trace.kernel(kernel)
    if launches != launches_expected or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def k2(record, kernel="flash_fwd_wgmma_kernel"):
    """K2 over a traced video, in percent: every ViT block's attention of
    each frame batch, bf16 (``record["attention"]``)."""
    a = record.get("attention")
    if a is None:
        return None
    bound = a["depth"] * sum(counts.k2_bound_s(b, a["heads"], a["tokens"], a["head_dim"])
                             for b in a["batches"])
    return _share(record, kernel, a["depth"] * len(a["batches"]), bound)


def k3(record, kernel="corr_lookup_kernel"):
    """K3 over a traced video, in percent: every launch one decode batch of
    the same size (``record["k3"]``: its in-map cells and pixels, and the
    launches a video makes)."""
    k = record.get("k3")
    if k is None:
        return None
    flops, nbytes = counts.k3_counts(k["cells"], k["pixels"])
    bound = k["launches"] * peaks.bound_s(flops, nbytes, peaks.F32_FLOPS)
    return _share(record, kernel, k["launches"], bound)


def idle(record):
    """The traced share with no device operation, in percent; None without a
    trace of the card."""
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
