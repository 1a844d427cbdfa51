"""Operations and bytes of the port's kernels and of one train step, computed
from shapes alone.

Each kernel's bound counts every input byte read once and every output byte
written once, whatever the kernel reads again.

* K1 (blurpool, forward and backward): the full-size and the half-size
  tensor each moved once; 16 multiply-adds per half-size value.
* K2 (flash attention): 4·b·h·s²·d operations; q, k, v and o each moved once.
* K3 (RAFT's correlation lookup): each pixel's in-map window cells at every
  pyramid level read once, its two coordinates read and its 324 outputs
  written once, 7 f32 operations an output.

The train step's model FLOPs count the work its algorithm needs, term by
term, from ``TrainConfig`` and ``TrackerConfig`` shapes: forward plus
backward is three times the forward where a term has gradients, once where it
runs under ``no_grad``; nothing recomputed is counted. Elementwise work,
sampling and the optimizer are left out (they are memory-bound and small in
operations).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from . import peaks

KERNEL_SIZE = 5               # DeltaDINO's convs
DILATIONS = (1, 1, 1, 2)
DOWNSAMPLE = (True, True, True, False)
HEAD_CHANNELS = (1, 16, 1)    # the tracker head's two 3x3 convs
HEAD_KERNEL = 3


def _half(n: int) -> int:
    return (n + 1) // 2


def k1_counts(shape: Sequence[int], itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one K1 launch, forward or backward, on the
    N×H×W×C full-size tensor ``shape``."""
    n, h, w, c = shape
    small = n * _half(h) * _half(w) * c
    return 32.0 * small, float((n * h * w * c + small) * itemsize)


def k1_bound_s(shape: Sequence[int], itemsize: int = 2) -> float:
    flops, nbytes = k1_counts(shape, itemsize)
    peak = peaks.BF16_FLOPS if itemsize == 2 else peaks.F32_FLOPS
    return peaks.bound_s(flops, nbytes, peak)


def k2_counts(b: int, h: int, s: int, d: int, itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one K2 launch: non-causal attention of b×h heads
    over s tokens of width d."""
    return 4.0 * b * h * s * s * d, 4.0 * b * h * s * d * itemsize


def k2_bound_s(b: int, h: int, s: int, d: int, itemsize: int = 2) -> float:
    flops, nbytes = k2_counts(b, h, s, d, itemsize)
    peak = peaks.BF16_FLOPS if itemsize == 2 else peaks.F32_FLOPS
    return peaks.bound_s(flops, nbytes, peak)


def k3_counts(in_map_cells: float, pixels: int, levels: int = 4,
              radius: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one K3 launch over ``pixels`` source pixels
    whose windows hold ``in_map_cells`` in-map cells over all levels (4 bytes
    each)."""
    n_out = levels * (2 * radius + 1) ** 2
    return 7.0 * n_out * pixels, 4.0 * in_map_cells + 8.0 * pixels + 4.0 * n_out * pixels


def k3_in_map_cells(pyramid_hw: Sequence[Tuple[int, int]], coords, radius: int = 4) -> float:
    """The in-map cells of every pixel's (2r+2)² window at each level, for
    B×2×h×w pixel coordinates ``coords`` (a torch tensor) into pyramid
    levels of the given sizes (level l at 2^-l of the coordinates)."""
    import torch
    side = 2 * radius + 2
    cells = 0.0
    for lvl, (hl, wl) in enumerate(pyramid_hw):
        spans = []
        for c, size in ((coords[:, 0], wl), (coords[:, 1], hl)):
            c = c.reshape(-1).double()
            if size == 1:
                spans.append(torch.ones_like(c))
                continue
            c = torch.clamp(c / 2 ** lvl, -(radius + 1.0), size + radius)
            lo = torch.floor(c) - radius
            spans.append(torch.clamp(torch.clamp(lo + side, max=float(size))
                                     - torch.clamp(lo, min=0), min=0))
        cells += float((spans[0] * spans[1]).sum())
    return cells


def conv_flops(c_in: int, c_out: int, k: int, h: int, w: int) -> float:
    """A stride-1 'same' conv's multiply-adds as operations."""
    return 2.0 * c_in * c_out * k * k * h * w


def delta_dino_frame_flops(channels: Sequence[int], h: int, w: int) -> Dict[str, float]:
    """DeltaDINO's four convs on one frame, forward, by layer."""
    out = {}
    for i in range(len(channels) - 1):
        out[f"delta_dino.conv{i} {channels[i]}->{channels[i + 1]} at {h}x{w}"] = conv_flops(
            channels[i], channels[i + 1], KERNEL_SIZE, h, w)
        if DOWNSAMPLE[i]:
            h, w = _half(h), _half(w)
    return out


def delta_dino_out_hw(h: int, w: int) -> Tuple[int, int]:
    for down in DOWNSAMPLE:
        if down:
            h, w = _half(h), _half(w)
    return h, w


def head_map_flops(hw: int) -> float:
    """The tracker head's two convs on one h'×w' correlation map."""
    return sum(conv_flops(HEAD_CHANNELS[i], HEAD_CHANNELS[i + 1], HEAD_KERNEL, 1, hw)
               for i in range(len(HEAD_CHANNELS) - 1))


def train_step_terms(train: dict, video_hw: Tuple[int, int], feat_hw: Tuple[int, int],
                     channels: Sequence[int], use_cyc: bool, use_cl_ref: bool) -> Dict[str, float]:
    """Model FLOPs of one train step, term by term (see the module notes).
    ``train`` holds TrainConfig's fields."""
    h, w = video_hw
    fh, fw = feat_hw
    hw = fh * fw
    c = channels[-1]
    frames = 2 * train["batch_n_frames"]  # the step's padded frame set
    terms = {}
    for name, f in delta_dino_frame_flops(channels, h, w).items():
        terms[f"{name}, {frames} frames, fwd+bwd"] = 3.0 * frames * f
    ch, cw = delta_dino_out_hw(h, w)
    terms["align to the ViT grid, fwd+bwd"] = 3.0 * (2.0 * fh * ch * frames * cw * c
                                                     + 2.0 * fw * cw * frames * fh * c)
    b = train["train_batch_size"]
    terms["flow: correlation, fwd+bwd"] = 3.0 * 2.0 * b * hw * c
    terms["flow: head, fwd+bwd"] = 3.0 * b * head_map_flops(hw)
    if use_cyc:
        pts = train["cyc_n_frames"] * train["cyc_batch_size_per_frame"]
        one = 2.0 * pts * hw * c + pts * head_map_flops(hw)
        terms["cycle: filter, two predictions, no grad"] = 2.0 * one
        terms["cycle: loss, both directions, fwd+bwd"] = 3.0 * 2.0 * one
    pairs, k = train["cl_n_frames"], train["cl_points_per_pair"]
    infonce = 2.0 * (2.0 * pairs * k * hw * c)  # s->t and t->s
    terms["dino best buddies: InfoNCE, fwd+bwd"] = 3.0 * infonce
    if use_cl_ref:
        terms["refined best buddies: mining affinity, no grad"] = 2.0 * pairs * hw * hw * c
        terms["refined best buddies: InfoNCE, fwd+bwd"] = 3.0 * infonce
    return terms


def train_step_flops(*args, **kwargs) -> float:
    return sum(train_step_terms(*args, **kwargs).values())
