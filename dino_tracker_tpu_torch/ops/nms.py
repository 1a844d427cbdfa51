"""Top-2 greedy NMS for the best-buddy ambiguity score, plain PyTorch (port
of ``dino_tracker_tpu/ops/nms.py`` with the membership rule of
``ops/select.py topk_mask``).

The reference runs torchvision ``batched_nms`` over the top-400 candidate
boxes and keeps the two highest surviving peaks
(preprocessing_dino_bb/compute_dino_bb_nms.py:12-43). For boxes of one size,
greedy NMS's first two survivors are the global argmax and the best
top-k candidate whose IoU with it is at most the threshold, so only top-k
*membership* is needed, never the sorted list.

Membership follows ``lax.top_k``'s tie rule, which the JAX package keeps:
everything strictly above the k-th value is in, and ties at the k-th value
fill the remaining slots lowest index first. Values compare on a monotone
integer key of their f32 bits (JAX ``select.py _f32_to_ordered_u32``), which
orders -0.0 below +0.0 where a float compare ties them. The k-th key comes
from ``torch.topk``'s values; its indices are never used, because on CUDA it
promises no order among ties.
"""

from __future__ import annotations

import torch


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone map f32 -> int32: a >= b (with -0.0 < +0.0) iff key(a) >=
    key(b). Non-negative floats keep their bits; negative ones flip their
    magnitude bits. NaNs are not handled (callers mask with -inf)."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest along the last axis, ties at the k-th
    value broken by lower index (JAX ``ops/select.py:63-74``). Marks all n
    when n <= k."""
    if k >= scores.shape[-1]:
        return torch.ones_like(scores, dtype=torch.bool)
    keys = _ordered_key(scores)
    kth = torch.topk(keys, k, dim=-1).values[..., -1:]
    gt = keys > kth
    eq = keys == kth
    quota = k - gt.sum(-1, keepdim=True)
    return gt | (eq & (torch.cumsum(eq, dim=-1) <= quota))


def same_size_box_iou(centers_a: torch.Tensor, centers_b: torch.Tensor,
                      half_size: float) -> torch.Tensor:
    """IoU between axis-aligned boxes of side 2·half_size centered at
    a[..., 2] and b[..., 2]."""
    d = (centers_a - centers_b).abs()
    side = 2.0 * half_size
    inter = (side - d[..., 0]).clamp(min=0.0) * (side - d[..., 1]).clamp(min=0.0)
    union = 2.0 * side * side - inter
    return inter / union


def nms_top2_peaks(scores_bn: torch.Tensor, coords_n2: torch.Tensor,
                   topk: int = 400, box_size: float = 30.0,
                   iou_thresh: float = 0.2):
    """For each row of B×N similarity maps over the N×2 pixel centers:
    (peaks B×2, r B), the two greedy-NMS peaks and r = peak2 / peak1. peak2
    is 0 where no top-k candidate clears the IoU threshold."""
    in_topk = topk_mask(scores_bn, min(topk, scores_bn.shape[1]))
    peak1, arg1 = scores_bn.max(dim=1)
    iou = same_size_box_iou(coords_n2[None], coords_n2[arg1][:, None], box_size)
    eligible = in_topk & (iou <= iou_thresh)
    peak2 = torch.where(eligible, scores_bn, float("-inf")).amax(dim=1)
    peak2 = torch.where(peak2.isfinite(), peak2, 0.0)
    return torch.stack([peak1, peak2], dim=1), peak2 / peak1
