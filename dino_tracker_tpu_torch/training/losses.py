"""Loss terms and fixed-shape sampling helpers (port of
dino_tracker_tpu/training/losses.py).

As in the JAX package, every candidate set carries a validity mask and
"skip" is a zero weight, so a step has no data-dependent shapes and no host
round trips. Behavior spec: reference dino_tracker.py:136-353.
"""

from __future__ import annotations

import torch

from ..utils.sampling import sample_masks_at_points

EPS = 1e-8


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0 / 32.0) -> torch.Tensor:
    """torch.nn.HuberLoss(reduction='none') semantics."""
    d = pred - target
    abs_d = d.abs()
    return torch.where(abs_d <= delta, 0.5 * d * d, delta * (abs_d - 0.5 * delta))


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(E), E ~ Exp(1), drawn from ``generator``."""
    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(e)


def masked_gumbel_topk(generator: torch.Generator, mask: torch.Tensor, k: int):
    """Uniformly sample up to ``k`` distinct indices where ``mask`` is true,
    along the last axis (leading axes are a batch).

    The JAX package's contract (losses.py:29-56): returns (indices [..., k],
    valid [..., k]); the selection is a SET, with indices ascending, invalid
    slots zero-filled and placed after the valid ones, and ``valid`` False
    beyond the masked population (or beyond the axis when it is shorter than
    ``k``). Gumbel scores from ``generator`` and ``torch.topk``; the JAX
    radix-select (ops/select.py) was a TPU workaround for ``lax.top_k``."""
    n = mask.shape[-1]
    scores = gumbel(mask.shape, generator, mask.device).masked_fill(~mask, -torch.inf)
    top = torch.topk(scores, min(k, n), dim=-1).indices
    valid = torch.gather(mask, -1, top)
    idx = torch.sort(torch.where(valid, top, n), dim=-1).values
    valid = idx < n
    idx = torch.where(valid, idx, 0)
    if k > n:
        pad = (*idx.shape[:-1], k - n)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return idx, valid


def sample_fg_mask_at_points(fg_masks_phw: torch.Tensor, coords_pk2: torch.Tensor,
                             resw: int, resh: int) -> torch.Tensor:
    """Foreground flags (P×K bool) of P masks at P×K pixel coords, mirroring
    the reference's ``filter_bb_foreground_pairs`` (models/utils.py:53-58)."""
    return sample_masks_at_points(fg_masks_phw, coords_pk2, resw, resh) > 0


def bb_pairs_contrastive_loss_nc(source_bb_f, target_bb_f, source_f_nc,
                                 target_f_nc, source_norms_n, target_norms_n,
                                 temp: float = 0.5,
                                 compute_dtype: torch.dtype = torch.float32):
    """Symmetric InfoNCE of best-buddy pairs against every position of the
    other frame (reference dino_tracker.py:332-344), over n×C frame slabs of
    a FrameView (values rounded to ``compute_dtype``, held in f32) and their
    norms. The buddy features are rounded to ``compute_dtype`` too and the
    products run in f32, as the JAX einsums with f32 accumulation. Leading
    axes are a batch of pairs. Returns (loss_s→t, loss_t→s), each [..., B]."""
    bb_corrs = (source_bb_f * target_bb_f).sum(-1)
    st = source_bb_f.to(compute_dtype).float() @ target_f_nc.transpose(-1, -2)
    ts = target_bb_f.to(compute_dtype).float() @ source_f_nc.transpose(-1, -2)
    sn = torch.linalg.vector_norm(source_bb_f, dim=-1)
    tn = torch.linalg.vector_norm(target_bb_f, dim=-1)
    st = st / torch.clamp(sn[..., :, None] * target_norms_n[..., None, :], min=EPS)
    ts = ts / torch.clamp(tn[..., :, None] * source_norms_n[..., None, :], min=EPS)
    bb_corrs = bb_corrs / torch.clamp(sn * tn, min=EPS)
    # -log(exp(pos/T) / Σ exp(row/T)) == logsumexp(row/T) - pos/T
    loss_st = torch.logsumexp(st / temp, dim=-1) - bb_corrs / temp
    loss_ts = torch.logsumexp(ts / temp, dim=-1) - bb_corrs / temp
    return loss_st, loss_ts


def emb_norm_regularization(frame_embeddings, raw_embeddings):
    """mean |‖refined‖/‖raw‖ − 1| over channels-last stacks (reference
    dino_tracker.py:136-140)."""
    rn = torch.linalg.vector_norm(frame_embeddings, dim=-1)
    dn = torch.linalg.vector_norm(raw_embeddings, dim=-1)
    return (rn / dn - 1.0).abs().mean()


def emb_angle_regularization(frame_embeddings, raw_embeddings):
    """mean |cos(refined, raw) − 1| over channels-last stacks (reference
    dino_tracker.py:142-146, models/utils.py:79-84)."""
    dot = (frame_embeddings * raw_embeddings).sum(-1)
    rn = torch.linalg.vector_norm(frame_embeddings, dim=-1)
    dn = torch.linalg.vector_norm(raw_embeddings, dim=-1)
    return (dot / (rn * dn) - 1.0).abs().mean()


def mutual_nn(affinity_nm: torch.Tensor):
    """Mutual-nearest-neighbour mask over [..., n, m] affinities: returns
    (source_is_bb [..., n] bool, target_idx [..., n] long), target_idx being
    each row's argmax (first maximum, as jnp.argmax). Reference
    dino_tracker.py:279-282."""
    src_max = torch.argmax(affinity_nm, dim=-1)  # ..., n
    tgt_max = torch.argmax(affinity_nm, dim=-2)  # ..., m
    n = affinity_nm.shape[-2]
    rows = torch.arange(n, device=affinity_nm.device)
    return rows == torch.gather(tgt_max, -1, src_max), src_max


def cosine_affinity(source_f, target_f, compute_dtype=torch.float32):
    """n×m cosine affinity with the reference's EPS clamp
    (dino_tracker.py:276-277); operands rounded to ``compute_dtype``, the
    product in f32."""
    aff = source_f.to(compute_dtype).float() @ target_f.to(compute_dtype).float().T
    sn = torch.linalg.vector_norm(source_f, dim=1)
    tn = torch.linalg.vector_norm(target_f, dim=1)
    return aff / torch.clamp(sn[:, None] * tn[None, :], min=EPS)
