"""Best-buddy contrastive losses (port of
dino_tracker_tpu/training/contrastive.py; reference dino_tracker.py:159-330).

Two InfoNCE terms over the refined frame set of a step:
  * ``dino_bb``: supervision pairs precomputed from raw DINO features
    (``BBData``), weighted by the NMS-ambiguity σ(a(1−r)+b) and 2·cos³;
  * ``refined_bb``: buddies mined on the refined features every step
    (mutual-NN over an n×n cosine affinity, under ``no_grad``), weighted by
    2·aff³.

The pair axis is a batch dimension (P×…), as the JAX package vmaps it. Each
loss gathers all P·k buddy features with gradient in one go, so the backward
is one row scatter-add into the refined stack. ``pair_sel`` overrides the
random frame-pair draw (tests hold the deterministic loss math against the
JAX package at the same pairs).
"""

from __future__ import annotations

import torch

from ..config import TrackerConfig
from ..models import tracker
from ..structures import BBData
from ..utils import coords as coord_utils
from . import losses

EPS = 1e-8


def _sample_embeddings_at(frame_embeddings, coords_xy, frame_set_idx,
                          cfg: TrackerConfig):
    """Trilinear-sample N×h×w×C refined embeddings at pixel coords on
    frame-set indices -> S×C."""
    pts = torch.cat([coords_xy, frame_set_idx[:, None].to(coords_xy.dtype)], 1)
    pts = coord_utils.normalize_points_for_sampling(
        pts, cfg.video_h, cfg.video_w, cfg.dino_patch_size, cfg.stride)
    return tracker.sample_embeddings(frame_embeddings, pts)


def _pair_frames(generator, set_size: int, n_pairs: int, device, pair_sel,
                 distinct: bool):
    """(src_sel, tgt_sel) P indices into the frame set: ``pair_sel`` when
    given, else drawn from ``generator``. ``distinct``: target != source (the
    reference redraws until no collision; an offset in [1, set) does it in
    one draw)."""
    if pair_sel is not None:
        return (torch.as_tensor(pair_sel[0], device=device).long(),
                torch.as_tensor(pair_sel[1], device=device).long())
    src = torch.randint(0, set_size, (n_pairs,), generator=generator,
                        device=device)
    if distinct:
        off = torch.randint(1, set_size, (n_pairs,), generator=generator,
                            device=device)
        return src, (src + off) % set_size
    return src, torch.randint(0, set_size, (n_pairs,), generator=generator,
                              device=device)


def _fg_bg_topk(generator, candidates, fg, n_fg: int, n_bg: int):
    """Up to n_fg foreground and n_bg background candidates per pair ->
    (indices P×k, valid P×k)."""
    idx_fg, v_fg = losses.masked_gumbel_topk(generator, candidates & fg, n_fg)
    idx_bg, v_bg = losses.masked_gumbel_topk(generator, candidates & ~fg, n_bg)
    return torch.cat([idx_fg, idx_bg], 1), torch.cat([v_fg, v_bg], 1)


def dino_bb_contrastive_loss(generator, frame_embeddings, frames_set_t,
                             bb: BBData, fg_masks_thw, cfg: TrackerConfig,
                             n_pairs: int, points_per_pair: int,
                             fg_points_ratio: float, temp: float,
                             cl_div: float, sig_a: float, sig_b: float,
                             view=None, pair_sel=None) -> torch.Tensor:
    """Reference dino_tracker.py:159-243 over the channels-last N×h×w×C
    refined frame set. Returns a scalar loss."""
    set_size = frames_set_t.shape[0]
    n_fg = int(points_per_pair * fg_points_ratio)
    n_bg = points_per_pair - n_fg
    cd = cfg.torch_compute_dtype
    if view is None:
        view = tracker.make_frame_view(frame_embeddings, cd)
    src_sel, tgt_sel = _pair_frames(generator, set_size, n_pairs,
                                    frame_embeddings.device, pair_sel,
                                    distinct=True)
    n_pairs = src_sel.shape[0]

    # per-pair point selection and loss weights: no gradient paths
    sf, tf = frames_set_t[src_sel], frames_set_t[tgt_sel]
    src_xy, tgt_xy = bb.source_coords[sf, tf], bb.target_coords[sf, tf]  # P×Nmax×2
    fg = losses.sample_fg_mask_at_points(fg_masks_thw[sf], src_xy,
                                         cfg.video_w, cfg.video_h)
    sel, sel_valid = _fg_bg_topk(generator, bb.valid[sf, tf], fg, n_fg, n_bg)
    r = torch.gather(bb.r[sf, tf], 1, sel)
    cos = torch.gather(bb.cos_sims[sf, tf], 1, sel)
    wmask = (torch.sigmoid(sig_a * (1.0 - r) + sig_b)
             * torch.clamp(2.0 * cos ** 3, min=0.0) * sel_valid)
    sxy = torch.gather(src_xy, 1, sel[..., None].expand(-1, -1, 2))
    txy = torch.gather(tgt_xy, 1, sel[..., None].expand(-1, -1, 2))

    kk = sel.shape[1]
    src_f = _sample_embeddings_at(frame_embeddings, sxy.reshape(-1, 2),
                                  src_sel.repeat_interleave(kk), cfg)
    tgt_f = _sample_embeddings_at(frame_embeddings, txy.reshape(-1, 2),
                                  tgt_sel.repeat_interleave(kk), cfg)
    c = src_f.shape[-1]
    cl1, cl2 = losses.bb_pairs_contrastive_loss_nc(
        src_f.reshape(n_pairs, kk, c), tgt_f.reshape(n_pairs, kk, c),
        view.flat_cd[src_sel], view.flat_cd[tgt_sel],
        view.norms[src_sel], view.norms[tgt_sel], temp, cd)
    # reference: (Σcl1·w + Σcl2·w)/cl_div averaged over the two directions
    return ((cl1 + cl2) * wmask).sum() / cl_div / 2.0


def refined_bb_contrastive_loss(generator, frame_embeddings, frames_set_t,
                                fg_masks_thw, cfg: TrackerConfig,
                                n_pairs: int, points_per_pair: int,
                                fg_points_ratio: float, temp: float,
                                cl_div: float, view=None,
                                pair_sel=None) -> torch.Tensor:
    """Reference dino_tracker.py:245-330: buddies mined on the fly from the
    refined N×h×w×C frame set. Returns a scalar loss."""
    set_size = frames_set_t.shape[0]
    s, hp, wp, c = frame_embeddings.shape
    n = hp * wp
    n_fg = int(points_per_pair * fg_points_ratio)
    n_bg = points_per_pair - n_fg
    cd = cfg.torch_compute_dtype
    if view is None:
        view = tracker.make_frame_view(frame_embeddings, cd)
    dev = frame_embeddings.device
    src_sel, tgt_sel = _pair_frames(generator, set_size, n_pairs, dev,
                                    pair_sel, distinct=False)
    n_pairs = src_sel.shape[0]

    with torch.no_grad():
        # Mining on unit slabs: the compute-dtype slab divided by its norms
        # (rounded to the compute dtype as the JAX division is), so the
        # product IS the cosine affinity. Row/column scaling by positive norms
        # keeps both argmaxes, so the mutual-NN set is the reference's; the
        # exact EPS-clamped weights are recomputed below from the selected
        # columns only.
        norms = view.norms.detach()
        unit = (view.flat_cd.detach().to(cd)
                / torch.clamp(norms, min=EPS).to(cd)[..., None]).float()
        aff = unit[src_sel] @ unit[tgt_sel].transpose(1, 2)  # P×n×n
        src_is_bb, tgt_of_src = losses.mutual_nn(aff)
        del aff
        feat_grid = coord_utils.vit_feature_coords(
            cfg.video_h, cfg.video_w, cfg.stride, cfg.dino_patch_size,
            device=dev)
        fg = losses.sample_fg_mask_at_points(
            fg_masks_thw[frames_set_t[src_sel]],
            feat_grid.expand(n_pairs, -1, -1), cfg.video_w, cfg.video_h)
        sel_src, sel_valid = _fg_bg_topk(generator, src_is_bb, fg, n_fg, n_bg)
        sel_tgt = torch.gather(tgt_of_src, 1, sel_src)

    # ONE with-grad gather of all P·k rows of the (s·n)×C view: its backward
    # is one row scatter-add into the refined stack
    flat_snc = frame_embeddings.reshape(s * n, c)
    kk = sel_src.shape[1]
    src_f = flat_snc[(src_sel[:, None] * n + sel_src).reshape(-1)].reshape(
        n_pairs, kk, c)
    tgt_f = flat_snc[(tgt_sel[:, None] * n + sel_tgt).reshape(-1)].reshape(
        n_pairs, kk, c)
    cl1, cl2 = losses.bb_pairs_contrastive_loss_nc(
        src_f, tgt_f, view.flat_cd[src_sel], view.flat_cd[tgt_sel],
        view.norms[src_sel], view.norms[tgt_sel], temp, cd)
    # selected-pair cosines with the reference's EPS-clamped formula, in f32
    # from the raw rows (the affinity above only chose the set)
    with torch.no_grad():
        sel_cos = (src_f * tgt_f).sum(-1) / torch.clamp(
            torch.gather(norms[src_sel], 1, sel_src)
            * torch.gather(norms[tgt_sel], 1, sel_tgt), min=EPS)
        w_cos = torch.clamp(2.0 * sel_cos ** 3, min=0.0) * sel_valid
    return ((cl1 + cl2) * w_cos).sum() / (2.0 * cl_div)
