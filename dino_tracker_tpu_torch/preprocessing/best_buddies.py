"""Best-buddy mining of the port: mutual-NN sweep, optical-flow filter, NMS
ambiguity (pipeline stage 5; port of
``dino_tracker_tpu/preprocessing/best_buddies.py``).

Behaviour spec: the reference's preprocessing_dino_bb/ —
  1. ``extract_dino_best_buddies.py``: for every frame pair, cosine affinity
     between all patch features and the mutual-argmax pairs;
  2. ``of_filter_dino_best_buddies.py``: keep a pair only where the nearest
     trajectories are *invalid* at the other frame (supervision where flow
     failed);
  3. ``compute_dino_bb_nms.py``: each buddy's similarity map → top-400 →
     box NMS → ambiguity r = 2nd / 1st peak, symmetrised over directions.

As in the JAX package, the sweep runs over unordered pairs (s < u): one
n×n affinity serves both directions, and the reverse direction's buddy list
is the forward one mirrored slot for slot. Pairs run ``_PAIR_BATCH`` at a
time as one batched f32 GEMM with TF32 off (a mutual argmax flips under
TF32), with the optical-flow filter fused before any capacity cap. Buddies
are compacted on the device. Everything here is plain PyTorch: the JAX
stage calls no Pallas kernel.

With a mesh (JAX ``:136-348``, ``:495-627``) each rank runs its share of the
sweep's pair batches, of the closest grids' frames and of the ambiguity's
slabs, each whole; the raw outputs are gathered on every rank before the
compaction (the adaptive cap needs the largest count over all pairs) and
the ambiguity's r in row order before the scatter, so the telemetry is the
global one on every rank.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..models.nn import exact_f32
from ..ops.nms import nms_top2_peaks, topk_mask
from ..parallel import mesh as mesh_lib
from ..structures import BBData
from ..utils.coords import bb_meshgrid
from ..utils.profiling import stage_timer

logger = logging.getLogger(__name__)

# the stage's span (``utils/profiling.py``); each phase below is a span under
# it that ends in a device sync
SPAN = "preprocess/best_buddies"

# pairs a sweep step, within a budget for their P×n×n f32 affinity
_PAIR_BATCH = 8
_AFFINITY_BUDGET_BYTES = 2 << 30


def _grid_hw(h: int, w: int, stride: int, patch_size: int):
    """(rows, columns) of ``bb_meshgrid``."""
    half = patch_size // 2
    return len(range(half, h, stride)), len(range(half, w, stride))


def _check_grid(features_tchw: torch.Tensor, h: int, w: int, stride: int,
                patch_size: int):
    """The best-buddy grid must be the feature grid: token i sits at
    ``bb_meshgrid``'s point i. At other sizes the JAX stage mislabels buddies
    or fails later; this raises."""
    grid_hw = _grid_hw(h, w, stride, patch_size)
    feat_hw = tuple(features_tchw.shape[2:])
    if grid_hw != feat_hw:
        raise ValueError(
            f"the best-buddy grid of a {h}x{w} frame at stride {stride} is "
            f"{grid_hw[0]}x{grid_hw[1]} points but the features have "
            f"{feat_hw[0]}x{feat_hw[1]} tokens: use a frame whose height and "
            f"width minus {patch_size} are multiples of {stride}")


def _normalized_tokens(features_tchw: torch.Tensor) -> torch.Tensor:
    """T×C×h×w -> T×n×C f32 rows of unit norm (norm clipped at 1e-8)."""
    flat = features_tchw.float().flatten(2).transpose(1, 2).contiguous()
    return flat.div_(torch.linalg.vector_norm(flat, dim=2, keepdim=True).clamp_(min=1e-8))


def _mutual_nn_core(sn: torch.Tensor, tn: torch.Tensor, cap: int,
                    keep_fn=None):
    """P unordered pairs at once (JAX ``_mutual_nn_core``, ``:59-125``):
    ``sn``, ``tn`` P×n×C unit rows of frames s and u.

    ``keep_fn(src_max)`` -> P×n bool is the fused optical-flow filter,
    applied before the cap. With ``cap >= n`` returns the raw per-token
    (src_max, cos, is_bb), each P×n. Otherwise returns (src_tok, tgt_tok,
    cos, valid), each P×cap, and the true pre-cap count P: the strongest-
    cosine buddies, compacted in token order; an empty slot holds token 0,
    its argmax and cos 0 (JAX ``compact_mask``)."""
    with exact_f32(sn):
        aff = torch.bmm(sn, tn.transpose(1, 2))  # P×n×n
    n = aff.shape[1]
    src_max = aff.argmax(dim=2)
    tgt_max = aff.argmax(dim=1)
    is_bb = tgt_max.gather(1, src_max) == torch.arange(n, device=aff.device)
    cos = aff.gather(2, src_max[..., None])[..., 0]
    del aff
    if keep_fn is not None:
        is_bb &= keep_fn(src_max)
    if cap >= n:
        return src_max, cos, is_bb
    mask = topk_mask(torch.where(is_bb, cos, float("-inf")), cap) & is_bb
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :cap]
    valid = torch.arange(cap, device=mask.device) < mask.sum(1, keepdim=True)
    src_tok = torch.where(valid, order, 0)
    return (src_tok, src_max.gather(1, src_tok),
            torch.where(valid, cos.gather(1, src_tok), 0.0), valid, is_bb.sum(1))


def extract_best_buddies(features_tchw: torch.Tensor, h: int, w: int,
                         stride: int = 7, patch_size: int = 14,
                         cap: Optional[int] = None,
                         unfiltered_trajectories=None,
                         telemetry: Optional[dict] = None,
                         mesh: Optional[mesh_lib.Mesh] = None) -> BBData:
    """Mutual-NN sweep over every frame pair -> BBData on the features'
    device (JAX ``extract_best_buddies``, ``:136-348``).

    ``cap=None`` is adaptive: the sweep keeps every mutual pair, then trims
    the buddy axis to min(n, the largest pair's count rounded up to 128, at
    least 128). An explicit ``cap >= n`` keeps every pair at that capacity;
    ``cap < n`` keeps each pair's ``cap`` strongest-cosine buddies. Empty
    slots hold zeros in the first two modes and token 0's coordinates in the
    third, as the JAX package's. With ``unfiltered_trajectories`` (N×T×2)
    the optical-flow filter runs inside the sweep, before the cap. Pairs
    (s < u) run ``_PAIR_BATCH`` at a time within ``_AFFINITY_BUDGET_BYTES``.

    ``telemetry`` (a dict, filled in place) gets the capacity-cap stats —
    cap, adaptive, total_pairs, truncated_pairs, truncated_frac, max_count,
    mean_count — and ``phases``, this rank's seconds of closest_grids_s,
    sweep_s (its gather included) and compaction_s. With ``mesh`` every
    rank returns the whole BBData."""
    _check_grid(features_tchw, h, w, stride, patch_size)
    t = features_tchw.shape[0]
    dev = features_tchw.device
    phases = {}
    with stage_timer(f"{SPAN}/closest_grids", fence=dev) as span:
        grid = bb_meshgrid(h, w, stride, patch_size, device=dev)
        fn = _normalized_tokens(features_tchw)
        n = fn.shape[1]
        adaptive = cap is None
        raw = adaptive or cap >= n
        core_cap = n if raw else cap

        keep_fn = None
        if unfiltered_trajectories is not None:
            trajs = torch.as_tensor(unfiltered_trajectories, device=dev)
            closest = closest_trajectory_grids(trajs, grid, mesh=mesh)  # T×n
            invalid = trajs.isnan().any(-1)  # N×T
    phases["closest_grids_s"] = span.seconds

    with stage_timer(f"{SPAN}/sweep", fence=dev) as span:
        pairs = torch.triu_indices(t, t, 1, device=dev)  # (s, u), s < u, row-major
        bsz = min(_PAIR_BATCH, max(1, _AFFINITY_BUDGET_BYTES // (n * n * 4)))
        starts = range(0, pairs.shape[1], bsz)
        mine, rows = mesh_lib.split_batches([min(bsz, pairs.shape[1] - b0) for b0 in starts],
                                            mesh)
        logger.info("best-buddy sweep: %d frame pairs, %d a batch, n=%d tokens; %d of %d "
                    "batches here", pairs.shape[1], bsz, n, len(mine), len(starts))
        outs = []
        for b0 in (starts[i] for i in mine):
            s_idx, u_idx = pairs[:, b0:b0 + bsz]
            if unfiltered_trajectories is not None:
                def keep_fn(src_max, s_idx=s_idx, u_idx=u_idx):
                    # the source token's nearest trajectory must be invalid at
                    # frame u, and its buddy's at frame s (token = grid index)
                    src_traj = closest[s_idx]
                    tgt_traj = closest[u_idx].gather(1, src_max)
                    return invalid[src_traj, u_idx[:, None]] & invalid[tgt_traj, s_idx[:, None]]
            outs.append(_mutual_nn_core(fn[s_idx], fn[u_idx], core_cap, keep_fn))
        if pairs.shape[1]:
            outs = mesh_lib.gather_batches(outs, rows, mesh, "bb_sweep", 3 if raw else 5)
        else:  # one frame has no pair: an empty BBData, as the JAX stage returns
            empty = lambda width, dtype=torch.int64: torch.zeros((0, width), dtype=dtype,
                                                                 device=dev)
            outs = ((empty(n), empty(n, torch.float32), empty(n, torch.bool)) if raw else
                    (empty(cap), empty(cap), empty(cap, torch.float32), empty(cap, torch.bool),
                     torch.zeros(0, dtype=torch.int64, device=dev)))
    phases["sweep_s"] = span.seconds

    with stage_timer(f"{SPAN}/compaction", fence=dev) as span:
        if raw:
            src_max, cos_pt, is_bb = outs
            counts = is_bb.sum(1)
            maxc = int(counts.max()) if counts.numel() else 0
            cap = min(n, max(128, -(-maxc // 128) * 128)) if adaptive else cap
            k = min(cap, n)
            order = torch.argsort((~is_bb).to(torch.int8), dim=1, stable=True)[:, :k]
            valid_p = torch.arange(k, device=dev) < counts[:, None]
            src_xy = torch.where(valid_p[..., None], grid[order], 0.0)
            tgt_xy = torch.where(valid_p[..., None], grid[src_max.gather(1, order)], 0.0)
            cos_p = torch.where(valid_p, cos_pt.gather(1, order), 0.0)
        else:
            src_tok, tgt_tok, cos_p, valid_p, counts = outs
            src_xy, tgt_xy = grid[src_tok], grid[tgt_tok]
        k = valid_p.shape[1]
        s_idx, u_idx = pairs
        src_c = torch.zeros((t, t, cap, 2), device=dev)
        tgt_c = torch.zeros((t, t, cap, 2), device=dev)
        cos = torch.zeros((t, t, cap), device=dev)
        valid = torch.zeros((t, t, cap), dtype=torch.bool, device=dev)
        # the reverse direction is the forward list mirrored (mutual pairs are
        # symmetric); diagonal pairs stay empty
        for a, b, sc, tc in ((s_idx, u_idx, src_xy, tgt_xy), (u_idx, s_idx, tgt_xy, src_xy)):
            src_c[a, b, :k] = sc
            tgt_c[a, b, :k] = tc
            cos[a, b, :k] = cos_p
            valid[a, b, :k] = valid_p
        counts = counts.cpu().numpy()
    phases["compaction_s"] = span.seconds

    stats = {
        "phases": phases,
        "cap": int(cap),
        "adaptive": bool(adaptive),
        "total_pairs": int(counts.size),
        "truncated_pairs": int(np.sum(counts > cap)),
        "truncated_frac": float(np.mean(counts > cap)) if counts.size else 0.0,
        "max_count": int(counts.max()) if counts.size else 0,
        "mean_count": float(counts.mean()) if counts.size else 0.0,
    }
    if telemetry is not None:
        telemetry.update(stats)
    log = logger.warning if stats["truncated_pairs"] else logger.info
    log("best-buddy capacity cap=%d%s: %d/%d frame pairs truncated "
        "(max mutual-NN count %d, mean %.1f)", cap,
        " (adaptive)" if adaptive else "", stats["truncated_pairs"],
        stats["total_pairs"], stats["max_count"], stats["mean_count"])
    return BBData(src_c, tgt_c, cos, torch.ones((t, t, cap), device=dev), valid)


# ---------------------------------------------------------------------------
# optical-flow filter
# ---------------------------------------------------------------------------

def closest_trajectory_grids(trajectories_nt2, grid_n2: torch.Tensor,
                             chunk: int = 8192,
                             mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """For each frame f and point g of a row-major lattice grid (as
    ``bb_meshgrid`` makes it): the index of the nearest trajectory at frame
    f, on the grid's device. Returns T×n int64 (JAX
    ``closest_trajectory_grids``, ``:355-418``).

    NaN coordinates count as 1e12 (infinitely far). Distances are
    sqrt(dx·dx + dy·dy) in f32, as the JAX package computes them, and equal
    distances go to the first index. The lattice makes dx² a per-column and
    dy² a per-row table, so each chunk costs one broadcast add, a sqrt and a
    min over n × chunk. With ``mesh`` each rank takes its share of the
    frames and every rank gets all of them."""
    dev = grid_n2.device
    xs, ys = grid_n2[:, 0].unique(), grid_n2[:, 1].unique()
    lattice = torch.stack(torch.meshgrid(ys, xs, indexing="ij")[::-1], -1).reshape(-1, 2)
    if lattice.shape != grid_n2.shape or not torch.equal(lattice, grid_n2):
        raise ValueError("closest_trajectory_grids needs a row-major lattice grid")
    coords = torch.nan_to_num(torch.as_tensor(trajectories_nt2, device=dev).float(),
                              nan=1e12).transpose(0, 1)  # T×N×2
    t, n_traj = coords.shape[:2]
    n = grid_n2.shape[0]
    mine, rows = mesh_lib.split_batches([1] * t, mesh)
    out = []
    for f in mine:
        best_d = torch.full((n,), float("inf"), device=dev)
        best_i = torch.zeros(n, dtype=torch.int64, device=dev)
        for off in range(0, n_traj, chunk):
            cc = coords[f, off:off + chunk]
            dx = xs[:, None] - cc[None, :, 0]
            dy = ys[:, None] - cc[None, :, 1]
            d = torch.add(dy.mul_(dy)[:, None], dx.mul_(dx)[None]).view(n, -1).sqrt_()
            cd, ci = d.min(dim=1)
            # an earlier chunk keeps an equal distance: the first index wins
            best_i = torch.where(cd < best_d, ci + off, best_i)
            best_d = torch.minimum(cd, best_d)
        out.append((best_i[None],))
    return mesh_lib.gather_batches(out, rows, mesh, "bb_closest_grids")[0]


def of_filter_best_buddies(bb: BBData, trajectories_nt2, h: int, w: int,
                           stride: int = 7, patch_size: int = 14) -> BBData:
    """Keep buddies only where flow supervision is absent: the trajectory
    nearest the source point must be invalid at the target frame and vice
    versa; diagonal slots keep their validity (JAX
    ``of_filter_best_buddies``, ``:421-455``). Runs on the device of
    ``bb.source_coords``."""
    src = torch.as_tensor(bb.source_coords)
    dev = src.device
    tgt = torch.as_tensor(bb.target_coords, device=dev)
    t = bb.num_frames
    half = patch_size // 2
    gh, gw = _grid_hw(h, w, stride, patch_size)
    trajs = torch.as_tensor(trajectories_nt2, device=dev)
    closest = closest_trajectory_grids(
        trajs, bb_meshgrid(h, w, stride, patch_size, device=dev)).view(t, gh, gw)
    invalid = trajs.isnan().any(-1)  # N×T

    def cells(xy):  # pixel coords -> clipped feature-grid (row, column)
        idx = torch.div(xy - half, stride, rounding_mode="floor").long()
        return idx[..., 1].clamp(0, gh - 1), idx[..., 0].clamp(0, gw - 1)

    s_ax = torch.arange(t, device=dev)[:, None, None]  # source frame
    u_ax = torch.arange(t, device=dev)[None, :, None]  # target frame
    s_traj = closest[(s_ax,) + cells(src)]
    t_traj = closest[(u_ax,) + cells(tgt)]
    keep = invalid[s_traj, u_ax] & invalid[t_traj, s_ax]
    return bb._replace(valid=torch.as_tensor(bb.valid, device=dev) & (keep | (s_ax == u_ax)))


# ---------------------------------------------------------------------------
# NMS ambiguity
# ---------------------------------------------------------------------------

def compute_bb_ambiguity(bb: BBData, features_tchw: torch.Tensor, h: int, w: int,
                         stride: int = 7, box_size: float = 30.0,
                         iou_thresh: float = 0.2, topk: int = 400,
                         patch_size: int = 14, rows_per_slab: int = 8192,
                         telemetry: Optional[dict] = None,
                         mesh: Optional[mesh_lib.Mesh] = None) -> BBData:
    """Ambiguity r of every valid buddy, symmetrised as max(r_fwd, r_bwd)
    over the two directions of a pair (JAX ``compute_bb_ambiguity``,
    ``:495-627``), on the features' device.

    Only valid rows are computed. They group by target frame: the rows of
    direction s→u gather frame s's unit features at their buddy tokens and
    take one f32 product (TF32 off) with frame u per slab of at most
    ``rows_per_slab`` rows, then ``nms_top2_peaks``. r of an invalid slot
    stays 1.0. ``telemetry`` gets ``phases`` (group_rows_s, slabs_s,
    scatter_s; this rank's, the gather in scatter_s), ``m_max`` (the most rows
    of one target frame) and ``rows_total``. With ``mesh`` each rank runs its
    share of the slabs and every rank returns the whole BBData."""
    _check_grid(features_tchw, h, w, stride, patch_size)
    t = features_tchw.shape[0]
    dev = features_tchw.device
    phases = {}
    with stage_timer(f"{SPAN}/ambiguity/group_rows", fence=dev) as span:
        half = patch_size // 2
        gw = 1 + (w - patch_size) // stride
        grid = bb_meshgrid(h, w, stride, patch_size, device=dev)
        fn = _normalized_tokens(features_tchw)
        n = fn.shape[1]
        src = torch.as_tensor(bb.source_coords, device=dev)
        valid = torch.as_tensor(bb.valid, device=dev)
        cap = valid.shape[2]
        cell = torch.div(src - half, stride, rounding_mode="floor").long()
        tok = (cell[..., 1] * gw + cell[..., 0]).clamp(0, n - 1)  # T×T×cap

        off_diag = ~torch.eye(t, dtype=torch.bool, device=dev)[..., None]
        rows = torch.nonzero(valid & off_diag)  # R×3 (s, u, slot), s-major
        rows = rows[torch.argsort(rows[:, 1], stable=True)]  # grouped by target u
        per_frame = torch.bincount(rows[:, 1], minlength=t).cpu().numpy()
        r_out = torch.ones((t, t, cap), device=dev)
    phases["group_rows_s"] = span.seconds
    with stage_timer(f"{SPAN}/ambiguity/slabs", fence=dev) as span:
        ends = np.cumsum(per_frame)
        slabs = [(u, a, min(a + rows_per_slab, ends[u]))
                 for u in np.nonzero(per_frame)[0].tolist()
                 for a in range(ends[u] - per_frame[u], ends[u], rows_per_slab)]
        mine, counts = mesh_lib.split_batches([b - a for _, a, b in slabs], mesh)
        r_slabs = []
        for u, a, b in (slabs[i] for i in mine):
            s, _, slot = rows[a:b].unbind(1)
            sfeat = fn[s, tok[s, u, slot]]  # slab×C
            with exact_f32(sfeat):
                sim = sfeat @ fn[u].T
            r_slabs.append((nms_top2_peaks(sim, grid, topk=topk, box_size=box_size,
                                           iou_thresh=iou_thresh)[1],))
    phases["slabs_s"] = span.seconds
    with stage_timer(f"{SPAN}/ambiguity/scatter", fence=dev) as span:
        if slabs:
            r_out[tuple(rows.unbind(1))] = mesh_lib.gather_batches(
                r_slabs, counts, mesh, "bb_ambiguity")[0]
        # the reverse list mirrors the forward one: slot k of (s, u) pairs with
        # slot k of (u, s)
        r_sym = torch.maximum(r_out, r_out.transpose(0, 1))
    phases["scatter_s"] = span.seconds
    if telemetry is not None:
        telemetry.update({"phases": phases,
                          "m_max": int(per_frame.max()) if t else 0,
                          "rows_total": int(rows.shape[0])})
    return bb._replace(r=r_sym)
