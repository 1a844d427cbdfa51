"""Chained optical-flow trajectories (port of
``dino_tracker_tpu/preprocessing/trajectories.py:30-527``).

Behaviour of the reference's preprocessing/extract_trajectories.py: from
every start frame each eligible pixel spawns a trajectory that the forward
flow advances; it dies on a forward-backward cycle error at or above the
threshold, on leaving the frame, and (with the direct-flow filter) on
disagreeing with the direct start→f flow; pixels already covered by an
earlier start frame's trajectories do not spawn again ("look-behind").

All pixels of a start frame advance together on the device, one time step a
loop iteration from the start frame on (the JAX package's scan ran the
pre-start steps as identities). The look-behind occupancy is a T×H×W grid on
the host, updated once per start frame with the kept trajectories
(``utils/native_traj.py``). Spawn eligibility, per-pass occupancy and the
column order (per start frame, kept pixels in flat row-major order) are the
JAX package's, so the two packages' outputs compare element by element.

Direct flows come only through ``direct_flow_fn(start) -> (flows, masks)``
(``RaftFlowEngine.direct_flows``, or arrays in tests), rows relative to the
start frame, padded to t-1 rows or not. Not ported (they fuse XLA
dispatches or bound recompiles): ``_make_fused_start_program``,
``_make_fused_group_program``, ``_dual_start_program``, the ``decode=`` /
``start_group`` path and the power-of-two gather buckets.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.native_traj import occupancy_update
from ..utils.sampling import bilinear_sampler_pixel

DirectFlowFn = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def _grid(h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)  # h×w×2


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(dim=-1))


def _warp(flow_2hw: torch.Tensor, coords_hw2: torch.Tensor) -> torch.Tensor:
    """The flow sampled at pixel coords -> h×w×2."""
    return bilinear_sampler_pixel(flow_2hw[None], coords_hw2[None])[0].permute(1, 2, 0)


def compute_flow_masks(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """Per-frame backward cycle-consistency masks (reference
    extract_trajectories.py:30-95): flows (t-1)×2×h×w, i→i+1 and i+1→i ->
    (t, h, w) bool. Frame f > 0 is True where its pixel cycle-checks against
    frame f-1 and some pixel of frame f-1 warps onto it; frame 0 is all
    False."""
    tm1, _, h, w = flows_fwd.shape
    coords = _grid(h, w, flows_fwd.device)[None]  # 1×h×w×2
    coords1 = coords + flows_bwd.permute(0, 2, 3, 1)
    warped_fwd = bilinear_sampler_pixel(flows_fwd, coords1)
    coords2 = coords1 + warped_fwd.permute(0, 2, 3, 1)
    # the missing-forward-warp rule: some pixel of frame f-1 lands here
    tgt = torch.round(coords + flows_fwd.permute(0, 2, 3, 1)).to(torch.int32)
    xi, yi = tgt[..., 0], tgt[..., 1]
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    cell = (torch.arange(tm1, device=flows_fwd.device)[:, None, None] * (h * w)
            + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
    hit = torch.zeros(tm1 * h * w, dtype=torch.bool, device=flows_fwd.device)
    hit[cell[inb].long()] = True
    masks = (_norm(coords - coords2) < threshold) & hit.reshape(tm1, h, w)
    return torch.cat([torch.zeros((1, h, w), dtype=torch.bool,
                                  device=flows_fwd.device), masks])


def _step(flows_fwd, flows_bwd, idx: int, coords: torch.Tensor, threshold: float):
    """One time step i→i+1 for every pixel: (coords at i+1, cycle-and-bounds
    ok)."""
    h, w = coords.shape[:2]
    coords1 = coords + _warp(flows_fwd[idx], coords)
    coords2 = coords1 + _warp(flows_bwd[idx], coords1)
    upper = torch.tensor([w - 1.0, h - 1.0], device=coords.device)
    in_bounds = ((coords1 >= 0.0) & (coords1 <= upper)).all(dim=-1)
    return coords1, (_norm(coords - coords2) < threshold) & in_bounds


def _direct_ok(coords1, grid, dflows, dmasks, row: int, direct_threshold: float):
    """Pixels whose chained position agrees with the direct flow of row
    ``row`` (where its cycle mask holds)."""
    err_d = _norm(coords1 - (grid + dflows[row])) * (dmasks[row] > 0.2)
    return err_d < direct_threshold


def _chain_from_start(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                      start_mask: torch.Tensor, start: int,
                      dflows: Optional[torch.Tensor], dmasks: Optional[torch.Tensor],
                      threshold: float, direct_threshold: float) -> torch.Tensor:
    """One start frame's pass: the pixels of ``start_mask`` spawn at
    ``start``, the direct filter applies when ``dflows`` is given (row k is
    the flow start→start+1+k) -> t×h×w×2 f32 timeline, NaN before the start
    and where dead."""
    tm1, _, h, w = flows_fwd.shape
    grid = _grid(h, w, flows_fwd.device)
    timeline = torch.full((tm1 + 1, h, w, 2), float("nan"), device=flows_fwd.device)
    coords, alive = grid, start_mask
    timeline[start] = torch.where(alive[..., None], coords, float("nan"))
    for idx in range(start, tm1):
        coords, ok = _step(flows_fwd, flows_bwd, idx, coords, threshold)
        alive = alive & ok
        if dflows is not None:
            alive = alive & _direct_ok(coords, grid, dflows, dmasks, idx - start,
                                       direct_threshold)
        timeline[idx + 1] = torch.where(alive[..., None], coords, float("nan"))
    return timeline


def _chain_dual(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor, start: int,
                dflows: torch.Tensor, dmasks: torch.Tensor, threshold: float,
                direct_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both passes of one start frame, with and without the direct-flow
    filter, from one coordinate carry (a pixel's coordinates advance alike
    in both; only its aliveness differs). Every pixel spawns: eligibility
    and occupancy apply at harvest, which is exact because aliveness is
    monotone and independent of spawning. -> (filtered, unfiltered)
    t×h×w×2 timelines."""
    tm1, _, h, w = flows_fwd.shape
    grid = _grid(h, w, flows_fwd.device)
    tl_f = torch.full((tm1 + 1, h, w, 2), float("nan"), device=flows_fwd.device)
    tl_u = tl_f.clone()
    tl_f[start] = tl_u[start] = grid
    coords = grid
    alive_f = alive_u = torch.ones((h, w), dtype=torch.bool, device=flows_fwd.device)
    for idx in range(start, tm1):
        coords, ok = _step(flows_fwd, flows_bwd, idx, coords, threshold)
        alive_u = alive_u & ok
        alive_f = alive_f & ok & _direct_ok(coords, grid, dflows, dmasks, idx - start,
                                            direct_threshold)
        tl_f[idx + 1] = torch.where(alive_f[..., None], coords, float("nan"))
        tl_u[idx + 1] = torch.where(alive_u[..., None], coords, float("nan"))
    return tl_f, tl_u


def _keep_mask(timeline: torch.Tensor, min_len: int) -> torch.Tensor:
    """h×w bool: pixels whose trajectory lives ≥ min_len frames."""
    valid = ~torch.isnan(timeline).any(dim=-1)  # t×h×w
    return valid.sum(dim=0) >= min_len


def _gather_columns(timeline: torch.Tensor, idx_flat: np.ndarray) -> np.ndarray:
    """The t×K×2 columns of the kept pixels (flat indices), on the host."""
    t = timeline.shape[0]
    idx = torch.as_tensor(idx_flat, dtype=torch.long, device=timeline.device)
    return timeline.reshape(t, -1, 2)[:, idx].cpu().numpy()


def _padded_direct(direct_flow_fn: DirectFlowFn, start: int, tm1: int, h: int, w: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``direct_flow_fn(start)`` on ``device``, padded with zero rows to t-1."""
    dflows, dmasks = (torch.as_tensor(a, dtype=torch.float32, device=device)
                      for a in direct_flow_fn(start))
    n = dflows.shape[0]
    if n < tm1:
        dflows = torch.cat([dflows, dflows.new_zeros((tm1 - n, h, w, 2))])
        dmasks = torch.cat([dmasks, dmasks.new_zeros((tm1 - n, h, w))])
    return dflows, dmasks


def extract_trajectories(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
                         threshold: float = 1.5, min_trajectory_length: int = 2,
                         direct_flow_fn: Optional[DirectFlowFn] = None,
                         direct_flow_threshold: float = 2.5) -> np.ndarray:
    """One pass over all start frames -> N×t×2 f32 with NaNs (reference
    extract_trajectories.py:163-269). Flows (t-1)×2×h×w (tensors or arrays;
    the pass runs on their device). ``direct_flow_fn`` enables the direct-flow
    filter (reference :99-160, :222-255)."""
    flows_fwd, flows_bwd = torch.as_tensor(flows_fwd), torch.as_tensor(flows_bwd)
    tm1, _, h, w = flows_fwd.shape
    t, dev = tm1 + 1, flows_fwd.device
    masks = compute_flow_masks(flows_fwd, flows_bwd, threshold).cpu().numpy()
    occupied = np.zeros((t, h, w), bool)
    collected = []
    for start in range(t - (min_trajectory_length - 1)):
        start_mask = ~masks[start] | ~occupied[start]
        dflows = dmasks = None
        if direct_flow_fn is not None:
            dflows, dmasks = _padded_direct(direct_flow_fn, start, tm1, h, w, dev)
        timeline = _chain_from_start(flows_fwd, flows_bwd,
                                     torch.from_numpy(start_mask).to(dev), start,
                                     dflows, dmasks, threshold, direct_flow_threshold)
        ki = np.flatnonzero(_keep_mask(timeline, min_trajectory_length).cpu().numpy())
        if ki.size:
            trajs = _gather_columns(timeline, ki)  # t×K×2
            collected.append(np.transpose(trajs, (1, 0, 2)))
            occupancy_update(trajs, occupied, start)
    if not collected:
        return np.full((0, t, 2), np.nan, np.float32)
    return np.concatenate(collected, axis=0)


def extract_trajectories_dual(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor, *,
                              direct_flow_fn: DirectFlowFn,
                              threshold: float = 1.5, min_trajectory_length: int = 2,
                              direct_flow_threshold: float = 2.5,
                              timings: Optional[Dict[str, float]] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Both passes, with and without the direct-flow filter, in one sweep
    over the start frames -> (filtered N×t×2, unfiltered M×t×2). The
    reference runs the chaining script once per pass; here each start frame
    decodes its direct flows once and advances one coordinate carry for both
    passes. Each pass keeps its own look-behind occupancy, as the
    reference's two runs do; eligibility and occupancy apply when the kept
    columns are chosen.

    ``timings``, when given, gains the host seconds of the two phases of the
    sweep: "direct_sweep_and_chaining" (up to the fetch of the keep masks,
    which waits for the device) and "harvest" (choosing, fetching and
    recording the kept columns)."""
    flows_fwd, flows_bwd = torch.as_tensor(flows_fwd), torch.as_tensor(flows_bwd)
    tm1, _, h, w = flows_fwd.shape
    t, dev = tm1 + 1, flows_fwd.device
    min_len = min_trajectory_length
    masks = compute_flow_masks(flows_fwd, flows_bwd, threshold).cpu().numpy()
    occupied = {"f": np.zeros((t, h, w), bool), "u": np.zeros((t, h, w), bool)}
    collected = {"f": [], "u": []}
    sweep_s = harvest_s = 0.0
    for start in range(t - (min_len - 1)):
        t0 = time.perf_counter()
        dflows, dmasks = _padded_direct(direct_flow_fn, start, tm1, h, w, dev)
        tl = dict(zip("fu", _chain_dual(flows_fwd, flows_bwd, start, dflows, dmasks,
                                         threshold, direct_flow_threshold)))
        keep = {k: _keep_mask(v, min_len).cpu().numpy() for k, v in tl.items()}
        t1 = time.perf_counter()
        for key in "fu":
            elig = ~masks[start] | ~occupied[key][start]
            ki = np.flatnonzero(keep[key] & elig)
            if not ki.size:
                continue
            trajs = _gather_columns(tl[key], ki)  # t×K×2
            collected[key].append(np.transpose(trajs, (1, 0, 2)))
            occupancy_update(trajs, occupied[key], start)
        sweep_s += t1 - t0
        harvest_s += time.perf_counter() - t1
    if timings is not None:
        timings["direct_sweep_and_chaining"] = sweep_s
        timings["harvest"] = harvest_s

    def assemble(key):
        if not collected[key]:
            return np.full((0, t, 2), np.nan, np.float32)
        return np.concatenate(collected[key], axis=0)

    return assemble("f"), assemble("u")
