"""Pipeline stage 5 of the port — the best-buddy sweep, the optical-flow
filter, the NMS ambiguity and the BB artifact — held against the JAX
package's functions on the CPU.

Inputs are made with numpy from seeds. Tolerances: mutual-NN sets, validity,
coordinates (the fill of empty slots included), closest-trajectory indices
and the filter equal element for element; cos within 1e-5 of the largest
|cos|; r within 1e-6. The fixtures keep every argmax, top-k boundary and
nearest distance apart by far more than the two packages' f32 rounding
differences (~1e-7), so equality is deterministic; ties that are exact in
both (identity features, integer coordinates, ±0.0) pin the tie rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tracker_tpu import structures as jstructures
from dino_tracker_tpu.ops import nms as jnms
from dino_tracker_tpu.ops import select as jselect
from dino_tracker_tpu.preprocessing import best_buddies as jbb
from dino_tracker_tpu.utils import coords as jcoords
from dino_tracker_tpu_torch import structures
from dino_tracker_tpu_torch.ops import nms
from dino_tracker_tpu_torch.preprocessing import best_buddies as bb_lib
from dino_tracker_tpu_torch.utils.coords import bb_meshgrid

COS_TOL, R_TOL = 1e-5, 1e-6
# a 9×13 token grid (n = 117) and the 5×7 one of tests/test_best_buddies.py
H, W = 70, 98
SMALL_H, SMALL_W = 42, 56


def greedy_nms_top2_reference(scores, coords, topk, box_size, iou_thresh):
    """Full greedy NMS (the reference's batched_nms semantics for equal-size
    boxes), returning the first two surviving peak scores
    (tests/test_best_buddies.py:19)."""
    order = np.argsort(-scores, kind="stable")[:topk]
    kept = []
    for i in order:
        ok = True
        for j in kept:
            d = np.abs(coords[i] - coords[j])
            side = 2 * box_size
            inter = max(0.0, side - d[0]) * max(0.0, side - d[1])
            iou = inter / (2 * side * side - inter)
            if iou > iou_thresh:
                ok = False
                break
        if ok:
            kept.append(i)
        if len(kept) == 2:
            break
    p1 = scores[kept[0]]
    p2 = scores[kept[1]] if len(kept) > 1 else 0.0
    return p1, p2


def scene(t, c, gh, gw, noise, seed):
    """T×C×gh×gw features: a per-position code plus per-frame noise, so most
    tokens have a mutual match in every other frame."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((c, gh, gw))
    return (pos[None] + noise * rng.standard_normal((t, c, gh, gw))).astype(np.float32)


def trajectories(n, t, h, w, seed, nan_share=0.4):
    rng = np.random.default_rng(seed)
    trajs = (rng.random((n, t, 2)) * [w - 1, h - 1]).astype(np.float32)
    trajs[rng.random((n, t)) < nan_share] = np.nan
    return trajs


def port_bb(jbbdata):
    """A JAX BBData as the port's, numpy fields."""
    return structures.BBData(*(np.asarray(x) for x in jbbdata))


def assert_bb_equal(ours, ref):
    """Coordinates and validity equal, cos within COS_TOL of max|cos|, r
    within R_TOL."""
    ref = [np.asarray(x) for x in ref]
    ours = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in ours]
    for name, o, r in zip(structures.BBData._fields, ours, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, (name, o.shape, r.shape, o.dtype)
    for i in (0, 1, 4):
        np.testing.assert_array_equal(ours[i], ref[i], err_msg=structures.BBData._fields[i])
    scale = max(np.abs(ref[2]).max(), 1e-30)
    assert np.abs(ours[2] - ref[2]).max() <= COS_TOL * scale
    assert np.abs(ours[3] - ref[3]).max() <= R_TOL


def run_both(feats, h, w, **kw):
    """(port BBData, JAX BBData, port telemetry, JAX telemetry)."""
    tel, jtel = {}, {}
    ours = bb_lib.extract_best_buddies(torch.from_numpy(feats), h, w, 7, telemetry=tel, **kw)
    ref = jbb.extract_best_buddies(jnp.asarray(feats), h, w, 7, telemetry=jtel, **kw)
    return ours, ref, tel, jtel


# ---------------------------------------------------------------------------
# grid, top-k membership, NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(476, 854), (42, 56), (42, 60), (128, 224)])
def test_bb_meshgrid_matches_jax(hw):
    ours = bb_meshgrid(*hw, 7)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jcoords.bb_meshgrid(*hw, 7)))


def tie_rows(seed):
    """Rows full of exact ties: a few distinct values repeated, ±0.0 and
    -inf among them."""
    rng = np.random.default_rng(seed)
    vals = np.array([-np.inf, -1.5, -0.0, 0.0, 0.25, 0.25, 1.0, 3.0], np.float32)
    return vals[rng.integers(0, len(vals), (6, 50))]


@pytest.mark.parametrize("k", [1, 7, 20, 49, 50, 60])
def test_topk_mask_tie_rule_matches_jax(k):
    scores = tie_rows(k)
    ours = nms.topk_mask(torch.from_numpy(scores), k).numpy()
    ref = np.asarray(jselect.topk_mask(jnp.asarray(scores), k))
    np.testing.assert_array_equal(ours, ref)
    assert (ours.sum(1) == min(k, 50)).all()
    # -0.0 orders below +0.0: a row whose k-th value is 0 takes +0.0 first
    row = np.array([-0.0, 0.0, -0.0, 0.0, 1.0], np.float32)
    np.testing.assert_array_equal(nms.topk_mask(torch.from_numpy(row[None]), 2).numpy()[0],
                                  [False, True, False, False, True])


def test_box_iou():
    a = torch.tensor([[0.0, 0.0]])
    assert float(nms.same_size_box_iou(a, torch.tensor([[0.0, 0.0]]), 30.0)[0]) == 1.0
    assert float(nms.same_size_box_iou(a, torch.tensor([[120.0, 0.0]]), 30.0)[0]) == 0.0
    pts = np.random.default_rng(2).random((40, 2), dtype=np.float32) * 100
    ours = nms.same_size_box_iou(torch.from_numpy(pts)[None], torch.from_numpy(pts)[:, None], 30.0)
    ref = jnms.same_size_box_iou(jnp.asarray(pts)[None], jnp.asarray(pts)[:, None], 30.0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ties", [False, True])
def test_nms_top2_matches_full_greedy_and_jax(ties):
    rng = np.random.default_rng(19)
    n = 300
    coords = (rng.random((n, 2)) * 400).astype(np.float32)
    scores = rng.random((5, n)).astype(np.float32)
    if ties:  # quantised scores: ties at the top-k boundary, exact zeros
        scores = np.round(scores * 8) / 8
        scores[:, :10] = -0.0
    peaks, r = nms.nms_top2_peaks(torch.from_numpy(scores), torch.from_numpy(coords),
                                  topk=100, box_size=30.0, iou_thresh=0.2)
    jpeaks, jr = jnms.nms_top2_peaks(jnp.asarray(scores), jnp.asarray(coords),
                                     topk=100, box_size=30.0, iou_thresh=0.2)
    np.testing.assert_array_equal(peaks.numpy(), np.asarray(jpeaks))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    for b in range(len(scores)):
        p1, p2 = greedy_nms_top2_reference(scores[b], coords, 100, 30.0, 0.2)
        np.testing.assert_allclose(peaks[b].numpy(), [p1, p2], atol=1e-6)
        np.testing.assert_allclose(float(r[b]), p2 / p1, atol=1e-6)


def test_nms_peak2_zero_without_candidate():
    """Every top-k candidate overlaps peak 1: peak2 is 0, r is 0."""
    coords = torch.tensor([[10.0, 10.0], [11.0, 10.0], [200.0, 200.0]])
    scores = torch.tensor([[0.9, 0.8, 0.1]])
    peaks, r = nms.nms_top2_peaks(scores, coords, topk=2, box_size=30.0, iou_thresh=0.2)
    assert peaks.tolist() == [[pytest.approx(0.9), 0.0]] and r.tolist() == [0.0]


# ---------------------------------------------------------------------------
# the sweep: the fixtures of tests/test_best_buddies.py, against JAX
# ---------------------------------------------------------------------------

def identity_features(t, c, seed):
    """Distinct per-position features, identical across frames."""
    n = 35
    pos = np.random.default_rng(seed).standard_normal((n, c)).astype(np.float32) * 2
    return np.tile(pos.T.reshape(1, c, 5, 7), (t, 1, 1, 1))


def test_identity_features_match_jax():
    feats = identity_features(3, 16, 0)
    ours, ref, _, _ = run_both(feats, SMALL_H, SMALL_W, cap=35)
    assert_bb_equal(ours, ref)
    v = ours.valid.numpy()
    assert v[0, 1].all() and not v[0, 0].any()
    np.testing.assert_allclose(ours.cos_sims[0, 1].numpy(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(ours.source_coords[0, 1], ours.target_coords[0, 1])
    np.testing.assert_array_equal(ours.source_coords[1, 0], ours.target_coords[0, 1])


def test_cap_above_token_count_matches_jax():
    """An explicit cap above n pads with empty slots (zeros)."""
    feats = identity_features(2, 16, 1)
    ours, ref, tel, jtel = run_both(feats, SMALL_H, SMALL_W, cap=35 + 61)
    assert_bb_equal(ours, ref)
    v = ours.valid.numpy()
    assert v.shape[-1] == 96 and v[0, 1, :35].all() and not v[0, 1, 35:].any()
    assert not ours.source_coords[0, 1, 35:].any()


def test_mutuality_random_matches_brute_force_and_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 8, 5, 7)).astype(np.float32)
    ours, ref, _, _ = run_both(feats, SMALL_H, SMALL_W, cap=35)
    assert_bb_equal(ours, ref)
    a, b = (f.reshape(8, -1).T for f in feats)
    aff = (a / np.linalg.norm(a, axis=1, keepdims=True)) @ (
        b / np.linalg.norm(b, axis=1, keepdims=True)).T
    mutual = np.arange(35) == aff.argmax(0)[aff.argmax(1)]
    grid = bb_meshgrid(SMALL_H, SMALL_W).numpy()
    got = ours.source_coords[0, 1].numpy()[ours.valid[0, 1].numpy()]
    assert set(map(tuple, got)) == set(map(tuple, grid[mutual]))


@pytest.mark.parametrize("cap", [None, 117, 200, 32])
@pytest.mark.parametrize("filtered", [False, True])
def test_sweep_modes_match_jax(cap, filtered):
    """Adaptive, explicit cap = n and > n (raw), and a fixed cap < n
    (compacted, empty slots filled with token 0's coordinates), each with and
    without the fused filter; telemetry equal."""
    t = 4
    feats = scene(t, 16, 9, 13, 0.3, seed=5)
    trajs = trajectories(60, t, H, W, seed=6) if filtered else None
    ours, ref, tel, jtel = run_both(feats, H, W, cap=cap, unfiltered_trajectories=trajs)
    assert_bb_equal(ours, ref)
    assert tel.keys() == jtel.keys()
    assert set(tel["phases"]) == {"closest_grids_s", "sweep_s", "compaction_s"}
    assert {k: v for k, v in tel.items() if k != "phases"} == {
        k: v for k, v in jtel.items() if k != "phases"}
    counts = ours.valid.sum(-1).numpy()
    assert (np.diag(counts) == 0).all() and counts.sum() > 0
    if cap == 32 and not filtered:  # every pair truncated; empty slots do exist
        assert tel["truncated_pairs"] == tel["total_pairs"] == 6
    if cap is None:
        assert tel["cap"] == min(117, max(128, -(-tel["max_count"] // 128) * 128))


def test_fixed_cap_fill_coordinates_match_jax():
    """A fixed cap above most pairs' counts: the empty slots carry grid[0]
    and grid[argmax of token 0] with cos 0, as the JAX compaction leaves
    them."""
    feats = scene(3, 16, 9, 13, 1.5, seed=7)
    ours, ref, tel, _ = run_both(feats, H, W, cap=100)
    assert_bb_equal(ours, ref)
    v = ours.valid.numpy()
    assert not v[0, 1].all() and v[0, 1].any()
    empty = ~v[0, 1]
    np.testing.assert_array_equal(ours.source_coords[0, 1].numpy()[empty],
                                  np.broadcast_to([7.0, 7.0], (empty.sum(), 2)))
    assert not ours.cos_sims[0, 1].numpy()[empty].any()


def test_fused_filter_before_cap_matches_jax():
    """With cap 2, a flow-covered high-cosine buddy must not evict the
    flow-gap buddy the filter keeps."""
    t = 2
    grid = bb_meshgrid(SMALL_H, SMALL_W).numpy()
    rng = np.random.default_rng(8)
    pos = rng.standard_normal((35, 8)).astype(np.float32) * 3
    feats = np.stack([pos, pos.copy()])
    feats[1, 5] += rng.standard_normal(8).astype(np.float32) * 0.4
    feats = feats.transpose(0, 2, 1).reshape(t, 8, 5, 7)
    trajs = np.tile(grid[:, None, :], (1, t, 1)).astype(np.float32)
    trajs[5, 1] = np.nan
    late = np.full((1, t, 2), np.nan, np.float32)
    late[0, 1] = grid[5]
    trajs = np.concatenate([trajs, late])
    ours, ref, _, _ = run_both(feats, SMALL_H, SMALL_W, cap=2, unfiltered_trajectories=trajs)
    assert_bb_equal(ours, ref)
    v = ours.valid[0, 1].numpy()
    assert v.sum() == 1
    np.testing.assert_array_equal(ours.source_coords[0, 1].numpy()[v][0], grid[5])


# ---------------------------------------------------------------------------
# closest trajectories and the optical-flow filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [7, 8192])
def test_closest_trajectory_grids_match_jax(chunk):
    trajs = trajectories(300, 3, H, W, seed=9)
    grid = bb_meshgrid(H, W)
    ours = bb_lib.closest_trajectory_grids(trajs, grid, chunk=chunk)
    ref = jbb.closest_trajectory_grids(trajs, jnp.asarray(grid.numpy()), chunk=chunk)
    assert ours.shape == (3, 117)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_closest_trajectory_grids_first_index_on_ties():
    """Integer coordinates at equal distances from grid points, in several
    chunks and within one, and NaN rows: the first index wins in both
    packages."""
    grid = bb_meshgrid(SMALL_H, SMALL_W)
    pts = [[8, 7], [6, 7], [7, 8], [7, 6],  # all 1 px from (7, 7)
           [14, 15], [15, 14], [13, 14], [14, 13], [15, 14],  # 1 px from (14, 14)
           [np.nan, np.nan], [35, 35], [35, 35], [10.5, 7]]
    trajs = np.tile(np.asarray(pts, np.float32)[::-1][:, None], (1, 2, 1))
    trajs[0, 1] = np.nan
    for chunk in (2, 3, 8192):
        ours = bb_lib.closest_trajectory_grids(trajs, grid, chunk=chunk).numpy()
        ref = jbb.closest_trajectory_grids(trajs, jnp.asarray(grid.numpy()), chunk=chunk)
        np.testing.assert_array_equal(ours, ref)
        n = len(pts)
        assert ours[0, 0] == n - 4 and ours[0, 8] == n - 9  # the last point of each group
        assert ours[1, 0] == n - 4


def test_closest_trajectory_grids_needs_a_lattice():
    grid = bb_meshgrid(SMALL_H, SMALL_W)
    with pytest.raises(ValueError, match="lattice"):
        bb_lib.closest_trajectory_grids(np.zeros((3, 2, 2), np.float32), grid[:-1])


def test_of_filter_matches_jax():
    t = 3
    feats = scene(t, 16, 9, 13, 0.3, seed=10)
    jbbdata = jbb.extract_best_buddies(jnp.asarray(feats), H, W, 7, cap=117)
    trajs = trajectories(80, t, H, W, seed=11, nan_share=0.5)
    ours = bb_lib.of_filter_best_buddies(port_bb(jbbdata), trajs, H, W, 7)
    ref = jbb.of_filter_best_buddies(jbbdata, trajs, H, W, 7)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    kept = ours.valid.numpy()
    assert 0 < kept.sum() < np.asarray(jbbdata.valid).sum()

    # the fixture of tests/test_best_buddies.py: flow everywhere drops every
    # buddy; a flow gap between frames 0 and 1 keeps theirs
    feats = identity_features(t, 8, 12)
    jbbdata = jbb.extract_best_buddies(jnp.asarray(feats), SMALL_H, SMALL_W, 7, cap=35)
    grid = bb_meshgrid(SMALL_H, SMALL_W).numpy()
    full = np.tile(grid[:, None, :], (1, t, 1)).astype(np.float32)
    gap = full.copy()
    gap[:, :2] = np.nan
    for trajs, want_01 in ((full, 0), (gap, 35)):
        ours = bb_lib.of_filter_best_buddies(port_bb(jbbdata), trajs, SMALL_H, SMALL_W, 7)
        ref = jbb.of_filter_best_buddies(jbbdata, trajs, SMALL_H, SMALL_W, 7)
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        assert ours.valid[0, 1].sum() == want_01 and not ours.valid[0, 2].any()


# ---------------------------------------------------------------------------
# ambiguity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows_per_slab,box,topk", [(8192, 30.0, 400), (16, 5.0, 8)])
def test_bb_ambiguity_matches_jax(rows_per_slab, box, topk):
    t = 3
    feats = scene(t, 16, 9, 13, 0.6, seed=13)
    jbbdata = jbb.extract_best_buddies(jnp.asarray(feats), H, W, 7, cap=64)
    tel = {}
    ours = bb_lib.compute_bb_ambiguity(port_bb(jbbdata), torch.from_numpy(feats), H, W, 7,
                                       box_size=box, topk=topk, rows_per_slab=rows_per_slab,
                                       telemetry=tel)
    ref = jbb.compute_bb_ambiguity(jbbdata, jnp.asarray(feats), H, W, 7, box_size=box,
                                   topk=topk)
    r, jr = ours.r.numpy(), np.asarray(ref.r)
    assert np.abs(r - jr).max() <= R_TOL
    valid = np.asarray(jbbdata.valid)
    assert (r[~valid] == 1.0).all() and (r[valid] < 1.0).any()
    np.testing.assert_array_equal(r, np.maximum(r, r.transpose(1, 0, 2)))
    assert tel["rows_total"] == valid.sum() and tel["m_max"] <= valid.sum()
    assert rows_per_slab > 8 or tel["m_max"] > rows_per_slab  # the small slab splits
    assert set(tel["phases"]) == {"group_rows_s", "slabs_s", "scatter_s"}


def test_bb_ambiguity_without_rows_is_ones():
    feats = scene(2, 16, 9, 13, 0.3, seed=14)
    empty = structures.empty_bb_data(2, 8)
    ours = bb_lib.compute_bb_ambiguity(empty, torch.from_numpy(feats), H, W, 7)
    ref = jbb.compute_bb_ambiguity(jstructures.empty_bb_data(2, 8), jnp.asarray(feats), H, W, 7)
    np.testing.assert_array_equal(ours.r.numpy(), np.asarray(ref.r))
    assert (ours.r == 1.0).all()


def test_ambiguity_low_for_unique_match():
    """The fixture of tests/test_best_buddies.py: a unique sharp match has a
    small r; a feature duplicated far away has r ≈ 1."""
    grid = bb_meshgrid(SMALL_H, SMALL_W).numpy()
    uniq = np.random.default_rng(15).standard_normal((35, 16)).astype(np.float32) * 3
    dup = uniq.copy()
    dup[0] = dup[34]
    for pos, check in ((uniq, "low"), (dup, "ambiguous")):
        feats = np.tile(pos.T.reshape(1, 16, 5, 7), (2, 1, 1, 1))
        bb = bb_lib.extract_best_buddies(torch.from_numpy(feats), SMALL_H, SMALL_W, 7, cap=35)
        ours = bb_lib.compute_bb_ambiguity(bb, torch.from_numpy(feats), SMALL_H, SMALL_W, 7,
                                           box_size=5.0)
        ref = jbb.compute_bb_ambiguity(port_bb(bb), jnp.asarray(feats), SMALL_H, SMALL_W, 7,
                                       box_size=5.0)
        assert np.abs(ours.r.numpy() - np.asarray(ref.r)).max() <= R_TOL
        v, r = ours.valid[0, 1].numpy(), ours.r[0, 1].numpy()
        if check == "low":
            assert (r[v] < 0.9).mean() > 0.8
        else:
            srcs = ours.source_coords[0, 1].numpy()
            amb = {tuple(grid[0]), tuple(grid[-1])}
            hit = [r[i] for i in range(len(v)) if v[i] and tuple(srcs[i]) in amb]
            assert hit and max(hit) > 0.99


# ---------------------------------------------------------------------------
# the artifact and the grid guard
# ---------------------------------------------------------------------------

def test_bb_artifact_read_by_both_packages(tmp_path):
    feats = scene(3, 16, 9, 13, 0.3, seed=16)
    bb = bb_lib.extract_best_buddies(torch.from_numpy(feats), H, W, 7)
    bb = bb_lib.compute_bb_ambiguity(bb, torch.from_numpy(feats), H, W, 7, topk=8)
    assert bb.num_frames == 3 and bb.capacity == bb.valid.shape[2]
    ours_path, jax_path = str(tmp_path / "port" / "bb.npz"), str(tmp_path / "jax.npz")
    structures.save_bb_data(ours_path, bb)
    jstructures.save_bb_data(jax_path, port_bb([x.numpy() for x in bb]))
    with np.load(ours_path) as f:
        assert sorted(f.files) == sorted(structures.BBData._fields)
    for path in (ours_path, jax_path):
        for loaded in (structures.load_bb_data(path), jstructures.load_bb_data(path)):
            for a, b in zip(loaded, bb):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    empty = structures.empty_bb_data(2, 4)
    for a, b in zip(empty, jstructures.empty_bb_data(2, 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grid_guard_at_sizes_off_the_stride():
    """At 42×60 the best-buddy grid has 5×8 points for 5×7 tokens: the port
    raises, and the JAX stage fails too (its NMS broadcast)."""
    feats = np.random.default_rng(17).standard_normal((2, 8, 5, 7)).astype(np.float32)
    for fn in (lambda: bb_lib.extract_best_buddies(torch.from_numpy(feats), 42, 60, 7),
               lambda: bb_lib.compute_bb_ambiguity(structures.empty_bb_data(2, 4),
                                                   torch.from_numpy(feats), 42, 60, 7)):
        with pytest.raises(ValueError, match="5x8 points .* 5x7 tokens"):
            fn()
    with pytest.raises(Exception):
        jbbdata = jbb.extract_best_buddies(jnp.asarray(feats), 42, 60, 7)
        jbb.compute_bb_ambiguity(jbbdata, jnp.asarray(feats), 42, 60, 7)
