"""The port's trajectory sampler, held to the invariants of
tests/test_sampler.py (JAX random streams cannot match the port's
``torch.Generator``, so the draws themselves are not compared), plus the
fixed-shape ``unique`` against ``jnp.unique(size=, fill_value=)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.training import sampler
from test_torch_threads import one_thread  # noqa: F401

W, H = 854, 476


def make_trajs(rng, n, t, visible_prob=0.7, lo=0.0, hi=100.0):
    traj = (lo + rng.random((n, t, 2)) * (hi - lo)).astype(np.float32)
    traj[rng.random((n, t)) >= visible_prob] = np.nan
    return traj


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_build_bank_filters_short_trajectories():
    traj = make_trajs(np.random.default_rng(0), 50, 10)
    traj[0, 1:] = np.nan  # only 1 valid frame -> dropped
    traj[1, 2:] = np.nan  # 2 valid frames -> kept
    bank = sampler.build_bank(traj, pad_to=64)
    keep = (~np.isnan(traj).any(-1)).sum(1) > 1
    assert bank.count == keep.sum() and bank.coords.shape == (64, 10, 2)
    assert (bank.valid[:bank.count].sum(1) > 1).all()
    assert not bank.valid[bank.count:].any()
    np.testing.assert_array_equal(bank.coords[:bank.count].numpy(),
                                  np.nan_to_num(traj[keep]))


def check_sample(s, fg_bank, bg_bank, fg_batch, t, set_size):
    frames = s.frames_set_t.numpy()
    src, tgt = s.source_frame_indices.numpy(), s.target_frame_indices.numpy()
    t2_abs = s.target_times.numpy().astype(np.int64)
    t1_abs = np.round((s.t1_points[:, 2].numpy() + 1) / 2 * (t - 1)).astype(np.int64)
    assert frames.shape == (set_size,)
    assert ((frames >= 0) & (frames < t)).all()
    assert (src < set_size).all() and (tgt < set_size).all()
    # indices round-trip to the sampled frames; t1 != t2 per point
    np.testing.assert_array_equal(frames[tgt], t2_abs)
    np.testing.assert_array_equal(frames[src], t1_abs)
    assert (t1_abs != t2_abs).all()
    assert np.abs(s.t2_points_normalized.numpy()[:, :2]).max() <= 1.0
    # each point is a visible bank point at its frame, fg rows first
    t1_xy = s.t1_points[:, :2].numpy()
    t2_xy = (s.t2_points_normalized[:, :2].numpy() + 1) / 2 * [W - 1, H - 1]
    for i in range(len(t1_xy)):
        bank = fg_bank if i < fg_batch else bg_bank
        coords, valid = bank.coords.numpy(), bank.valid.numpy()
        d1 = np.abs(coords[:, t1_abs[i]] - t1_xy[i]).sum(1)
        d2 = np.abs(coords[:, t2_abs[i]] - t2_xy[i]).sum(1)
        rows = np.flatnonzero((d1 < 1e-4) & (d2 < 1e-2))
        assert len(rows) and (valid[rows, t1_abs[i]] & valid[rows, t2_abs[i]]).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_batch_properties_and_fg_bg_split(seed):
    """Banks with disjoint coordinate ranges: the first fg_batch points come
    from the fg bank, the rest from the bg bank; every point lies on a real
    visible trajectory point."""
    rng = np.random.default_rng(seed)
    t = 12
    fg = sampler.build_bank(make_trajs(rng, 200, t, lo=0, hi=100))
    bg = sampler.build_bank(make_trajs(rng, 300, t, lo=200, hi=400))
    s = sampler.sample_batch(gen(seed), fg, bg, batch_size=64, num_frames=4,
                             fg_traj_ratio=0.5, video_len=t, video_w=W,
                             video_h=H)
    check_sample(s, fg, bg, 32, t, 8)
    assert (s.t1_points[:32, :2] < 100).all() and (s.t1_points[32:, :2] >= 200).all()


def test_sample_batch_draws_distinct_trajectories():
    """Without replacement: a bank larger than the batch gives distinct rows
    (each trajectory here has unique coordinates)."""
    rng = np.random.default_rng(3)
    t = 8
    bank = sampler.build_bank(make_trajs(rng, 100, t, visible_prob=1.0))
    s = sampler.sample_batch(gen(3), bank, bank, 64, 4, 0.5, t, W, H)
    fg_rows = {tuple(p) for p in s.t1_points[:32, :2].numpy().round(4)}
    assert len(fg_rows) == 32


def test_sample_batch_bank_smaller_than_batch():
    """Banks with fewer rows than the point budget wrap around instead of
    failing (a real video once kept 66 trajectories against a batch of 256)."""
    rng = np.random.default_rng(4)
    t = 10
    fg = sampler.build_bank(make_trajs(rng, 7, t, visible_prob=1.0))
    bg = sampler.build_bank(make_trajs(rng, 5, t, visible_prob=1.0))
    s = sampler.sample_batch(gen(4), fg, bg, 64, 4, 0.5, t, W, H)
    assert s.t1_points.shape == (64, 3)
    check_sample(s, fg, bg, 32, t, 8)


def test_sample_batch_frame_rejection_fallback():
    """Rows visible in only 2 of 40 frames: most 4-frame draws expose no
    eligible row, so sampling leans on the bounded retry and the fallback
    (frames from row 0's own visibility). Every point must still be a
    visible pair of its trajectory."""
    t = 40
    traj = np.full((3, t, 2), np.nan, np.float32)
    for r, frames in enumerate([(0, 1), (5, 30), (12, 13)]):
        traj[r, frames] = [[10 + r, 20 + r], [30 + r, 40 + r]]
    bank = sampler.build_bank(traj, pad_to=8)
    for seed in range(6):
        s = sampler.sample_batch(gen(seed), bank, bank, 16, 4, 0.5, t, W, H)
        check_sample(s, bank, bank, 8, t, 8)


def test_resolve_fg_batch_empty_banks():
    rng = np.random.default_rng(5)
    full = sampler.build_bank(make_trajs(rng, 20, 10, visible_prob=1.0))
    empty = sampler.build_bank(np.full((0, 10, 2), np.nan, np.float32))
    assert sampler.resolve_fg_batch(full, full, 64, 0.5) == 32
    assert sampler.resolve_fg_batch(empty, full, 64, 0.5) == 0
    assert sampler.resolve_fg_batch(full, empty, 64, 0.5) == 64
    with pytest.raises(ValueError, match="both trajectory banks are empty"):
        sampler.resolve_fg_batch(empty, empty, 64, 0.5)
    # the whole batch routed to the non-empty side
    s = sampler.sample_batch(gen(5), full, empty, 32, 4, 0.5, 10, W, H,
                             fg_batch=32)
    check_sample(s, full, empty, 32, 10, 8)
    with pytest.raises(ValueError, match="empty trajectory bank"):
        sampler.sample_batch(gen(5), full, empty, 32, 4, 0.5, 10, W, H)


def test_bank_rotator_windows_and_advances():
    rng = np.random.default_rng(6)
    t = 6
    traj = make_trajs(rng, 50, t, visible_prob=1.0)
    rot = sampler.BankRotator(traj, traj, window=20)
    fg, bg = rot.current()
    assert fg.coords.shape == (20, t, 2) and fg.count == 20
    np.testing.assert_array_equal(fg.coords.numpy(), traj[:20])
    fg2, _ = rot.advance()
    np.testing.assert_array_equal(fg2.coords.numpy(), traj[20:40])
    fg3, _ = rot.advance()  # wraps around the end
    np.testing.assert_array_equal(fg3.coords.numpy(),
                                  traj[(40 + np.arange(20)) % 50])
    # small sets are padded, count gives the real rows
    small, _ = sampler.BankRotator(traj[:5], traj[:5], window=20).current()
    assert small.coords.shape == (20, t, 2) and small.count == 5


@pytest.mark.parametrize("seed", range(4))
def test_unique_padded_matches_jnp_unique(seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 12 if seed < 3 else 40, 30)
    size = 8 if seed < 2 else 16
    ref = jnp.unique(jnp.asarray(values), size=size, fill_value=50)
    ours = sampler.unique_padded(torch.from_numpy(values), size, 50)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
