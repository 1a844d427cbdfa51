"""Pipeline stage 1 of the port — RAFT flows, cycle masks and chained
trajectories — held against the JAX package on the CPU.

Constructed flows (``tests/test_trajectories.py``'s translations, with
blobs that break the cycle check and a direct flow that disagrees on half the
frame): ``compute_flow_masks``, ``extract_trajectories`` (with and without
the direct filter) and ``extract_trajectories_dual`` equal the JAX package's
element for element, NaNs included. Such flows land every sample on a pixel,
so both packages' samplers return the same floats.

RAFT-decoded flows (converted weights, a tiny video): ``RaftFlowEngine``'s
adjacent and direct flows within 1e-4 of max|flow| of the JAX engine's, and
equal cycle masks; then stage 1 through ``PreprocessingPipeline`` on a tiny
PNG folder against JAX ``extract_trajectories_dual`` fed the JAX engine's
flows: the same trajectory counts, the same NaN pattern and positions within
1e-4 px. Two such flows differ by ~1e-6 px, so a point within that of a
threshold (a cycle error, a rounding for the occupancy) could flip; on these
seeded inputs none does, and the comparison is deterministic.

The JAX ``PreprocessingPipeline`` is not built here: its constructor turns on
JAX's persistent compile cache.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_tracker_tpu.models import raft as jraft
from dino_tracker_tpu.preprocessing import flow as jflow
from dino_tracker_tpu.preprocessing import trajectories as jtraj
from dino_tracker_tpu.utils import video_io as jvideo_io
from dino_tracker_tpu_torch.config import PreprocessConfig
from dino_tracker_tpu_torch.models import raft as praft
from dino_tracker_tpu_torch.preprocessing import flow as pflow
from dino_tracker_tpu_torch.preprocessing import trajectories as ptraj
from dino_tracker_tpu_torch.preprocessing.pipeline import PreprocessingPipeline
from dino_tracker_tpu_torch.utils import native_traj, video_io

CPU = torch.device("cpu")


def constant_flow(t, h, w, dx, dy):
    fwd = np.zeros((t - 1, 2, h, w), np.float32)
    fwd[:, 0], fwd[:, 1] = dx, dy
    return fwd, -fwd.copy()


def noisy_flow(t, h, w, seed=3):
    """Translation with a 3×3 blob per transition whose cycle check fails."""
    rng = np.random.default_rng(seed)
    fwd, bwd = constant_flow(t, h, w, 1.0, 0.0)
    for k in range(t - 1):
        y0, x0 = rng.integers(0, h - 3), rng.integers(0, w - 3)
        bwd[k, :, y0:y0 + 3, x0:x0 + 3] += 10.0
    return fwd, bwd


def flows(kind, t=6, h=12, w=14):
    if kind == "static":
        return constant_flow(t, h, w, 0.0, 0.0)
    if kind == "translation":
        return constant_flow(t, h, w, 2.0, -1.0)
    return noisy_flow(t, h, w)


def disagreeing_direct_fn(t, h, w):
    """Direct flows consistent with a +1 px translation except on the top
    half, where they are 50 px off (ragged: t-1-start rows)."""
    def direct_fn(start):
        n = t - 1 - start
        dflows = np.zeros((n, h, w, 2), np.float32)
        dflows[..., 0] = np.arange(1, n + 1, dtype=np.float32)[:, None, None]
        dflows[:, : h // 2, :, 0] += 50.0
        return dflows, np.ones((n, h, w), np.float32)
    return direct_fn


@pytest.mark.parametrize("kind", ["static", "translation", "noisy"])
def test_compute_flow_masks_match_jax(kind):
    fwd, bwd = flows(kind)
    ours = ptraj.compute_flow_masks(torch.from_numpy(fwd), torch.from_numpy(bwd), 1.0)
    ref = np.asarray(jtraj.compute_flow_masks(jnp.asarray(fwd), jnp.asarray(bwd), 1.0))
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert not ref[0].any() and ref[1:].any()


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("kind", ["static", "translation", "noisy"])
def test_extract_trajectories_match_jax(kind, direct):
    fwd, bwd = flows(kind)
    t, _, h, w = (fwd.shape[0] + 1,) + fwd.shape[1:]
    kw = dict(threshold=1.0, min_trajectory_length=2)
    if direct:
        kw.update(direct_flow_fn=disagreeing_direct_fn(t, h, w), direct_flow_threshold=2.5)
    ours = ptraj.extract_trajectories(torch.from_numpy(fwd), torch.from_numpy(bwd), **kw)
    ref = jtraj.extract_trajectories(fwd, bwd, **kw)
    assert ours.dtype == np.float32 and len(ref)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("min_len", [2, 4])
@pytest.mark.parametrize("kind", ["translation", "noisy"])
def test_extract_trajectories_dual_match_jax(kind, min_len):
    """Both passes in one sweep against the JAX dual sweep; the passes
    differ (the direct filter kills the top half)."""
    fwd, bwd = flows(kind)
    t, _, h, w = (fwd.shape[0] + 1,) + fwd.shape[1:]
    kw = dict(threshold=1.0, min_trajectory_length=min_len, direct_flow_threshold=2.5,
              direct_flow_fn=disagreeing_direct_fn(t, h, w))
    timings = {}
    got_f, got_u = ptraj.extract_trajectories_dual(torch.from_numpy(fwd),
                                                   torch.from_numpy(bwd), timings=timings, **kw)
    want_f, want_u = jtraj.extract_trajectories_dual(fwd, bwd, **kw)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_u, want_u)
    assert len(want_f) != len(want_u)
    assert set(timings) == {"direct_sweep_and_chaining", "harvest"}


def test_min_trajectory_length_drops_short_tracks():
    fwd, bwd = constant_flow(4, 8, 8, 0.0, 0.0)
    bwd[2] += 10.0  # the last transition fails its cycle check everywhere
    for min_len, n in ((3, 64), (4, 0)):
        ours = ptraj.extract_trajectories(torch.from_numpy(fwd), torch.from_numpy(bwd),
                                          threshold=1.0, min_trajectory_length=min_len)
        ref = jtraj.extract_trajectories(fwd, bwd, threshold=1.0,
                                         min_trajectory_length=min_len)
        assert ours.shape == ref.shape == (n, 4, 2)
        np.testing.assert_array_equal(ours, ref)


def test_occupancy_update_native_matches_numpy():
    """The native library (built into build/native/, never native/) and the
    NumPy path mark the same cells, half-way points rounded to even."""
    rng = np.random.default_rng(0)
    t, k, h, w = 7, 500, 11, 13
    trajs = np.stack([rng.uniform(-2, w + 1, (t, k)), rng.uniform(-2, h + 1, (t, k))],
                     -1).astype(np.float32)
    trajs[:, :20] = np.round(trajs[:, :20]) + 0.5
    trajs[rng.random((t, k)) < 0.2] = np.nan
    native = np.zeros((t, h, w), bool)
    numpy_ = np.zeros((t, h, w), bool)
    if native_traj.get_lib() is None:
        pytest.skip("native toolchain (g++) unavailable")
    assert native_traj._LIB.endswith(os.path.join("build", "native", "libtrajectory_ops.so"))
    native_traj.occupancy_update(trajs, native, 2)
    native_traj.occupancy_update_numpy(trajs, numpy_, 2)
    np.testing.assert_array_equal(native, numpy_)
    assert not native[:2].any() and native[2:].any()
    with pytest.raises(ValueError):
        native_traj.occupancy_update(trajs, native.astype(np.uint8), 0)


# ---------------------------------------------------------------------------
# RAFT-decoded flows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, jraft.init_raft(jax.random.PRNGKey(5)))
    return params, praft.load_raft_state_dict(praft.raft_state_from_jax(params), CPU)


def video(seed, t, h, w):
    """A smooth textured frame shifted by 1.5 px right and 0.5 px down per
    frame, in [0, 1]."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    frames = [0.5 + 0.2 * np.sin(0.3 * (xx - 1.5 * i) + 0.1 * seed)
              * np.cos(0.25 * (yy - 0.5 * i)) for i in range(t)]
    return np.repeat(np.stack(frames)[:, None], 3, axis=1).astype(np.float32)


def assert_flows_close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_flow_engine_matches_jax(weights):
    params, model = weights
    t, h, w = 4, 30, 41
    vid = video(0, t, h, w)
    ref = jflow.RaftFlowEngine(params, vid, num_iters=3, pair_batch=2, encode_batch=3)
    ours = pflow.RaftFlowEngine(model, torch.from_numpy(vid), num_iters=3, pair_batch=2,
                                encode_batch=3, device=CPU)
    for o, r in zip(ours.adjacent_flows(), ref.adjacent_flows()):
        assert o.shape == (t - 1, 2, h, w)
        assert_flows_close(o, r)
    assert ours.adjacent_flows()[0] is ours.adjacent_flows()[0]  # cached
    for start in (0, 2):
        dflows, dmasks = ours.direct_flows(start, 1.0)
        rflows, rmasks = ref.direct_flows(start, 1.0)
        assert dflows.shape == (t - 1, h, w, 2) and dmasks.shape == (t - 1, h, w)
        assert_flows_close(dflows, rflows)
        np.testing.assert_array_equal(dmasks.numpy(), np.asarray(rmasks))
        assert not dflows[t - 1 - start:].any() and not dmasks[t - 1 - start:].any()
        assert 0 < float(dmasks[: t - 1 - start].mean()) < 1


def write_frames(folder, frames):
    os.makedirs(folder)
    for i, f in enumerate(frames):
        Image.fromarray(np.round(f.transpose(1, 2, 0) * 255).astype(np.uint8)
                        ).save(os.path.join(folder, f"{i:05d}.png"))


def test_pipeline_stage_1_matches_jax(tmp_path, weights):
    """Stage 1 on a tiny PNG folder (5 frames at 40×56) through the
    pipeline; the JAX package's dual sweep on its own engine's flows."""
    params, model = weights
    t, h, w = 5, 40, 56
    root = str(tmp_path / "vid")
    write_frames(os.path.join(root, "video"), video(1, t, h, w))
    cfg = PreprocessConfig(video_resh=h, video_resw=w, raft_iters=3, threshold=3.0,
                           direct_flow_threshold=0.3)
    pipe = PreprocessingPipeline(root, cfg, device=CPU, raft=model)
    trajs, unfiltered = pipe.extract_trajectories_both()
    assert set(pipe.timings) == {"encode", "adjacent_flows", "direct_sweep_and_chaining",
                                 "harvest"}

    frames = jvideo_io.load_video(pipe.paths["video_folder"], resize=(h, w))
    eng = jflow.RaftFlowEngine(params, frames, num_iters=3)
    fwd, bwd = eng.adjacent_flows()
    want_f, want_u = jtraj.extract_trajectories_dual(
        fwd, bwd, threshold=3.0, min_trajectory_length=2, direct_flow_threshold=0.3,
        direct_flow_fn=lambda s: eng.direct_flows(s, 3.0))
    on_disk = video_io.load_npz(pipe.paths["trajectories_file"])["trajectories"]
    np.testing.assert_array_equal(on_disk, trajs)
    for got, want in ((trajs, want_f), (unfiltered, want_u)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(want_f) != len(want_u) and len(want_u)

    # the single pass (run() with the filter off) is each pass of the sweep
    for use_direct, want in ((False, unfiltered), (True, trajs)):
        out = str(tmp_path / f"single_{use_direct}.npz")
        single = pipe.extract_trajectories(use_direct, out)
        np.testing.assert_array_equal(single, want)
        np.testing.assert_array_equal(video_io.load_npz(out)["trajectories"], want)


def test_pipeline_needs_raft_weights(tmp_path):
    pipe = PreprocessingPipeline(str(tmp_path), PreprocessConfig(), device=CPU)
    with pytest.raises(ValueError, match="RAFT weights"):
        pipe.extract_trajectories_both()
