"""Edges the parity tests skip, port against the JAX package on the CPU.

Stage 5 (``preprocessing/best_buddies.py``): a one-frame video (no frame
pair; the port's sweep raised here before, the JAX stage returns an empty
BBData), a flow filter that leaves no buddy in any pair or in one pair, and
the ambiguity with no more tokens than its top-k and on one frame. The
refine cache (``models/tracker.py``) at T not a multiple of its 16-frame
chunk. The contrastive losses (``training/contrastive.py``) with fewer
foreground candidates than the foreground share asks for, and with none
selected at all. On a mesh (``parallel/mesh.py``): more ranks than refine
frames and than cycle points a pair, against one device. The loss terms and
helpers of ``training/losses.py``, function by function: the Huber loss at
its kink, infinities and NaN; the foreground lookup at and past the frame's
edges and at NaN coordinates; the regularisers at zero and tiny norms; the
mutual nearest neighbours with ties and NaN; the buddy InfoNCE and the
cosine affinity with zero rows, in f32 and bf16, at temperatures 0.5 and
0.01. Two deliberate differences: where a buddy feature is exactly zero, the
JAX gradient of its norm is NaN (even under a zero weight) and the port's 0;
the step never samples an exactly zero feature. And the TAP-Vid adapter
(``evaluation/tapvid.py``) asked for a video the benchmark does not hold
raises a ``KeyError`` naming it, where the JAX one fails with a
``TypeError`` on ``None``; for a video it holds both give the same points.

Tolerances are those of the files each function's parity test lives in:
buddies and validity equal, cos within 1e-5 of max|cos|, r within 1e-6;
refined features 1e-4; losses rtol 1e-4 and gradients 1e-4 of their max.
JAX is imported only inside functions: spawned ranks import this module.
"""

import numpy as np
import pytest
import torch

from dino_tracker_tpu_torch.config import TrackerConfig
from dino_tracker_tpu_torch.models import tracker
from dino_tracker_tpu_torch.parallel import mesh as mesh_lib
from dino_tracker_tpu_torch.preprocessing import best_buddies as bb_lib
from dino_tracker_tpu_torch.training import contrastive, cycle, losses
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 70, 98          # a 9×13 token grid
SMALL_H, SMALL_W = 42, 56  # a 5×7 one: n = 35 tokens


def stats(tel):
    return {k: v for k, v in tel.items() if k != "phases"}


@pytest.mark.parametrize("cap", [None, 200, 32])
def test_one_frame_sweep_is_empty_as_jax(cap):
    from test_torch_best_buddies import assert_bb_equal, run_both, scene
    ours, ref, tel, jtel = run_both(scene(1, 16, 9, 13, 0.3, seed=1), H, W, cap=cap)
    assert_bb_equal(ours, ref)
    assert not ours.valid.any() and stats(tel) == stats(jtel)


@pytest.mark.parametrize("cap", [None, 32])
def test_filter_leaving_no_buddy_matches_jax(cap):
    """Trajectories valid in every frame: the filter drops every buddy."""
    from test_torch_best_buddies import assert_bb_equal, run_both, scene, trajectories
    ours, ref, tel, jtel = run_both(
        scene(3, 16, 9, 13, 0.3, seed=2), H, W, cap=cap,
        unfiltered_trajectories=trajectories(50, 3, H, W, 3, nan_share=0.0))
    assert_bb_equal(ours, ref)
    assert not ours.valid.any() and stats(tel) == stats(jtel)


@pytest.mark.parametrize("cap", [None, 32])
def test_a_pair_without_buddies_matches_jax(cap):
    """Trajectories valid everywhere in frame 2: its pairs lose every buddy,
    the pair (0, 1) keeps some."""
    from test_torch_best_buddies import assert_bb_equal, run_both, scene, trajectories
    trajs = trajectories(50, 3, H, W, 5, nan_share=0.5)
    trajs[:, 2] = 1.0
    ours, ref, tel, jtel = run_both(scene(3, 16, 9, 13, 0.3, seed=4), H, W, cap=cap,
                                    unfiltered_trajectories=trajs)
    assert_bb_equal(ours, ref)
    assert not ours.valid[0, 2].any() and ours.valid[0, 1].any()
    assert stats(tel) == stats(jtel)


@pytest.mark.parametrize("topk", [400, 35, 34, 2, 1])
def test_ambiguity_with_no_more_tokens_than_topk_matches_jax(topk):
    import jax.numpy as jnp
    from dino_tracker_tpu.preprocessing import best_buddies as jbb
    from test_torch_best_buddies import R_TOL, port_bb, scene
    feats = scene(3, 16, 5, 7, 0.6, seed=13)
    jd = jbb.extract_best_buddies(jnp.asarray(feats), SMALL_H, SMALL_W, 7)
    ours = bb_lib.compute_bb_ambiguity(port_bb(jd), torch.from_numpy(feats), SMALL_H,
                                       SMALL_W, 7, topk=topk)
    ref = jbb.compute_bb_ambiguity(jd, jnp.asarray(feats), SMALL_H, SMALL_W, 7, topk=topk)
    assert np.abs(ours.r.numpy() - np.asarray(ref.r)).max() <= R_TOL


def test_one_frame_ambiguity_matches_jax():
    import jax.numpy as jnp
    from dino_tracker_tpu.preprocessing import best_buddies as jbb
    from test_torch_best_buddies import port_bb, scene
    feats = scene(1, 16, 9, 13, 0.6, seed=13)
    jd = jbb.extract_best_buddies(jnp.asarray(feats), H, W, 7)
    ours = bb_lib.compute_bb_ambiguity(port_bb(jd), torch.from_numpy(feats), H, W, 7)
    ref = jbb.compute_bb_ambiguity(jd, jnp.asarray(feats), H, W, 7)
    np.testing.assert_array_equal(ours.r.numpy(), np.asarray(ref.r))


@pytest.mark.parametrize("t", [1, 17, 33])
def test_refine_at_lengths_off_the_chunk_matches_jax(t):
    import jax.numpy as jnp
    from dino_tracker_tpu.models import tracker as jtracker
    from test_torch_model_slice import configs, jax_weights, torch_model
    jcfg, pcfg = configs()
    params, bn_stats = jax_weights(11)
    rng = np.random.default_rng(t)
    hp, wp = pcfg.feat_hw
    video = rng.random((t, 3, H, W), dtype=np.float32)
    dino = rng.standard_normal((t, pcfg.delta_channels[-1], hp, wp)).astype(np.float16)
    ref = np.asarray(jtracker.cache_refined_embeddings(
        params, bn_stats, jnp.asarray(video), jnp.asarray(dino), jcfg))
    ours = tracker.cache_refined_embeddings(
        torch_model(params, bn_stats, pcfg), torch.from_numpy(video),
        torch.from_numpy(dino), pcfg).numpy()
    assert ours.shape == (t, hp, wp, pcfg.delta_channels[-1])
    np.testing.assert_allclose(ours, ref.transpose(0, 2, 3, 1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fg_value,ratio", [(0.0, 0.5), (255.0, 0.5), (0.0, 1.0)])
@pytest.mark.parametrize("loss", ["dino_bb", "refined_bb"])
def test_contrastive_losses_with_few_foreground_candidates_match_jax(loss, fg_value, ratio):
    """No foreground candidate, or nothing but foreground: the draws take
    what there is (with ``ratio`` 1.0 and no foreground, nothing: the loss
    and its gradient are zero in both packages)."""
    import jax
    import jax.numpy as jnp
    from dino_tracker_tpu.training import contrastive as jcl
    import test_torch_train_losses as tl
    jcfg, pcfg = tl.configs(tl.CHANNELS)
    emb = tl.stack(7)
    fg = np.full((tl.S, H, W), fg_value, np.float32)
    frames = np.array([1, 0, 3, 2])
    if loss == "dino_bb":
        jbb, bb = tl.bb_data()
        kw = dict(n_pairs=4, points_per_pair=2 * tl.BB_CAP, fg_points_ratio=ratio,
                  temp=0.1, cl_div=700.0, sig_a=27.0, sig_b=-5.7, pair_sel=tl.PAIRS)
        jfn = lambda e: jcl.dino_bb_contrastive_loss(
            jax.random.PRNGKey(0), e, jnp.asarray(frames), jbb, jnp.asarray(fg), jcfg,
            channels_last=True, **kw)
        fn = lambda e: contrastive.dino_bb_contrastive_loss(
            torch.Generator().manual_seed(0), e, torch.from_numpy(frames), bb,
            torch.from_numpy(fg), pcfg, **kw)
    else:
        kw = dict(n_pairs=4, points_per_pair=2 * tl.N_FEAT, fg_points_ratio=ratio,
                  temp=0.1, cl_div=900.0, pair_sel=tl.PAIRS)
        jfn = lambda e: jcl.refined_bb_contrastive_loss(
            jax.random.PRNGKey(0), e, jnp.asarray(frames), jnp.asarray(fg), jcfg,
            channels_last=True, **kw)
        fn = lambda e: contrastive.refined_bb_contrastive_loss(
            torch.Generator().manual_seed(0), e, torch.from_numpy(frames),
            torch.from_numpy(fg), pcfg, **kw)
    ref, gref = tl.jvg(jfn)(emb)
    ours, g = tl.port_value_and_grad(fn, emb)
    tl.close(ours, ref)
    if ratio == 1.0 and fg_value == 0.0:
        assert float(ours) == float(ref) == 0.0
        assert not g.any() and not np.asarray(gref).any()
    else:
        assert float(ours) > 0
        tl.close_grad(g, gref)


# --- more ranks than rows ---

MESH_CFG = TrackerConfig(video_h=H, video_w=W, delta_channels=(3, 4, 4, 4, 16),
                         compute_dtype="float32")


def refine_and_cycle(mesh, state, video, dino, emb, cycle_arrays):
    """The refine cache of a 2-frame video, and the cycle loss of 3 pairs of
    2 points (this rank's share) with its gradient, on one rank or device."""
    torch.backends.cudnn.allow_tf32 = False
    model = tracker.Tracker(MESH_CFG)
    model.load_state_dict(state)
    model.eval()
    refined = tracker.cache_refined_embeddings(model, video, dino, MESH_CFG, mesh=mesh)
    e = emb.clone().requires_grad_(True)
    loss = cycle.cycle_consistency_loss(model, e, cycle.CycleData(*cycle_arrays), MESH_CFG,
                                        0.8, group_size=2, mesh=mesh)
    loss.backward()
    return {"refine": refined, "loss": loss.detach(), "grad": e.grad}


def test_more_ranks_than_frames_and_points_match_one_device():
    """Three gloo ranks: one has no refine frame and no cycle point of any
    pair. The refine equals one device's; the ranks' losses and gradients
    add up to one device's."""
    torch.manual_seed(0)
    model = tracker.Tracker(MESH_CFG)
    with torch.no_grad():
        for p in model.parameters():  # a non-zero residual and head
            p.add_(0.05 * torch.randn_like(p))
    state = model.state_dict()
    rng = np.random.default_rng(0)
    hp, wp = MESH_CFG.feat_hw
    video = torch.from_numpy(rng.random((2, 3, H, W), dtype=np.float32))
    dino = torch.from_numpy(rng.standard_normal((2, 16, hp, wp)).astype(np.float16))
    emb = torch.from_numpy(rng.standard_normal((4, hp, wp, 16)).astype(np.float32))
    k, g = 2, 3
    xy = lambda: rng.random((g, k, 2)) * [W - 1, H - 1]
    points = lambda frame: torch.tensor(np.concatenate(
        [xy(), np.full((g, k, 1), frame)], 2).reshape(-1, 3), dtype=torch.float32)
    arrays = (points(0), points(1), torch.tensor(np.repeat([0, 1, 2], k)),
              torch.tensor(np.repeat([1, 2, 3], k)),
              torch.tensor(rng.random(g * k) * 3, dtype=torch.float32),
              torch.ones(g * k, dtype=torch.bool))
    one = refine_and_cycle(None, state, video, dino, emb, arrays)
    ranks = mesh_lib.spawn(refine_and_cycle, 3, "cpu",
                           args=(state, video, dino, emb, arrays), timeout=300)
    for r in ranks:
        assert torch.equal(r["refine"], one["refine"])
    loss = sum(r["loss"] for r in ranks)
    grad = sum(r["grad"] for r in ranks)
    torch.testing.assert_close(loss, one["loss"], rtol=1e-4, atol=1e-7)
    scale = float(one["grad"].abs().max())
    assert scale > 0
    torch.testing.assert_close(grad, one["grad"], rtol=1e-4, atol=1e-4 * scale)


# --- training/losses.py at its edges ---

def test_huber_at_its_kink_and_beyond_matches_jax():
    from dino_tracker_tpu.training import losses as jlosses
    d = np.float32(1 / 32)
    x = np.array([0, d, -d, np.nextafter(d, np.float32(1)), np.nextafter(d, np.float32(0)),
                  2 * d, -1e3, np.inf, -np.inf, np.nan], np.float32)
    ours = losses.huber(torch.from_numpy(x), torch.tensor(0.0)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jlosses.huber(x, np.float32(0))))


def test_fg_lookup_at_and_past_the_frame_edges_matches_jax():
    """Pixel coordinates at -1, -0.5, -0.25, 0, 0.5, the last pixel, half a
    pixel and more past it, and NaN, on a mask that is foreground
    everywhere and on one that is foreground only on its border."""
    import jax.numpy as jnp
    from dino_tracker_tpu.training import losses as jlosses
    h, w = 6, 9
    full = np.full((h, w), 255.0, np.float32)
    border = full.copy()
    border[1:-1, 1:-1] = 0
    xs = [-1, -0.5, -0.25, 0, 0.5, w - 1, w - 0.5, w - 0.25, w, w + 1, np.nan]
    ys = [-1, -0.5, 0, 2.5, h - 1, h - 0.5, h, np.nan]
    pts = np.array([(x, y) for x in xs for y in ys], np.float32)
    for mask in (full, border):
        ours = losses.sample_fg_mask_at_points(torch.from_numpy(mask)[None],
                                               torch.from_numpy(pts)[None], w, h)[0]
        ref = jlosses.sample_fg_mask_at_points(jnp.asarray(mask), jnp.asarray(pts), w, h)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert ours.any() and not ours.all()


@pytest.mark.parametrize("raw_scale,refined_scale", [(0.0, 1.0), (1.0, 0.0), (0.0, 0.0),
                                                     (1e-25, 1.0), (1e20, 1.0)])
def test_regularisers_at_zero_and_extreme_norms_match_jax(raw_scale, refined_scale):
    """One position of each stack scaled: zero and underflowing norms give
    inf or NaN in both packages alike."""
    import jax.numpy as jnp
    from dino_tracker_tpu.training import losses as jlosses
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    refined = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    raw[0, 1, 2] *= raw_scale
    refined[0, 1, 2] *= refined_scale
    for name in ("emb_norm_regularization", "emb_angle_regularization"):
        ours = float(getattr(losses, name)(torch.from_numpy(refined), torch.from_numpy(raw)))
        ref = float(getattr(jlosses, name)(jnp.asarray(refined), jnp.asarray(raw),
                                           channels_last=True))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("shape", [(4, 3), (1, 5), (5, 1), (3, 3)])
def test_mutual_nn_with_ties_and_nan_matches_jax(shape):
    """Rows and columns with tied maxima (both take the first) and a NaN
    (both take it as the maximum)."""
    import jax.numpy as jnp
    from dino_tracker_tpu.training import losses as jlosses
    rng = np.random.default_rng(sum(shape))
    aff = rng.integers(0, 3, shape).astype(np.float32)
    aff.flat[len(aff.flat) // 2] = np.nan
    ours = losses.mutual_nn(torch.from_numpy(aff))
    ref = jlosses.mutual_nn(jnp.asarray(aff))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("temp", [0.5, 0.01])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_buddy_infonce_and_affinity_with_zero_rows_match_jax(dtype, temp):
    """Zero buddy features and a zero frame position (the EPS clamps),
    frame slabs rounded to the compute dtype (the JAX slab in that dtype),
    at a temperature that makes the logits large: values within 1e-6 of
    their largest magnitude, gradients of the non-zero buddy rows within
    1e-5; at the zero buddy row the JAX gradient is NaN and the port's 0."""
    import jax
    import jax.numpy as jnp
    from dino_tracker_tpu.training import losses as jlosses
    rng = np.random.default_rng(5)
    sb, tb = (rng.standard_normal((5, 16)).astype(np.float32) for _ in range(2))
    sf, tf = (rng.standard_normal((7, 16)).astype(np.float32) for _ in range(2))
    sb[0], tb[1], sf[2] = 0, 0, 0
    weight = np.array([0, 0, 1, 1, 1], np.float32)  # the zero rows weigh nothing
    tdt = getattr(torch, dtype)
    norms = [np.linalg.norm(f, axis=1).astype(np.float32) for f in (sf, tf)]

    def jloss(s):
        a, b = jlosses.bb_pairs_contrastive_loss_nc(
            s, jnp.asarray(tb), jnp.asarray(sf).astype(dtype), jnp.asarray(tf).astype(dtype),
            *map(jnp.asarray, norms), temp)
        return jnp.sum((a + b) * weight), (a, b)

    (_, ref), gref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(sb))
    s = torch.from_numpy(sb).requires_grad_()
    ours = losses.bb_pairs_contrastive_loss_nc(
        s, torch.from_numpy(tb), torch.from_numpy(sf).to(tdt).float(),
        torch.from_numpy(tf).to(tdt).float(), *map(torch.from_numpy, norms), temp, tdt)
    ((ours[0] + ours[1]) * torch.from_numpy(weight)).sum().backward()
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0, atol=1e-6 * np.abs(r).max())
    gref = np.asarray(gref)
    assert np.isnan(gref[0]).all() and not s.grad[0].any()
    np.testing.assert_allclose(s.grad[1:].numpy(), gref[1:], rtol=0,
                               atol=1e-5 * np.abs(gref[1:]).max())
    aff = losses.cosine_affinity(torch.from_numpy(sf), torch.from_numpy(tf), tdt).numpy()
    jaff = np.asarray(jlosses.cosine_affinity(jnp.asarray(sf), jnp.asarray(tf),
                                              getattr(jnp, dtype)))
    np.testing.assert_allclose(aff, jaff, rtol=0, atol=1e-6)
    assert not aff[2].any()


def test_tapvid_unknown_video_raises_key_error_where_jax_raises_type_error():
    """The benchmark's query points of a video it holds, rescaled, equal the
    JAX adapter's; for a video it does not hold the port raises a KeyError
    naming it, the JAX adapter a TypeError (it subscripts the None its
    lookup returns)."""
    from dino_tracker_tpu.evaluation import tapvid as jtapvid
    from dino_tracker_tpu_torch.evaluation import tapvid
    bench = {"videos": [{"video_idx": 3, "h": 480, "w": 640,
                         "query_points": {0: [(10.0, 20.0)], 5: [(1.5, 2.5), (600.0, 470.0)]},
                         "target_points": {}, "occluded": {}}]}
    for sizes in (None, (854, 476)):
        assert (tapvid.get_query_points_from_benchmark_config(bench, 3, sizes)
                == jtapvid.get_query_points_from_benchmark_config(bench, 3, sizes))
    with pytest.raises(KeyError, match="video 7 is not in the benchmark"):
        tapvid.get_query_points_from_benchmark_config(bench, 7)
    with pytest.raises(TypeError):
        jtapvid.get_query_points_from_benchmark_config(bench, 7, (854, 476))
    with pytest.raises(TypeError):
        jtapvid.get_query_points_from_benchmark_config(bench, 7)

