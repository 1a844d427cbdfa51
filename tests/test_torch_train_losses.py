"""The port's training losses held against the JAX package on the same
inputs: each loss's value and its gradient w.r.t. the refined frame stack.

Geometry of tests/test_reference_loss_golden.py: 70×98 video (a 9×13
feature grid), C=16. Inputs come from numpy seeds. The random parts of the
losses cannot share a stream across frameworks, so the frame pairs are
injected (``pair_sel``) and the subset sizes take every candidate ("full
take", the technique of test_reference_loss_golden.py:17-22): the chosen
set is then the same and only commutative sums change order. f32 with TF32
off: rtol 1e-4. bf16 compute rounds the correlation operands on both sides
(trap: in JAX the VJP of a bf16-operand einsum also rounds the operand
cotangent to bf16, the port's f32 product on bf16-rounded values rounds it
through its cast instead); values still agree to 1e-4, gradients within
2e-2 of the gradient's largest magnitude (measured: 1.2e-2, where a few
elements sum paths that cancel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tracker_tpu.models import tracker as jtracker
from dino_tracker_tpu.structures import BBData as JBBData
from dino_tracker_tpu.training import contrastive as jcl
from dino_tracker_tpu.training import cycle as jcycle
from dino_tracker_tpu.training import losses as jlosses
from dino_tracker_tpu_torch.structures import BBData
from dino_tracker_tpu_torch.training import contrastive, cycle, losses
from test_torch_model_slice import H, W, configs, torch_model
from test_torch_threads import one_thread  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

S, C = 4, 16          # frame-set size, feature width
HP, WP = 9, 13        # feature grid of 70×98
N_FEAT = HP * WP
BB_CAP = 24
CHANNELS = (3, 8, 8, 8, C)
RTOL = 1e-4
BF16_GRAD = 2e-2      # bf16 gradients: atol relative to the largest magnitude


def weights(seed, channels=CHANNELS):
    """(params, batch_stats) in the JAX package's layout, from numpy alone:
    torch-default conv bounds, a non-zero last DeltaDINO layer (so every
    layer gets gradient), non-trivial BN, and head taps shifted by 0.1 so
    each 3×3 kernel's sum (the normalized conv's divisor) stays far from 0.
    JAX's own init_tracker would compile a random kernel per shape, which
    costs seconds on the CPU."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout, shift=0.0):
        bound = 1.0 / np.sqrt(cin * k * k)
        return {"w": (rng.uniform(-bound, bound, (k, k, cin, cout)) + shift
                      ).astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    layers, stats = [], []
    for i in range(len(channels) - 1):
        cout = channels[i + 1]
        layers.append({"conv": conv(5, channels[i], cout),
                       "bn": {"scale": (0.5 + rng.random(cout)).astype(np.float32),
                              "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}})
        stats.append({"mean": (rng.standard_normal(cout) * 0.1).astype(np.float32),
                      "var": (rng.random(cout) + 0.5).astype(np.float32)})
    head = {"conv1": conv(3, 1, 16, 0.1), "conv2": conv(3, 16, 1, 0.1)}
    return ({"delta_dino": {"layers": layers}, "tracker_head": head},
            {"delta_dino": {"layers": stats}})


def jvg(fn, **kw):
    """jit(value_and_grad): JAX's eager op-by-op dispatch is far slower on
    the CPU than compiling the small program once."""
    return jax.jit(jax.value_and_grad(fn, **kw))


def as_np(x):
    return np.asarray(x, np.float32)


def close(ours, ref, rtol=RTOL, atol=1e-6):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(np.asarray(ours, np.float32), as_np(ref),
                               rtol=rtol, atol=atol)


def close_grad(ours, ref, compute_dtype="float32"):
    ref = as_np(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    if compute_dtype == "float32":
        close(ours, ref, rtol=RTOL, atol=RTOL * scale)
    else:
        close(ours, ref, rtol=0, atol=BF16_GRAD * scale)


def stack(seed=0, s=S):
    """A structured refined stack: per-position features shared over frames
    plus per-frame noise, so buddies and predictions are well defined."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((1, HP, WP, C)) * 2
    return (pos + rng.standard_normal((s, HP, WP, C))).astype(np.float32)


def fg_masks(seed=1, t=S):
    return ((np.random.default_rng(seed).random((t, H, W)) < 0.4)
            .astype(np.float32) * 255)


def with_grad(x):
    return torch.from_numpy(x).requires_grad_(True)


def port_value_and_grad(fn, x):
    xt = with_grad(x)
    out = fn(xt)
    out.backward()
    return out.detach(), xt.grad


def test_huber_matches_jax():
    rng = np.random.default_rng(0)
    pred = (rng.standard_normal((50, 2)) * 0.05).astype(np.float32)
    tgt = (rng.standard_normal((50, 2)) * 0.05).astype(np.float32)
    ref, gref = jvg(lambda p: jlosses.huber(p, tgt).sum())(pred)
    ours, g = port_value_and_grad(
        lambda p: losses.huber(p, torch.from_numpy(tgt)).sum(), pred)
    close(ours, ref)
    close(g, gref)


@pytest.mark.parametrize("name", ["emb_norm_regularization",
                                  "emb_angle_regularization"])
def test_regularizers_match_jax(name):
    refined, raw = stack(0), stack(1)
    jfn = getattr(jlosses, name)
    ref, gref = jvg(
        lambda e: jfn(e, raw, channels_last=True))(refined)
    ours, g = port_value_and_grad(
        lambda e: getattr(losses, name)(e, torch.from_numpy(raw)), refined)
    close(ours, ref)
    close_grad(g, gref)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_bb_pairs_contrastive_loss_matches_jax(compute_dtype):
    """Batched over two pairs (the port's pair axis) against the JAX
    function vmapped over them, both directions, value and gradient w.r.t.
    the buddy features."""
    rng = np.random.default_rng(2)
    sbb, tbb = (rng.standard_normal((2, 7, C)).astype(np.float32) for _ in "st")
    sf, tf = (rng.standard_normal((2, N_FEAT, C)).astype(np.float32) for _ in "st")
    jcd = jnp.dtype(compute_dtype)
    tcd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]

    def jfn(sbb_):
        out = jax.vmap(lambda a, b, c, d: jlosses.bb_pairs_contrastive_loss_nc(
            a, b, c.astype(jcd), d.astype(jcd), jnp.linalg.norm(c, axis=1),
            jnp.linalg.norm(d, axis=1), 0.1))(sbb_, tbb, sf, tf)
        return out[0].sum() + 2 * out[1].sum(), out

    (_, (ref_st, ref_ts)), gref = jvg(jfn, has_aux=True)(sbb)
    sbb_t = with_grad(sbb)
    sf_t, tf_t = torch.from_numpy(sf), torch.from_numpy(tf)
    st, ts = losses.bb_pairs_contrastive_loss_nc(
        sbb_t, torch.from_numpy(tbb), sf_t.to(tcd).float(), tf_t.to(tcd).float(),
        torch.linalg.vector_norm(sf_t, dim=2), torch.linalg.vector_norm(tf_t, dim=2),
        0.1, tcd)
    (st.sum() + 2 * ts.sum()).backward()
    close(st, ref_st)
    close(ts, ref_ts)
    close_grad(sbb_t.grad, gref, compute_dtype)


def test_mutual_nn_and_cosine_affinity_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((40, C)), rng.standard_normal((30, C))
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = jlosses.cosine_affinity(a, b)
    ours = losses.cosine_affinity(torch.from_numpy(a), torch.from_numpy(b))
    close(ours, ref)
    ref_bb, ref_idx = jlosses.mutual_nn(ref)
    is_bb, idx = losses.mutual_nn(torch.from_numpy(as_np(ref)))
    np.testing.assert_array_equal(is_bb.numpy(), np.asarray(ref_bb))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert is_bb.any()
    # batched: one mask per leading index
    is_bb2, _ = losses.mutual_nn(torch.stack([torch.from_numpy(as_np(ref))] * 2))
    np.testing.assert_array_equal(is_bb2[1].numpy(), np.asarray(ref_bb))


def test_fg_lookup_matches_jax():
    """align_corners=False, zero padding and the /size normalisation: points
    inside, on the border, on integer pixels and outside the frame."""
    rng = np.random.default_rng(4)
    masks = fg_masks(4, 3)
    coords = np.concatenate([
        rng.random((3, 40, 2)) * [W + 4, H + 4] - 2,
        np.broadcast_to(np.float32([[0, 0], [W - 1, H - 1], [W, H], [-0.5, 3],
                                    [17, 23], [W - 0.5, H - 0.5]]), (3, 6, 2))],
        axis=1).astype(np.float32)
    ours = losses.sample_fg_mask_at_points(torch.from_numpy(masks),
                                           torch.from_numpy(coords), W, H)
    for p in range(3):
        ref = jlosses.sample_fg_mask_at_points(jnp.asarray(masks[p]),
                                               jnp.asarray(coords[p]), W, H)
        np.testing.assert_array_equal(ours[p].numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", [5, 12, 30])
def test_masked_gumbel_topk_is_a_uniform_set(k):
    """The JAX contract (losses.py:29-56), shown by invariants: valid slots
    first, ascending, distinct, inside the mask, as many as min(k, count);
    invalid slots zero-filled; batched rows independent. A surplus of k over
    the axis gives invalid slots."""
    gen = torch.Generator().manual_seed(0)
    mask = torch.from_numpy(np.random.default_rng(5).random((3, 20)) < 0.5)
    mask[2] = False
    seen = torch.zeros(20)
    for _ in range(200):
        idx, valid = losses.masked_gumbel_topk(gen, mask, k)
        assert idx.shape == valid.shape == (3, k)
        for row in range(3):
            n = int(valid[row].sum())
            assert n == min(k, int(mask[row].sum()))
            assert valid[row, :n].all() and not valid[row, n:].any()
            sel = idx[row, :n]
            assert (sel[1:] > sel[:-1]).all() and mask[row, sel].all()
            assert (idx[row, n:] == 0).all()
        seen += torch.zeros(20).index_add_(0, idx[0, valid[0]],
                                           torch.ones(int(valid[0].sum())))
    if k < int(mask[0].sum()):  # a strict subset: every candidate gets drawn
        assert (seen[mask[0]] > 0).all()


def bb_data(seed=6, t=S):
    """Random padded buddies; JAX and port BBData of the same arrays."""
    rng = np.random.default_rng(seed)
    nvalid = rng.integers(5, BB_CAP, (t, t))
    arrays = dict(
        source_coords=(rng.random((t, t, BB_CAP, 2)) * [W - 1, H - 1]).astype(np.float32),
        target_coords=(rng.random((t, t, BB_CAP, 2)) * [W - 1, H - 1]).astype(np.float32),
        cos_sims=(0.2 + 0.8 * rng.random((t, t, BB_CAP))).astype(np.float32),
        r=rng.random((t, t, BB_CAP)).astype(np.float32),
        valid=np.arange(BB_CAP)[None, None] < nvalid[..., None])
    return (JBBData(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            BBData(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


PAIRS = (np.array([0, 2, 3, 1]), np.array([1, 0, 2, 3]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dino_bb_contrastive_loss_matches_jax(compute_dtype):
    jcfg, pcfg = configs(CHANNELS, compute_dtype)
    emb, fg = stack(7), fg_masks(7)
    jbb, bb = bb_data()
    frames = np.array([1, 0, 3, 2])
    kw = dict(n_pairs=4, points_per_pair=2 * BB_CAP, fg_points_ratio=0.5,
              temp=0.1, cl_div=700.0, sig_a=27.0, sig_b=-5.7, pair_sel=PAIRS)
    ref, gref = jvg(lambda e: jcl.dino_bb_contrastive_loss(
        jax.random.PRNGKey(0), e, jnp.asarray(frames), jbb, jnp.asarray(fg),
        jcfg, channels_last=True, **kw))(emb)
    ours, g = port_value_and_grad(lambda e: contrastive.dino_bb_contrastive_loss(
        torch.Generator().manual_seed(0), e, torch.from_numpy(frames), bb,
        torch.from_numpy(fg), pcfg, **kw), emb)
    close(ours, ref)
    close_grad(g, gref, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_refined_bb_contrastive_loss_matches_jax(compute_dtype):
    jcfg, pcfg = configs(CHANNELS, compute_dtype)
    emb, fg = stack(8), fg_masks(8)
    frames = np.array([2, 3, 0, 1])
    kw = dict(n_pairs=4, points_per_pair=2 * N_FEAT, fg_points_ratio=0.5,
              temp=0.1, cl_div=900.0, pair_sel=PAIRS)
    ref, gref = jvg(lambda e: jcl.refined_bb_contrastive_loss(
        jax.random.PRNGKey(0), e, jnp.asarray(frames), jnp.asarray(fg), jcfg,
        channels_last=True, **kw))(emb)
    ours, g = port_value_and_grad(lambda e: contrastive.refined_bb_contrastive_loss(
        torch.Generator().manual_seed(0), e, torch.from_numpy(frames),
        torch.from_numpy(fg), pcfg, **kw), emb)
    assert float(ours) > 0  # buddies were found
    close(ours, ref)
    close_grad(g, gref, compute_dtype)


def cycle_inputs(seed, n_pairs=3, k=8, all_invalid=False):
    rng = np.random.default_rng(seed)
    src_sel = rng.integers(0, S, n_pairs)
    tgt_sel = rng.integers(0, S, n_pairs)
    frames = np.array([3, 1, 0, 2])
    sp = np.concatenate([rng.random((n_pairs, k, 2)) * [W - 1, H - 1],
                         np.broadcast_to(frames[src_sel][:, None, None],
                                         (n_pairs, k, 1))], 2)
    tp = np.concatenate([rng.random((n_pairs, k, 2)) * [W - 1, H - 1],
                         np.broadcast_to(frames[tgt_sel][:, None, None],
                                         (n_pairs, k, 1))], 2)
    valid = rng.random(n_pairs * k) < 0.7
    if all_invalid:
        valid[:] = False
    arrays = (sp.reshape(-1, 3).astype(np.float32), tp.reshape(-1, 3).astype(np.float32),
              np.repeat(src_sel, k), np.repeat(tgt_sel, k),
              (rng.random(n_pairs * k) * 4).astype(np.float32), valid)
    return (frames, jcycle.CycleData(*map(jnp.asarray, arrays)),
            cycle.CycleData(*map(torch.from_numpy, arrays)))


@pytest.mark.parametrize("all_invalid", [False, True])
def test_cycle_consistency_loss_matches_jax(all_invalid):
    """Grouped re-prediction of both directions on an injected CycleData:
    value, gradient w.r.t. the stack and the head's gradients. With no valid
    point the loss is exactly zero (not resampled)."""
    jcfg, pcfg = configs(CHANNELS)
    params, stats = weights(9)
    emb = stack(9)
    frames, jdata, data = cycle_inputs(9, all_invalid=all_invalid)

    def jfn(e, p):
        return jcycle.cycle_consistency_loss(
            p, e, jnp.asarray(frames), jdata, jcfg, 0.8, group_size=8,
            channels_last=True)

    ref, (gref, gparams) = jvg(jfn, argnums=(0, 1))(emb, params)
    model = torch_model(params, stats, pcfg)
    ours, g = port_value_and_grad(lambda e: cycle.cycle_consistency_loss(
        model, e, data, pcfg, 0.8, group_size=8), emb)
    if all_invalid:
        assert float(ours) == 0.0 and float(ref) == 0.0
        assert not g.abs().any()
        return
    close(ours, ref)
    close_grad(g, gref)
    close_grad(model.tracker_head.conv1.weight.grad.permute(2, 3, 1, 0),
               gparams["tracker_head"]["conv1"]["w"])


def test_cycle_data_from_points_matches_jax():
    """The deterministic half of cycle-data generation on injected points,
    against the JAX composition of get_point_predictions_grouped
    (cycle.py:83-108): forward and backward predictions, distances, the
    threshold filter."""
    jcfg, pcfg = configs(CHANNELS)
    params, stats = weights(10)
    emb = stack(10)
    rng = np.random.default_rng(10)
    frames = np.array([0, 2, 1, 3])
    src_sel, tgt_sel = np.array([0, 3, 1]), np.array([2, 3, 0])
    coords = np.floor(rng.random((3, 8, 2)) * [W, H]).astype(np.float32)
    valid = rng.random((3, 8)) < 0.8

    scale = jnp.asarray([W - 1, H - 1], jnp.float32)

    def predict(points, s, t):
        out = jtracker.get_point_predictions_grouped(
            params, points, jnp.asarray(s), jnp.asarray(t), jnp.asarray(emb),
            jcfg, channels_last=True)
        return (out + 1.0) * 0.5 * scale

    def with_t(xy, sel):
        return jnp.concatenate([xy, jnp.broadcast_to(
            jnp.asarray(frames[sel], jnp.float32)[:, None, None], (3, 8, 1))], 2)

    @jax.jit
    def compose(coords):
        src_pts = with_t(coords, src_sel)
        tgt_pts = with_t(predict(src_pts, src_sel, tgt_sel), tgt_sel)
        bwd = predict(tgt_pts, tgt_sel, src_sel)
        return src_pts, tgt_pts, jnp.linalg.norm(coords - bwd, axis=2)

    src_pts, tgt_pts, dists = compose(jnp.asarray(coords))
    dists = np.asarray(dists).reshape(-1)
    thresh = float(np.median(dists))

    model = torch_model(params, stats, pcfg)
    out = cycle.cycle_data_from_points(
        model, torch.from_numpy(emb), torch.from_numpy(frames), pcfg,
        torch.from_numpy(src_sel), torch.from_numpy(tgt_sel),
        torch.from_numpy(coords), torch.from_numpy(valid), thresh)
    close(out.source_points, np.asarray(src_pts).reshape(-1, 3))
    close(out.target_points, np.asarray(tgt_pts).reshape(-1, 3), atol=1e-3)
    close(out.dists, dists, atol=1e-3)
    np.testing.assert_array_equal(out.source_frame_indices.numpy(),
                                  np.repeat(src_sel, 8))
    np.testing.assert_array_equal(out.target_frame_indices.numpy(),
                                  np.repeat(tgt_sel, 8))
    far = np.abs(dists - thresh) > 1e-2  # the filter itself, away from the edge
    np.testing.assert_array_equal(out.valid.numpy()[far],
                                  (valid.reshape(-1) & (dists <= thresh))[far])
